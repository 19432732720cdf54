"""Serving path of the port: ``kv_cache`` (paged ring cache, raw or
int8-block pages, and the eager prefill/decode_k/chunk dispatches),
``sampling`` (the on-device token sampler), ``engine`` (the
single-threaded scheduler with handoffs, sessions and weight swaps),
``frontend`` (the thread-safe client face), ``speculative`` (the
draft-propose/target-verify engine), ``reports`` (telemetry) and
``weights`` (the warm-restart weight plane)."""

from chainermn_torch.serving.engine import (Engine, EngineConfig, Request,
                                            WeightsVersionSkew,
                                            default_buckets)
from chainermn_torch.serving.frontend import (AdmissionRejected,
                                              DeadlineExceeded, Frontend)
from chainermn_torch.serving.kv_cache import (ServingStep, cache_bytes,
                                              cache_spec, decode_apply,
                                              decode_k_apply, init_cache,
                                              prefill_apply,
                                              prefill_chunk_apply)
from chainermn_torch.serving.reports import ServingReport
from chainermn_torch.serving.sampling import (draft_shadow_keys, init_keys,
                                              request_key, sample_tokens,
                                              split_keys)
from chainermn_torch.serving.speculative import DraftStep, SpeculativeEngine
from chainermn_torch.serving.weights import (WeightsError, load_weights,
                                             publish_weights, pull_weights,
                                             weight_candidates)

__all__ = [
    "Engine", "EngineConfig", "Request", "WeightsVersionSkew",
    "default_buckets",
    "Frontend", "DeadlineExceeded", "AdmissionRejected",
    "ServingStep", "cache_bytes", "cache_spec", "decode_apply",
    "decode_k_apply", "init_cache", "prefill_apply",
    "prefill_chunk_apply",
    "ServingReport",
    "DraftStep", "SpeculativeEngine",
    "draft_shadow_keys", "init_keys", "request_key", "sample_tokens",
    "split_keys",
    "WeightsError", "load_weights", "publish_weights", "pull_weights",
    "weight_candidates",
]
