"""Serving path of the port: paged KV cache, sampling, engine, report."""

from chainermn_torch.serving.engine import Engine, EngineConfig, Request
from chainermn_torch.serving.kv_cache import ServingStep
from chainermn_torch.serving.reports import ServingReport

__all__ = ["Engine", "EngineConfig", "Request", "ServingStep",
           "ServingReport"]
