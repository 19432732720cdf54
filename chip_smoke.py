#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``chainermn_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printed on its own line; any failure exits non-zero before
the final line:

1. card — ``nvidia-smi`` name and power limit;
2. build — every CUDA kernel of the port from ``chainermn_torch/csrc``,
   one ``nvcc`` per source, all started together;
3. kernels — each kernel against its plain PyTorch version on the card
   at the main path's shape and in the edge cases, then timed beside the
   plain version and the one PyTorch call that computes the same
   function (a yardstick only; the port never calls it);
4. slice — the port's ``Engine`` serves 16 greedy requests with the
   135M TransformerLM at full width (vocab 32768, d_model 768, 12
   layers, 12 heads, d_ff 3072, rope, bf16) and random weights from
   ``--seed``; launch counts are zeroed just before and read just after,
   and two streams are checked against an f32 full forward with plain
   attention on the card;
5. a ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

It needs one CUDA device and exits non-zero without one, or when run
from a directory that does not hold the ``chainermn_torch`` package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over HBM bandwidth and its operations
# over the peak rate of their type
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

# stated tolerances: f32 kernels vs plain version, bf16 out and lse
TOL_F32 = 1e-4
TOL_BF16_OUT = 2e-2
TOL_BF16_LSE = 2e-3
# served greedy token vs the f32 plain-attention full forward: the
# token's logit must be within this of its row's max (bf16 drift over 12
# layers; the logits' spread is about 0.6)
TOL_LOGIT_GAP = 0.15


class PhaseError(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound_ms(b, lq, lk, hq, hkv, d, dtype, causal):
    """Least time for the attention forward on these inputs, and what
    bounds it: every visible (row, col) pair costs two length-D products
    (QK and PV, 2 ops per MAC); bytes are q, k, v and out once each plus
    the f32 lse."""
    if causal:
        pairs = sum(min(i + 1, lk) for i in range(lq))
    else:
        pairs = lq * lk
    ops = 4 * d * pairs * b * hq
    item = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * lq * hq * d + 2 * b * lk * hkv * d) * item \
        + 4 * b * hq * lq
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_kernels(gen):
    """Kernel vs plain version in every listed case; returns the max
    errors at the prefill shape."""
    import torch

    from chainermn_torch.ops.flash_attention import (
        flash_attention_cuda, flash_attention_reference)

    def rand(*shape, dtype):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    cases = [
        # name, b, lq, lk, hq, hkv, d, dtype, causal, window, segments
        ("prefill", 2, 2048, 2048, 12, 12, 64, torch.bfloat16, True, None,
         False),
        ("gqa", 2, 512, 512, 12, 4, 64, torch.bfloat16, True, None, False),
        ("window", 1, 1024, 1024, 12, 12, 64, torch.bfloat16, True, 256,
         False),
        ("segments", 2, 300, 300, 4, 2, 64, torch.bfloat16, True, None,
         True),
        ("ragged", 1, 1000, 1000, 12, 12, 64, torch.bfloat16, True, None,
         False),
        ("f32", 2, 512, 512, 12, 12, 64, torch.float32, True, None, False),
        ("f32-noncausal-d40", 1, 200, 333, 4, 1, 40, torch.float32, False,
         None, False),
    ]
    worst = {}
    for (name, b, lq, lk, hq, hkv, d, dtype, causal, window,
         segs) in cases:
        q = rand(b, lq, hq, d, dtype=dtype)
        k = rand(b, lk, hkv, d, dtype=dtype)
        v = rand(b, lk, hkv, d, dtype=dtype)
        seg = None
        if segs:
            qs = torch.zeros(b, lq, dtype=torch.int32, device="cuda")
            qs[:, lq // 2:] = 1
            qs[0, 7] = -1                     # a row that matches no key
            ks = torch.zeros(b, lk, dtype=torch.int32, device="cuda")
            ks[:, lk // 2:] = 1
            seg = (qs, ks)
        out, lse = flash_attention_cuda(q, k, v, causal, None, seg, window)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_reference(q, k, v, causal, None,
                                                     seg, window)
        if dtype == torch.float32:
            o_tol, l_tol, rtol = TOL_F32, TOL_F32, TOL_F32
        else:
            o_tol, l_tol, rtol = TOL_BF16_OUT, TOL_BF16_LSE, TOL_BF16_OUT
        err_o = (out.float() - ref_out.float()).abs()
        ok_o = bool((err_o <= o_tol + rtol * ref_out.float().abs()).all())
        err_l = (lse - ref_lse).abs()
        ok_l = bool((err_l <= l_tol + (rtol if dtype == torch.float32
                                       else 0.0) * ref_lse.abs()).all())
        if segs:
            ok_o = ok_o and bool((out[0, 7] == 0).all())
        print(f"kernel flash_fwd case={name} shape=[{b},{lq}|{lk},{hq}|"
              f"{hkv},{d}] {str(dtype)[6:]} out_err={err_o.max().item():.3g}"
              f" lse_err={err_l.max().item():.3g} "
              f"{'ok' if ok_o and ok_l else 'FAIL'}", flush=True)
        if not (ok_o and ok_l):
            raise PhaseError(f"flash_fwd disagrees with its plain version "
                             f"in case {name}")
        worst[name] = err_o.max().item()
    return worst


def time_flash(gen):
    import torch
    import torch.nn.functional as F

    from chainermn_torch.ops.flash_attention import (
        flash_attention_cuda, flash_attention_reference)

    b, l, h, d = 2, 2048, 12, 64
    q, k, v = (torch.randn(b, l, h, d, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    ms = cuda_time_ms(lambda: flash_attention_cuda(q, k, v, True))
    plain_ms = cuda_time_ms(
        lambda: flash_attention_reference(q, k, v, True), iters=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    bound, bound_by = flash_bound_ms(b, l, l, h, h, d, "bfloat16", True)
    return ms, plain_ms, lib_ms, bound, bound_by


def build_model(seed: int, dtype, attention: str):
    import torch

    from chainermn_torch.models.transformer import TransformerLM

    torch.manual_seed(seed)
    return TransformerLM(vocab=32768, d_model=768, n_heads=12, n_layers=12,
                         d_ff=3072, max_len=2048, pos_emb="rope",
                         attention=attention, dtype=dtype, device="cuda")


def engine_config():
    from chainermn_torch.serving.engine import EngineConfig

    return EngineConfig(n_slots=8, capacity=2048,
                        buckets=(128, 256, 512, 1024, 2048),
                        prefill_cohort=2, decode_k=4, max_new_tokens=32)


def prompts_for(seed: int, vocab: int):
    """16 prompts with seeded lengths in [64, 2000]."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lengths = rng.randint(64, 2001, size=16)
    return [rng.randint(0, vocab, size=n).astype(np.int32) for n in lengths]


def warm_up(model):
    """Two requests per prefill bucket, so first-call costs (cuBLAS
    handles and heuristics per shape, allocator growth) stay out of the
    measured runs."""
    import numpy as np

    from chainermn_torch.serving.engine import Engine

    cfg = engine_config()
    warm = Engine(model, cfg)
    rng = np.random.RandomState(12345)
    for bucket in cfg.buckets:
        for _ in range(2):
            warm.submit(rng.randint(0, model.vocab, size=bucket - 7),
                        max_new_tokens=5)
    warm.run_until_drained()


def serve(model, prompts):
    """The port's main path: one Engine serves every prompt. Launch
    counts are zeroed just before and read just after."""
    import torch

    from chainermn_torch.ops import _cuda
    from chainermn_torch.serving.engine import Engine

    torch.cuda.synchronize()
    eng = Engine(model, engine_config())
    _cuda.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p) for p in prompts]
    steps = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, reqs, steps, wall, _cuda.launches()


def profile_serving(model, prompts, out_dir: str, card: str) -> None:
    """One more served run of the same prompts under torch.profiler:
    host time per dispatch kind (each dispatch synchronised at its end,
    where the engine pulls its token ids anyway), the device's busy share
    and the kernels that take the device time. Writes
    ``serve_trace.json`` and ``serve_kernels.txt`` into ``out_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chainermn_torch.serving import kv_cache

    spent = {}
    originals = {}

    def timed(name):
        fn = originals[name] = getattr(kv_cache.ServingStep, name)

        def wrapper(self, *a, **kw):
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            torch.cuda.synchronize()
            n, total = spent.get(name, (0, 0.0))
            spent[name] = (n + 1, total + time.perf_counter() - t0)
            return out
        setattr(kv_cache.ServingStep, name, wrapper)

    for name in ("prefill_sampled", "decode_k"):
        timed(name)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, _, wall, _ = serve(model, prompts)
    finally:
        for name, fn in originals.items():
            setattr(kv_cache.ServingStep, name, fn)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "serve_trace.json"))
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    lines = [f"{e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x  "
             f"{e.key[:110]}" for e in kernels]
    with open(os.path.join(out_dir, "serve_kernels.txt"), "w") as fh:
        fh.write(f"# {card}; profiled wall {wall:.4f} s; device busy "
                 f"{busy_us / 1e3:.3f} ms\n" + "\n".join(lines) + "\n")
    print(f"profile: wall {wall:.4f} s (profiler on), device busy "
          f"{busy_us / 1e3:.3f} ms = {busy_us / 1e6 / wall:.4f} of wall; "
          + ", ".join(f"{k} {n}x {t * 1e3:.2f} ms"
                      for k, (n, t) in spent.items())
          + f" ({card})", flush=True)
    for line in lines[:12]:
        print(f"profile kernel: {line}", flush=True)


def check_streams(model, reqs, prompts, seed: int) -> float:
    """Every request emitted 32 in-range tokens; two of them agree with
    an f32 full forward using plain attention."""
    import torch

    for r in reqs:
        if r.state != "done" or len(r.tokens) != 32:
            raise PhaseError(f"request {r.request_id} ended {r.state} with "
                             f"{len(r.tokens)} tokens")
        if not all(0 <= t < model.vocab for t in r.tokens):
            raise PhaseError(f"request {r.request_id} emitted an "
                             "out-of-range token")
    ref = build_model(seed, torch.float32, "reference")
    ref.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    worst = 0.0
    with torch.no_grad():
        for i in (0, len(reqs) - 1):
            p, toks = prompts[i], reqs[i].tokens
            seq = torch.tensor(list(p) + toks[:-1], device="cuda")[None]
            logits = ref(seq)[0, len(p) - 1:]             # [32, vocab]
            picked = logits.gather(1, torch.tensor(toks, device="cuda")
                                   [:, None])[:, 0]
            gap = (logits.max(-1).values - picked).max().item()
            worst = max(worst, gap)
            if not torch.isfinite(logits).all() or gap > TOL_LOGIT_GAP:
                raise PhaseError(
                    f"request {i}: served token's logit is {gap:.4f} below "
                    f"its row max in the f32 forward (tolerance "
                    f"{TOL_LOGIT_GAP})")
    del ref
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one more served run into DIR "
                         "(chrome trace and kernel table)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "chainermn_torch")):
        print("chip_smoke: chainermn_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chainermn_torch.ops import _cuda

    # f32 products in full f32 (the reference forward's precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    took = _cuda.build_all()
    print(f"build: {json.dumps(took)} total "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    worst = check_kernels(gen)
    ms, plain_ms, lib_ms, bound, bound_by = time_flash(gen)
    print(f"time flash_fwd [2,2048,12,64] bf16 causal: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
          f"{bound:.4f} ms, bound by {bound_by} ({card})", flush=True)

    model = build_model(args.seed, torch.bfloat16, "flash")
    prompts = prompts_for(args.seed, model.vocab)
    warm_up(model)
    eng, reqs, steps, wall, counts = serve(model, prompts)
    if counts["flash_fwd"] < 1:
        raise PhaseError("the served prefill never launched flash_fwd")
    gap = check_streams(model, reqs, prompts, args.seed)
    summ = eng.report.summary()
    decode_tokens = summ["tokens_emitted"] - len(reqs)
    print(f"slice: {len(reqs)} requests, {summ['tokens_emitted']} tokens, "
          f"{steps} steps, wall {wall:.3f} s (report {summ['wall_s']:.3f} "
          f"s), ttft p50 "
          f"{summ['ttft_ms']['p50']:.2f} ms, itl p50 "
          f"{summ['itl_ms']['p50']:.2f} ms, decode tokens/s "
          f"{decode_tokens / summ['wall_s']:.1f}, launches {counts}, "
          f"worst logit gap {gap:.4f}, kv cache "
          f"{eng.steps.cache_bytes() / 1e6:.1f} MB ({card})", flush=True)
    del eng
    if args.profile:
        profile_serving(model, prompts, args.profile, card)

    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "chainermn_torch/csrc/flash_fwd.cu",
        "replaces": "chainermn_tpu/ops/flash_attention.py:168",
        "launches": counts["flash_fwd"],
        "max_abs_err": worst["prefill"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": lib_ms}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
