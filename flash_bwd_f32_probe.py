#!/usr/bin/env python3
"""Where the time of the port's f32 flash-attention backward goes
(``flash_bwd_fma`` in ``chainermn_torch/csrc/flash_bwd.cu``), on one GPU:

    python3 flash_bwd_f32_probe.py [--shape B L H D]

1. Shared-memory reads: a small kernel times one 16-byte ``LDS`` per warp
   in the access patterns the body's products use (every lane on one
   address; each quarter-warp on one address, the four in four bank quads;
   each quarter on the same 8 quads; 32 distinct quads; each quarter on one
   address, all four in one bank quad) and prints the SM's cycles per
   warp-read, 8 warps an SM.
2. Copies of ``flash_bwd.cu`` built under ``build/``, each with one edit:
   ``keys64`` (64-key CTAs at d 64 in place of 128), ``no-sdp`` (S and dP
   not computed), ``no-dvdk`` (dV += P^T dO and dK += dS^T Q skipped),
   ``no-dq`` (dQ = dS K and its atomics skipped), ``no-atomics`` (dQ
   computed, its atomics skipped). Only ``keys64`` computes the right
   gradients; the others are read for their times alone.
3. The kernel's launch at [B, L, H, H, D] f32 causal (default [4, 2048,
   12, 64], ``train_lm``'s attention), timed as ``chip_smoke.py`` times
   kernels, in the order shipped, each copy, each copy again in reverse,
   shipped; ``keys64`` is first held against the shipped build. Prints the
   card's name and power limit and ptxas's registers of each build.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

#: the shared-memory read patterns: name and each lane's float4 index
LDS_PATTERNS = (
    ("warp on one address", "0"),
    ("each quarter on one address, four quads", "(lane >> 3) * 17"),
    ("each quarter on the same 8 quads", "(lane & 7) * 17"),
    ("32 distinct quads", "lane"),
    ("each quarter on one address, one quad", "(lane >> 3) * 16"),
)

LDS_SOURCE = r"""
#include <cuda_runtime.h>
template <int MODE>
__global__ void __launch_bounds__(256, 1) lds_probe(float* out,
                                                    long long* cycles,
                                                    int iters) {
  __shared__ float4 buf[2048];
  for (int i = threadIdx.x; i < 2048; i += 256)
    buf[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int idx = 0;
%(cases)s
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    const int base = (it * 8) & 1023;  // whole bank rows: the pattern stays
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const float4 v = buf[(idx + base + u * 128) & 2047];
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
  out[blockIdx.x * 256 + threadIdx.x] = acc.x + acc.y + acc.z + acc.w;
}
extern "C" int lds_probe_run(int mode, float* out, long long* cycles,
                             int iters, int blocks) {
  switch (mode) {
%(launches)s
  }
  return static_cast<int>(cudaDeviceSynchronize());
}
"""

#: each copy of flash_bwd.cu: its edits (old text, new text)
_S_DP = ("    row_dots<DP, TM, LD, SWZ>(s, tQ, sK, r1, c1);\n"
         "    row_dots<DP, TM, LD, SWZ>(dp, tO, sV, r1, c1);\n")
_DVDK = "#pragma unroll 2\n    for (int q = 0; q < FQ; q += 4) {\n"
_DQ = "#pragma unroll 4\n    for (int kk = kq; kk < kq + KT / 2; ++kk) {\n"
_ATOMIC = "if (col < p.D) st_vec<VEC, true>(dqrow + col, dq[i] + oq * VEC);"
_NEVER = "    if (dk[0][0] == 1234.5f)\n"  # a test the compiler cannot drop
COPIES = {
    "keys64": (("static constexpr int KT = DP <= 64 ? 128 : 64;",
                "static constexpr int KT = 64;"),),
    "no-sdp": ((_S_DP, "#pragma unroll\n    for (int i = 0; i < TM; ++i)\n"
                       "#pragma unroll\n      for (int j = 0; j < 4; ++j)\n"
                       "        s[i][j] = dp[i][j] = tQ[r1 + 4 * i + j];\n"),),
    "no-dvdk": ((_DVDK, _NEVER + _DVDK),),
    "no-dq": ((_DQ, _NEVER + _DQ),),
    "no-atomics": ((_ATOMIC, _ATOMIC.replace(
        "col < p.D", "col < p.D && dq[i][0] == 1234.5f")),),
}


def build_probe_kernels() -> ctypes.CDLL:
    """Compile the shared-memory read probe and every copy of flash_bwd.cu
    (one nvcc each, started together); register the copies as builds of
    ``flash_bwd`` that ``_cuda.variant`` selects by the copy's name, and
    return the read probe's library."""
    from chainermn_torch.ops import _cuda

    out = _cuda._BUILD / "flash_bwd_f32_probe"
    out.mkdir(parents=True, exist_ok=True)
    cases = "\n".join(f"  if (MODE == {i}) idx = {expr};"
                      for i, (_, expr) in enumerate(LDS_PATTERNS))
    launches = "\n".join(
        f"    case {i}: lds_probe<{i}><<<blocks, 256>>>(out, cycles, iters); "
        "break;" for i in range(len(LDS_PATTERNS)))
    (out / "lds_probe.cu").write_text(
        LDS_SOURCE % {"cases": cases, "launches": launches})
    jobs = {"lds_probe": (out / "lds_probe.cu", out / "liblds_probe.so")}
    src = (_cuda._CSRC / "flash_bwd.cu").read_text()
    for name, edits in COPIES.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"flash_bwd.cu no longer has one {old!r}")
            text = text.replace(old, new)
        cu = out / f"flash_bwd_{name}.cu"
        cu.write_text(text)
        jobs[name] = (cu, out / f"libflash_bwd_{name}.so")
    procs = {name: subprocess.Popen(
        [_cuda._nvcc(), *_cuda._NVCC_FLAGS, "-I", str(_cuda._CSRC), "-o",
         str(so), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, (cu, so) in jobs.items()}
    _cuda.build("flash_bwd")
    usage = {"shipped": _cuda.ptxas_usage("flash_bwd")}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        if name != "lds_probe":
            _cuda._libs[("flash_bwd", (name,))] = ctypes.CDLL(
                str(jobs[name][1]))
            usage[name] = _cuda.parse_ptxas(log)
    for name, u in usage.items():
        regs = [v["registers"] for k, v in u.items()
                if "flash_bwd_fmaILi64E" in k]
        print(f"ptxas {name}: flash_bwd_fma<64> {regs[0]} registers",
              flush=True)
    lib = ctypes.CDLL(str(jobs["lds_probe"][1]))
    lib.lds_probe_run.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int]
    return lib


def time_reads(lib, card: str) -> None:
    import torch

    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 256, device="cuda")
    cycles = torch.zeros(blocks, dtype=torch.int64, device="cuda")
    iters = 4096
    for mode, (name, _) in enumerate(LDS_PATTERNS):
        lib.lds_probe_run(mode, out.data_ptr(), cycles.data_ptr(), 64, blocks)
        if lib.lds_probe_run(mode, out.data_ptr(), cycles.data_ptr(), iters,
                             blocks):
            raise RuntimeError("the shared-memory read probe failed")
        per = cycles.double().mean().item() / (iters * 16 * 8)
        print(f"lds.128 {name}: {per:.3f} SM cycles a warp-read (8 warps "
              f"an SM, {blocks} SMs; {card})", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, nargs=4, default=[4, 2048, 12, 64],
                    metavar=("B", "L", "H", "D"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_f32_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from chainermn_torch.ops import _cuda
    from chainermn_torch.ops.flash_attention import flash_attention_cuda

    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    lib = build_probe_kernels()
    time_reads(lib, card)

    b, l, h, d = args.shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, dout = (torch.randn(b, l, h, d, device="cuda", generator=gen)
                     for _ in range(4))
    out, lse = flash_attention_cuda(q, k, v, True)
    dr = (dout * out).sum(-1).transpose(1, 2).contiguous()
    dq = torch.zeros_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)

    def launch():
        _cuda.launch_flash_bwd(q, k, v, dout, lse, dr, None, None, dq, dk,
                               dv, d ** -0.5, True, 0)

    # the 64-key copy computes the same gradients
    with _cuda.variant("flash_bwd", ("keys64",)):
        dq.zero_()
        launch()
        got = (dq.clone(), dk.clone(), dv.clone())
    dq.zero_()
    launch()
    shares = [chip_smoke._close(g, r, torch.float32)[2]
              for g, r in zip(got, (dq, dk, dv))]
    print(f"keys64 vs shipped: worst share of 1e-4 + 1e-4|ref| "
          f"{max(shares):.3f}", flush=True)
    if max(shares) > 1.0:
        raise RuntimeError("the 64-key copy disagrees with the shipped body")

    times = {}
    order = ["shipped", *COPIES, *reversed(COPIES), "shipped"]
    for name in order:
        if name == "shipped":
            t = chip_smoke.cuda_time_ms(launch)
        else:
            with _cuda.variant("flash_bwd", (name,)):
                t = chip_smoke.cuda_time_ms(launch)
        times.setdefault(name, []).append(t)
        print(f"time flash_bwd_fma [{b},{l},{h},{d}] f32 causal {name}: "
              f"{t:.4f} ms ({card})", flush=True)
    base = sum(times["shipped"]) / 2
    print("shares of the shipped launch (ms it saves when left out): "
          + "; ".join(f"{name} {base - sum(ts) / 2:.4f}"
                      for name, ts in times.items()
                      if name not in ("shipped", "keys64"))
          + f"; shipped {base:.4f} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
