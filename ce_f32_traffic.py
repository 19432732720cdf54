#!/usr/bin/env python3
"""What the L2 traffic of the streamed operand costs the f32 CE backward
of the port (``ce_bwd_fma`` in ``chainermn_torch/csrc/fused_ce.cu``: dh
streams Wᵀ, dW streams h), on one GPU:

    python3 ce_f32_traffic.py [--n 1024 8192]

Builds two copies of ``fused_ce.cu`` under ``build/`` whose ``ce_bwd_fma``
copies only half of each streamed slab's rows (``half``: the traffic a
2-CTA cluster sharing the slabs would leave) or none of them (``none``).
Their outputs are wrong; only their times are read. dh and dW on f32
inputs [N, 768] x [768, 32768] are timed as ``chip_smoke.py`` times
kernels, in the order shipped, half, none, none, half, shipped. Prints
the card's name and power limit, then one line per kernel and N.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

#: the streamed operand's two slab copies in ce_bwd_fma, and what each
#: copy of the source puts in their place
_LOGITS = ("slab_async<B::NT, B::BS, B::FK / 4, B::LD>(st + B::BM * B::LD, "
           "tsrc,")
_SECOND = "slab_async<B::NT, B::VK, 64, B::LDW>(st + 256 * q, tsrc,"
COPIES = {
    "half": ((_LOGITS, _LOGITS.replace("B::BS,", "B::BS / 2,")),
             (_SECOND, _SECOND.replace("B::VK,", "B::VK / 2,"))),
    "none": ((_LOGITS, "if (0) " + _LOGITS), (_SECOND, "if (0) " + _SECOND)),
}


def build_copies() -> None:
    """Compile the copies (one nvcc each, started together) and register
    them as builds of ``fused_ce`` that ``_cuda.variant`` selects by the
    copy's name."""
    from chainermn_torch.ops import _cuda

    src = (_cuda._CSRC / "fused_ce.cu").read_text()
    out = _cuda._BUILD / "ce_f32_traffic"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, edits in COPIES.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"ce_bwd_fma no longer has {old!r}")
            text = text.replace(old, new)
        cu = out / f"fused_ce_{name}.cu"
        cu.write_text(text)
        jobs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda._NVCC_FLAGS, "-I", str(_cuda._CSRC),
             "-o", str(out / f"libfused_ce_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _cuda.build("fused_ce")
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} copy:\n{log}")
        _cuda._libs[("fused_ce", (name,))] = ctypes.CDLL(
            str(out / f"libfused_ce_{name}.so"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[1024, 8192])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ce_f32_traffic: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from chainermn_torch.ops import _cuda
    from chainermn_torch.ops.fused_ce import (ce_dh_cuda, ce_dw_cuda,
                                              ce_forward_cuda)

    card = chip_smoke.card_line()
    build_copies()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in args.n:
        h, wt, y = chip_smoke.ce_inputs(gen, n, 768, 32768, torch.float32)
        lse = ce_forward_cuda(h, wt, y)[0]
        for name, fn in (("ce_dh", ce_dh_cuda), ("ce_dw", ce_dw_cuda)):
            row = []
            for which in ("shipped", "half", "none", "none", "half",
                          "shipped"):
                with _cuda.variant("fused_ce",
                                   () if which == "shipped" else (which,)):
                    ms = chip_smoke.cuda_time_ms(lambda: fn(h, wt, y, lse),
                                                 iters=5, warmup=2)
                row.append(f"{which} {ms:.4f}")
            print(f"ce_f32_traffic {name} f32 [{n},768]x[768,32768] ms: "
                  + ", ".join(row) + f" ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
