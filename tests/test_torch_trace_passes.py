"""dlint's trace passes DL203, DL204 and DL205 against the JAX package's
HLO fixtures, and on real traces of a 2-rank gloo world.

Each JAX fixture of ``tests/analysis_tests/test_hlo_rules.py`` (DL203's
overlapped, individually serialized and synchronous pipeline hops;
DL204's degenerate and pinned prefetch, the async interval and no
gathers; DL205's narrow and hoisted reducers, the unquantized program,
the s32 gather, the tiny narrow collectives and the two families) is
rebuilt as a ``torch.profiler`` Chrome trace of the same scenario and
must give JAX's verdict, checked against JAX's own pass on the fixture.
Where the CPU records the events a pass reads (the memory events, gloo's
operand types), a real trace must give the verdict JAX's docstrings
give: plain FSDP keeps every layer's gather live (DL204 fails), the
scan step gathers one layer at a time (passes); the quantized reducers
put int32 codes on the wire (DL205 passes), the flat reducer shows no
evidence (skips, fails when quantization is expected).
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import functools
import json

import pytest

from chainermn_tpu.analysis import hlo_passes as jhlo
from chainermn_torch.analysis import NOT_YET_PORTED, RULES
from chainermn_torch.analysis.trace_passes import (
    check_fsdp_gather_liveness, check_pipeline_permute_overlap,
    check_quantized_wire_dtype, nccl_dtype)
from tests.analysis_tests import test_hlo_rules as jfix
from tests.test_torch_mp import assert_ranks_ok, run_world


def test_every_hlo_pass_is_a_registered_trace_pass():
    from chainermn_tpu.analysis import RULES as JAX_RULES

    assert NOT_YET_PORTED == {}
    for rid in ("DL201", "DL202", "DL203", "DL204", "DL205"):
        assert RULES[rid].kind == "trace"
        assert RULES[rid].name == JAX_RULES[rid].name
        assert RULES[rid].doc.endswith("#" + rid.lower())


# ---------------------------------------------------------------------------
# DL203: pipeline hops
# ---------------------------------------------------------------------------

_HOP = "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"
_GEMM = "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n"


def _kernels(rows):
    """``rows``: ``(name, start_us, duration_us, stream)`` on card 0."""
    return {"traceEvents": [
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": tid, "name": name,
         "ts": float(ts), "dur": float(dur)}
        for name, ts, dur, tid in rows]}


PIPE = {
    # two hops on NCCL's stream, each with a stage kernel inside
    "overlapped": _kernels([(_HOP, 0, 100, 20), (_GEMM, 10, 50, 7),
                            (_HOP, 200, 100, 20), (_GEMM, 220, 50, 7)]),
    # two hops on NCCL's stream, the stage kernels only between them
    "serialized": _kernels([(_HOP, 0, 100, 20), (_GEMM, 110, 50, 7),
                            (_HOP, 200, 100, 20), (_GEMM, 310, 50, 7)]),
    # one hop on the compute stream, then the stage
    "sync": _kernels([(_HOP, 0, 100, 7), (_GEMM, 110, 50, 7)]),
}
PIPE_JAX = {"overlapped": jfix._PIPE_OVERLAPPED,
            "serialized": jfix._PIPE_SERIALIZED,
            "sync": jfix._PIPE_SYNC_FALLBACK}


@pytest.mark.parametrize("case", sorted(PIPE))
def test_dl203_gives_jaxs_verdict(case):
    want = jhlo.check_pipeline_permute_overlap(PIPE_JAX[case])
    got = check_pipeline_permute_overlap(PIPE[case])
    assert got["ok"] is want["ok"]
    assert got["sync_permutes"] == want["sync_permutes"]
    assert (got["min_compute_inside_any_pair"] >= 1) == \
        (want.get("min_compute_inside_any_pair", 0) >= 1)
    if case != "sync":
        assert got["n_permute_pairs"] == want["n_permute_pairs"] == 2
    assert ("fix" in got) is (not got["ok"])


def test_dl203_skips_without_hops_and_fails_without_device_events():
    out = check_pipeline_permute_overlap(_kernels([(_GEMM, 0, 10, 7)]))
    assert out["ok"] is None and "skip" in out
    out = check_pipeline_permute_overlap({"traceEvents": []})
    assert out["ok"] is False and out["n_device_events"] == 0


# ---------------------------------------------------------------------------
# DL204: FSDP gather liveness
# ---------------------------------------------------------------------------


def _fsdp(spans, mem):
    """``spans``: ``(name, start_us, end_us)`` gather spans; ``mem``:
    ``(ts, addr, bytes)`` memory events (negative bytes free)."""
    ev = [{"ph": "X", "cat": "user_annotation", "pid": 1, "tid": 1,
           "name": name, "ts": float(a), "dur": float(b - a)}
          for name, a, b in spans]
    ev += [{"ph": "i", "name": "[memory]", "pid": 1, "tid": 1,
            "ts": float(ts), "args": {"Addr": addr, "Bytes": nb,
                                      "Device Type": 1, "Device Id": 0}}
           for ts, addr, nb in mem]
    return {"traceEvents": ev}


_G = "fsdp::gather"
FSDP = {
    # four gathers up front, each buffer used until the end
    "degenerate": _fsdp(
        [(_G, 0, 10), (_G, 10, 20), (_G, 20, 30), (_G, 30, 40)],
        [(5, 1, 64), (15, 2, 64), (25, 3, 64), (35, 4, 64),
         (90, 1, -64), (91, 2, -64), (92, 3, -64), (93, 4, -64)]),
    # each gather's buffer dies before the next gather, and the
    # gathers' temporaries die inside their spans
    "pinned": _fsdp(
        [(_G, 0, 10), (_G, 30, 40), (_G, 60, 70), (_G, 90, 100)],
        [(2, 9, 16), (5, 1, 64), (8, 9, -16), (25, 1, -64),
         (35, 2, 64), (55, 2, -64), (65, 3, 64), (85, 3, -64),
         (95, 4, 64), (120, 4, -64)]),
}
FSDP_JAX = {"degenerate": jfix._FSDP_DEGENERATE,
            "pinned": jfix._FSDP_PINNED}


@pytest.mark.parametrize("case", sorted(FSDP))
def test_dl204_gives_jaxs_verdict(case):
    want = jhlo.check_fsdp_gather_liveness(FSDP_JAX[case], max_live=2)
    got = check_fsdp_gather_liveness(FSDP[case], max_live=2)
    assert got["ok"] is want["ok"]
    assert got["n_gathers"] == want["n_gathers"] == 4
    assert (got["peak_live_gathers"] <= 2) == (want["peak_live_gathers"]
                                               <= 2)
    if case == "degenerate":
        assert got["peak_live_gathers"] == want["peak_live_gathers"] == 4
        assert "fsdp_scan_apply" in got["fix"]


def test_dl204_two_gathers_in_flight_need_max_live_two():
    # JAX's async case: both gathered buffers live before either is used
    trace = _fsdp([(_G, 0, 10), (_G, 10, 20)],
                  [(5, 1, 64), (15, 2, 64), (30, 1, -64), (40, 2, -64)])
    out = check_fsdp_gather_liveness(trace, max_live=1)
    assert (out["n_gathers"], out["peak_live_gathers"], out["ok"]) == \
        (2, 2, False)
    assert check_fsdp_gather_liveness(trace, max_live=2)["ok"] is True


def test_dl204_counts_a_layer_once_and_judges_the_larger_group():
    # a layer's leaves gathered one after another are one unit; the two
    # full-leaf gathers (embedding, head) stay live but are the smaller
    # group, as JAX judges the scan body over the entry
    spans = [(_G, 0, 5), (_G, 5, 10)] + [
        (f"{_G}/layer={i}", 20 + 30 * i + 5 * j, 25 + 30 * i + 5 * j)
        for i in range(3) for j in range(3)]
    mem = [(2, 100, 8), (7, 101, 8), (200, 100, -8), (201, 101, -8)]
    for i in range(3):
        for j in range(3):
            t = 22 + 30 * i + 5 * j
            mem += [(t, 10 * i + j, 8), (45 + 30 * i, 10 * i + j, -8)]
    out = check_fsdp_gather_liveness(_fsdp(spans, mem))
    assert (out["computation"], out["n_gathers"],
            out["peak_live_gathers"], out["ok"]) == ("layer", 3, 1, True)
    leaf = check_fsdp_gather_liveness(_fsdp(spans, mem), max_live=1,
                                      computation="leaf")
    assert (leaf["peak_live_gathers"], leaf["ok"]) == (2, False)


def test_dl204_reads_a_block_whose_free_went_unrecorded():
    # three layers of two leaves; layer 0's second buffer (address 1) is
    # freed on a thread the profiler does not follow: no free event, and
    # its address is allocated again inside layer 2. It dies with layer
    # 0's recorded buffer, so one layer is live at a time
    spans = [(f"{_G}/layer={i}", 30 * i + 5 * j, 30 * i + 5 * j + 4)
             for i in range(3) for j in range(2)]
    mem = [(2, 0, 8), (7, 1, 8), (25, 0, -8),
           (32, 10, 8), (37, 11, 8), (55, 10, -8), (55, 11, -8),
           (62, 1, 8), (67, 21, 8), (85, 1, -8), (85, 21, -8)]
    out = check_fsdp_gather_liveness(_fsdp(spans, mem))
    assert (out["n_gathers"], out["peak_live_gathers"], out["ok"]) == \
        (3, 1, True)
    # with none of a unit's frees recorded, the next allocation of the
    # address bounds it: layer 0 then lives into layer 2
    mem = [m for m in mem if m[:2] != (25, 0)]
    out = check_fsdp_gather_liveness(_fsdp(spans, mem), max_live=1)
    assert (out["peak_live_gathers"], out["ok"]) == (2, False)


def test_dl204_skips_without_gathers_and_fails_without_memory_events():
    out = check_fsdp_gather_liveness(_kernels([(_GEMM, 0, 10, 7)]))
    assert out["ok"] is None and "skip" in out
    assert jhlo.check_fsdp_gather_liveness(jfix._DP_OVERLAPPED)["ok"] \
        is None
    out = check_fsdp_gather_liveness(_fsdp([(_G, 0, 10)], []))
    assert out["ok"] is False and "profile_memory" in out["fix"]


# ---------------------------------------------------------------------------
# DL205: quantized wire dtype
# ---------------------------------------------------------------------------


def _comms(rows):
    """``rows``: ``(collective name, torch dtype, elements)`` as
    ``record_param_comms`` records them."""
    return {"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1, "ts": float(i),
         "dur": 1.0, "name": "record_param_comms",
         "args": {"Collective name": op, "dtype": dt,
                  "In msg nelems": n, "Out msg nelems": n}}
        for i, (op, dt, n) in enumerate(rows)]}


WIRE = {
    "reduce_ok": (_comms([("allreduce", "Int", 4096),
                          ("allreduce", "Float", 16)]),
                  jfix._QUANT_REDUCE_OK),
    "hoisted_bad": (_comms([("allreduce", "Float", 4096),
                            ("allreduce", "Char", 512)]),
                    jfix._QUANT_HOISTED_BAD),
    "unquantized": (_comms([("allreduce", "Float", 4096)]),
                    jfix._DP_SERIALIZED),
    "s32_gather": (_comms([("_allgather_base", "Int", 8192)]), None),
    "tiny_narrow": (_comms([("allreduce", "Int", 1),
                            ("allreduce", "Float", 4096)]), None),
    "families": (_comms([("_allgather_base", "Char", 32768),
                         ("_allgather_base", "Float", 128),
                         ("allreduce", "Float", 65536)]), None),
}


@functools.lru_cache(maxsize=None)
def _jax_wire(case):
    """JAX's verdict on its own fixture of the case (the inline ones
    rebuilt from the test's text)."""
    hlo = WIRE[case][1]
    if hlo is None:
        shapes = {
            "s32_gather": ["s32[8192]{0} all-gather(%p0), dimensions={0}"],
            "tiny_narrow": [
                "s32[1]{0} all-reduce(%i), to_apply=%add",
                "f32[4096]{0} all-reduce(%p0), to_apply=%add"],
            "families": [
                "s8[32768]{0} all-gather(%p0), dimensions={0}",
                "f32[128]{0} all-gather(%s), dimensions={0}",
                "f32[65536]{0} all-reduce(%g), to_apply=%add"]}[case]
        hlo = "ENTRY %main.3 () -> f32[1] {\n" + "".join(
            f"  %c{i} = {s}\n" for i, s in enumerate(shapes)) + "}\n"
    return (jhlo.check_quantized_wire_dtype(hlo),
            jhlo.check_quantized_wire_dtype(hlo, expect_quantized=True))


@pytest.mark.parametrize("case", sorted(WIRE))
def test_dl205_gives_jaxs_verdict(case):
    want, want_q = _jax_wire(case)
    got = check_quantized_wire_dtype(WIRE[case][0])
    got_q = check_quantized_wire_dtype(WIRE[case][0], expect_quantized=True)
    assert (got["ok"], got_q["ok"]) == (want["ok"], want_q["ok"])
    assert ("skip" in got) is ("skip" in want)
    assert {k: v["dtype"] for k, v in got.get("dominant", {}).items()} == \
        {k: v["dtype"] for k, v in want.get("dominant", {}).items()}
    if got["ok"] is False:
        assert "dl205" in got["fix"]


def test_dl205_fails_on_collectives_without_a_dtype():
    trace = {"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1, "ts": 0.0,
         "dur": 1.0, "name": "gloo:all_reduce", "args": {}}]}
    out = check_quantized_wire_dtype(trace)
    assert out["ok"] is False and "record_shapes" in out["fix"]
    assert check_quantized_wire_dtype({"traceEvents": []})["ok"] is None


def test_nccl_kernel_names_carry_their_dtype():
    assert nccl_dtype("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "f32"
    assert nccl_dtype("ncclDevKernel_AllReduce_Sum_i32_RING_LL") == "s32"
    assert nccl_dtype("ncclKernel_AllGather_RING_LL_Sum_int8_t") == "s8"
    assert nccl_dtype("ncclDevKernel_AllReduce_Sum_bf16_TREE_LL") == "bf16"
    assert nccl_dtype(_HOP) is None


# ---------------------------------------------------------------------------
# real traces of a 2-rank gloo world
# ---------------------------------------------------------------------------

_WORLD = r'''
import json, os
import torch
from chainermn_torch.analysis import trace_passes as tp
from chainermn_torch.collectives import QuantizedReducer
from chainermn_torch.comm import create_communicator
from chainermn_torch.models import MLP
from chainermn_torch.models.convert import (flax_params,
                                            stacked_params_from_flax)
from chainermn_torch.models.transformer import (TransformerLM,
    make_lm_fsdp_scan_loss, stack_lm_blocks)
from chainermn_torch.optimizers import (fsdp_shardings,
    fsdp_stack_shardings, make_fsdp_train_step)
from chainermn_torch.training.profiling import capture

comm = create_communicator("pure_nccl", device="cpu")
torch.manual_seed(0)
res = {}
step, _ = make_fsdp_train_step(MLP(n_units=16, device="cpu"),
                               lambda ps: torch.optim.SGD(ps, lr=0.1), comm)
x, y = torch.rand(4, 784), torch.randint(0, 10, (4,))
step(x, y)
with capture("cpu", memory=True) as t:
    step(x, y)
res["fsdp"] = tp.check_fsdp_gather_liveness(t["trace"])
lm = TransformerLM(vocab=256, d_model=32, n_heads=4, n_layers=3, d_ff=64,
                   max_len=16, device="cpu")
packed = stack_lm_blocks(stacked_params_from_flax(flax_params(lm)))
sh = dict(fsdp_shardings(packed, comm),
          blocks=fsdp_stack_shardings(packed, comm)["blocks"])
step, _ = make_fsdp_train_step(
    None, lambda ps: torch.optim.Adam(ps, lr=1e-3), comm, packed,
    loss_fn=make_lm_fsdp_scan_loss(lm), param_shardings=sh)
toks = torch.randint(0, 256, (2, 17))
step(toks[:, :-1], toks[:, 1:])
with capture("cpu", memory=True) as t:
    step(toks[:, :-1], toks[:, 1:])
res["scan"] = tp.check_fsdp_gather_liveness(t["trace"])
grads = [torch.randn(3000), torch.randn(700)]
for wire in ("flat", "int8-block", "int8"):
    with capture("cpu", shapes=True) as t:
        if wire == "flat":
            comm.allreduce_grad([g.clone() for g in grads])
        else:
            red = QuantizedReducer(comm, wire_format=wire, ef=False)
            red.reduce([g.clone() for g in grads], red.init(grads))
    res[wire] = [tp.check_quantized_wire_dtype(t["trace"]),
                 tp.check_quantized_wire_dtype(t["trace"],
                                               expect_quantized=True)]
print("RESULT " + json.dumps(res), flush=True)
comm.finalize()
print(f"RANK{int(os.environ['RANK'])} OK", flush=True)
'''


@functools.lru_cache(maxsize=None)
def _world():
    results = run_world(_WORLD, 2, timeout=240)
    assert_ranks_ok(results)
    out = []
    for _, text in results:
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("RESULT "))
        out.append(json.loads(line[len("RESULT "):]))
    return out


def test_dl204_on_real_gloo_traces_plain_fsdp_fails_the_scan_passes():
    for res in _world():
        plain, scan = res["fsdp"], res["scan"]
        assert (plain["computation"], plain["ok"]) == ("leaf", False)
        assert plain["peak_live_gathers"] > 2
        assert (scan["computation"], scan["ok"]) == ("layer", True)
        assert scan["peak_live_gathers"] == 1
        # three layers, each gathered in the forward and again in the
        # remat backward
        assert scan["n_gathers"] == 6


@pytest.mark.parametrize("wire", ["int8-block", "int8"])
def test_dl205_on_real_gloo_traces_the_quantized_reducers_pass(wire):
    for res in _world():
        out, expected = res[wire]
        assert out["ok"] is True and expected["ok"] is True
        assert out["dominant"]["reduce"]["dtype"] == "s32"


def test_dl205_on_real_gloo_traces_the_flat_reducer_skips():
    for res in _world():
        out, expected = res["flat"]
        assert out["ok"] is None and "skip" in out
        assert expected["ok"] is False
