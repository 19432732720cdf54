"""The port's collective synthesis (``chainermn_torch.synthesis``) against
the JAX package's (``chainermn_tpu.synthesis``) and the flat sum.

* The sketch IR: ``check_program`` gives JAX's verdicts; for one tier of
  8, two tiers of 4 x 2 and three of 2 x 2 x 2, lossless and lossy,
  ``enumerate_programs`` gives JAX's lists, ``program_wire_bytes`` JAX's
  numbers exactly and ``program_cost_us`` JAX's to 1e-12 relative (on a
  topology with JAX's constants and storage wire).
* ``SynthesizedReducer``: one 8-rank gloo world (two "nodes" of four)
  runs every lossless program of the three decompositions, each bitwise
  equal to the flat sum on integer-valued floats, with the ring bytes at
  each tier's collectives equal to ``program_wire_bytes``. JAX's own
  reducer tests are red here (``lax.psum(axis_index_groups=)`` raises
  ``NotImplementedError`` on the CPU), so the flat sum is the oracle. The
  same world runs the mesh-axes mapping, the slow-tier int8-block
  placement exact on amax-pinned data, the quantized programs' bytes
  (int32 codes and block maxima: what the port's collectives carry), an
  error-feedback snapshot and resume through the optimizer's
  ``state_dict`` bit for bit, and JAX's refusals.
* ``synth``: JAX's output for the same flags.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import contextlib
import io
import json
import math
import pickle

import pytest

import chainermn_tpu.synthesis as js
import chainermn_tpu.tuning as jt
from chainermn_torch import synthesis as ts
from chainermn_torch import tuning as tt
from chainermn_torch.collectives import QUANT_BLOCK
from chainermn_torch.synthesis import sketch as tsketch
from tests.test_torch_mp import assert_ranks_ok, run_world
from tests.test_torch_tuning import (FIXTURES, _load_tool, jax_three_tier,
                                     port_topology)

SIZES = (4, 1000, 4097 * 4, 1 << 20, (51 << 20) + 12)


def _port(prog):
    return ts.Program.from_dict(prog.to_dict())


def _jax_programs():
    """Valid and invalid programs (JAX's validity fixtures)."""
    S = js.Step
    out = [
        js.Program((S("reduce_scatter", 0), S("all_reduce", 1),
                    S("all_gather", 0)), (4, 2)),
        js.Program((S("bogus", 0), S("all_reduce", 5)), (4, 2)),
        js.Program((S("all_reduce", 0), S("all_reduce", 0),
                    S("all_reduce", 1)), (4, 2)),
        js.Program((S("reduce_scatter", 0), S("all_reduce", 1)), (4, 2)),
        js.Program((S("reduce_scatter", 0), S("reduce_scatter", 1),
                    S("all_gather", 0), S("all_gather", 1)), (2, 2)),
        js.Program((S("all_reduce", 0), S("all_reduce", 1),
                    S("all_gather", 0)), (4, 2)),
        js.Program((S("quantize", wire="int8-block"), S("all_reduce", 0),
                    S("all_reduce", 1)), (4, 2)),
        js.Program((S("quantize", wire="int8-block"), S("dequantize"),
                    S("all_reduce", 0), S("all_reduce", 1)), (4, 2)),
        js.Program((S("quantize", wire="int8-block"),
                    S("reduce_scatter", 0), S("all_reduce", 1),
                    S("dequantize"), S("all_gather", 0)), (4, 2)),
        js.Program((S("quantize", wire="fp3"), S("all_reduce", 0),
                    S("all_reduce", 1), S("dequantize")), (4, 2)),
        js.Program((S("quantize", wire="bf16"), S("quantize", wire="bf16"),
                    S("all_reduce", 0), S("dequantize"),
                    S("all_reduce", 1)), (4, 2)),
        js.Program((S("dequantize"), S("all_reduce", 0),
                    S("all_reduce", 1)), (4, 2)),
    ]
    for topo in FIXTURES.values():
        out += js.enumerate_programs(topo, lossy=True)
    return out


def test_check_program_gives_jaxs_verdicts():
    for prog in _jax_programs():
        assert ts.check_program(_port(prog)) == js.check_program(prog)
        assert _port(prog).describe() == prog.describe()
        assert (_port(prog).wire_format, _port(prog).has_scatter) == (
            prog.wire_format, prog.has_scatter)


@pytest.mark.parametrize("lossy", [False, True])
@pytest.mark.parametrize("name", ["8", "4x2", "2x2x2"])
def test_enumeration_wire_bytes_and_costs_are_jaxs(name, lossy):
    j = FIXTURES[name]
    p = port_topology(j)
    jprogs = js.enumerate_programs(j, lossy=lossy)
    pprogs = ts.enumerate_programs(p, lossy=lossy)
    assert [q.to_dict() for q in pprogs] == [q.to_dict() for q in jprogs]
    for jq, pq in zip(jprogs, pprogs):
        for nbytes in SIZES:
            for exact in (True, False):
                assert ts.program_wire_bytes(pq, nbytes, exact) == \
                    js.program_wire_bytes(jq, nbytes, exact)
            assert ts.program_cost_us(pq, p, nbytes) == pytest.approx(
                js.program_cost_us(jq, j, nbytes), rel=1e-12)
    with pytest.raises(ValueError, match="bound to tier sizes"):
        ts.program_cost_us(pprogs[0], port_topology(jt.two_tier(2, 2)), 64)


def test_sketch_constants_and_the_collective_accounting():
    """The block is the codec's; ``wire="collective"`` counts int32 codes
    of whole blocks and the block maxima's MAX all-reduce on the
    quantized tier (hand-computed), lossless programs count as the
    storage wire does, and a port topology prices its own wire; the
    canonical cascade reproduces the hierarchical estimate."""
    assert tsketch._BLOCK == QUANT_BLOCK
    assert ts.STEP_OPS == js.STEP_OPS and ts.QUANT_WIRES == js.QUANT_WIRES
    topo = tt.two_tier(4, 2)
    progs = {q.name: q for q in ts.enumerate_programs(topo, lossy=True)}
    b = 4 << 20
    elems = b // 4 // 4  # the chunk after the 4-way scatter
    nblk = elems // QUANT_BLOCK
    inter = ts.program_wire_bytes(progs["cascade-q@inter-int8-block"], b,
                                  wire="collective")
    assert inter == {0: 2 * b * 3 / 4,
                     1: 2 * (4 * elems + 4 * nblk) * 1 / 2}
    full = b // 4
    alln = ts.program_wire_bytes(progs["ladder-q@all-int4-block"], b,
                                 wire="collective")
    q = 4 * full + 4 * (full // QUANT_BLOCK)
    assert alln == {0: 2 * q * 3 / 4, 1: 2 * q * 1 / 2}
    for name in ("cascade-0", "cascade-1", "scatter-through"):
        assert ts.program_wire_bytes(progs[name], b, wire="collective") \
            == ts.program_wire_bytes(progs[name], b)
    assert ts.program_cost_us(progs["cascade-1"], topo, b) == \
        pytest.approx(topo.estimate_us("hierarchical", b), rel=1e-12)
    lossy = progs["cascade-q@inter-int8-block"]
    assert ts.program_cost_us(lossy, topo, b) > ts.program_cost_us(
        lossy, tt.Topology(topo.tiers, wire="storage"), b)


def test_synth_cli_is_jaxs(tmp_path):
    """``--describe`` prints JAX's text for the same tiers (lossless; the
    lossy programs' prices carry the port's quantize overhead and int32
    wire, their names and bytes are JAX's); ``--emit`` stores JAX's plan
    and exits as JAX's does; usage errors exit 2."""
    from chainermn_torch.tools import synth

    jtool = _load_tool("synth")

    def run(main, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            code = main(argv)
        return out.getvalue(), code

    tiers = ["--tiers", "ici:4:1:100,dcn:2:100:25"]
    for extra in ([], ["--bytes", "1000"], ["--tiers",
                                             "ici:2:1:100,nvl:2:10:50,"
                                             "dcn:2:100:25"]):
        argv = ["--describe"] + (extra if "--tiers" in extra
                                 else tiers + extra)
        assert run(synth.main, argv) == run(jtool.main, argv)
    argv = ["--describe", "--lossy"] + tiers
    pout, pcode = run(synth.main, argv)
    jout, jcode = run(jtool.main, argv)
    assert pcode == jcode == 0
    strip = [ln.split(" us ")[-1] for ln in pout.splitlines()]
    assert strip == [ln.split(" us ")[-1] for ln in jout.splitlines()]
    out, code = run(synth.main, ["--describe", "--intra", "4", "--inter",
                                 "2"])
    assert code == 0 and "nvlink[4] 368.22GB/s/55.31us" in out
    for spec, want in (("ici:4:1:100,dcn:2:100:25", 0), ("ici:8:1:100", 1)):
        dbs = []
        for main, name in ((synth.main, "port"), (jtool.main, "jax")):
            path = str(tmp_path / f"{name}-{want}.json")
            _, code = run(main, ["--emit", path, "--tiers", spec])
            assert code == want
            dbs.append(path)
        if want == 0:
            fp = "cpu:generic/ici:4+dcn:2"
            p = tt.ProfileDB(dbs[0]).plan_for(fp)
            assert p.to_dict() == jt.ProfileDB(dbs[1]).plan_for(
                fp).to_dict()
            assert p.strategy == "synth"
            out, code = run(synth.main, ["--emit", dbs[0], "--tiers", spec])
            assert code == 0 and "unchanged" in out
    assert run(synth.main, ["--describe"])[1] == 2
    assert run(synth.main, ["--describe", "--bytes", "0", "--intra", "2",
                            "--inter", "2"])[1] == 2


# -- the reducer on 8 gloo ranks -------------------------------------------------

_WORKER = r'''
import copy, json, os, pickle, sys
import numpy as np
import torch
from chainermn_torch.collectives import make_grad_reducer
from chainermn_torch.comm import create_communicator
from chainermn_torch.optimizers import create_multi_node_optimizer
from chainermn_torch.synthesis import (Program, Step, SynthesizedReducer,
                                       enumerate_programs,
                                       program_wire_bytes)
from chainermn_torch.tuning import Tier, Topology

out = sys.argv[1]
comm = create_communicator("pure_nccl", device="cpu")
r, n = comm.rank, comm.size
res = {}


def topo(*sizes):
    return Topology(tuple(Tier(f"t{i}", s, 1.0, 1.0)
                          for i, s in enumerate(sizes)))


def counted(red, fn):
    """Run fn; the ring bytes each tier's collectives carried (a k-ring
    reduce-scatter or all-gather of c moves c(k-1)/k or c(k-1), an
    all-reduce 2c(k-1)/k), counted from the buffers handed to them."""
    moved = {i: 0.0 for i in range(len(red.tiers.sizes))}
    for i, c in enumerate(red.tiers.comms):
        if c is None:
            continue
        k = c.size

        def wrap(name, factor, c=c, i=i):
            f = getattr(c, name)

            def g(t, *a, **kw):
                moved[i] += t.numel() * t.element_size() * factor
                return f(t, *a, **kw)
            setattr(c, name, g)
        wrap("reduce_flat", 2 * (k - 1) / k)
        wrap("reduce_scatter_flat", (k - 1) / k)
        wrap("all_gather_flat", k - 1)
    value = fn()
    for c in red.tiers.comms:
        if c is not None:
            for name in ("reduce_flat", "reduce_scatter_flat",
                         "all_gather_flat"):
                delattr(c, name)
    return value, moved


rs = np.random.RandomState(0)
every = rs.randint(-8, 9, size=(n, 4097)).astype(np.float32)
want = torch.tensor(every.sum(0) / n)
for name, sizes in (("4x2", (4, 2)), ("2x2x2", (2, 2, 2)), ("8", (8,))):
    rows = []
    for prog in enumerate_programs(topo(*sizes)):
        red = make_grad_reducer("synth", comm, program=prog)
        g = [torch.tensor(every[r])]
        (g, state), moved = counted(red, lambda: red.reduce(g, ()))
        rows.append((prog.name, red.tiers.mode, red.stateful,
                     torch.equal(g[0], want), moved,
                     program_wire_bytes(prog, 4097 * 4),
                     program_wire_bytes(prog, 4097 * 4, wire="collective")))
    res[name] = rows
# the dict form compiles to the same reducer
prog = enumerate_programs(topo(4, 2))[1]
g = [torch.tensor(every[r])]
make_grad_reducer("synth", comm, program=prog.to_dict()).reduce(g)
res["dict_form"] = torch.equal(g[0], want)

# mesh axes: the ("dcn", "ici") = (2, 4) mesh, innermost tier = last axis
hc = create_communicator("hierarchical", device="cpu")
red = make_grad_reducer("synth", hc, program=prog)
g = [torch.tensor(every[r][:1024].copy())]
red.reduce(g)
res["axes"] = (red.tiers.mode, hc.axis_names, hc.mesh_shape,
               torch.equal(g[0], torch.tensor(every[:, :1024].sum(0) / n)))

progs = {p.name: p for p in enumerate_programs(
    topo(4, 2), lossy=True, wires=("bf16", "int8-block", "int4-block"))}
# slow-tier int8-block, exact: only ranks 0 and 4 (ici coordinate 0)
# contribute integers on a scale-1 grid (every 256th pinned to 127)
red = make_grad_reducer("synth", comm,
                        program=progs["cascade-q@inter-int8-block"])
L = 8192
g0 = np.zeros((n, L), np.float32)
prs = np.random.RandomState(3)
for q in (0, 4):
    g0[q] = prs.randint(-8, 9, size=L).astype(np.float32)
    g0[q, ::256] = 127.0
g = [torch.tensor(g0[r])]
state = red.init(g)
(g, new), moved = counted(red, lambda: red.reduce(g, state))
res["inter_exact"] = (red.stateful, red._n_regions, [s.shape for s in state],
                      torch.equal(g[0], torch.tensor(g0.sum(0) / n)),
                      all(not s.any() for s in new))
res["quant_bytes"] = {}
for pname in ("cascade-q@inter-int8-block", "ladder-q@all-int8-block",
              "ladder-q@all-bf16", "cascade-q@inter-int4-block"):
    red = make_grad_reducer("synth", comm, program=progs[pname])
    g = [torch.tensor(g0[r])]
    st = red.init(g)
    _, moved = counted(red, lambda: red.reduce(g, st))
    res["quant_bytes"][pname] = (moved, red.tier_wire_bytes(L * 4),
                                 red.wire_bytes(L * 4))
res["plan_row"] = red.plan([torch.zeros(1024)])[0]

# error feedback through the optimizer's state_dict
prog = progs["cascade-q@inter-int8-block"]
grs = np.random.RandomState(4)
gs = [grs.randn(n, 2048).astype(np.float32) * 1e-2 for _ in range(6)]


def opt_for(w):
    red = make_grad_reducer("synth", comm, program=prog)
    return create_multi_node_optimizer(torch.optim.SGD([w], lr=1.0), comm,
                                       grad_reducer=red)


def run(opt, w, lo, hi):
    outs = []
    for t in range(lo, hi):
        w.grad = torch.tensor(gs[t][r])
        opt.step()
        outs.append(w.detach().clone())
    return outs


w = torch.nn.Parameter(torch.zeros(2048))
ref = run(opt_for(w), w, 0, 6)
w = torch.nn.Parameter(torch.zeros(2048))
opt = opt_for(w)
head = run(opt, w, 0, 3)
snap = copy.deepcopy(opt.state_dict())
w2 = torch.nn.Parameter(w.detach().clone())
opt2 = opt_for(w2)
opt2.load_state_dict(snap)
tail = run(opt2, w2, 3, 6)
w3 = torch.nn.Parameter(head[-1].clone())
ctrl = run(opt_for(w3), w3, 3, 6)
res["ef"] = (all(torch.equal(a, b) for a, b in zip(head + tail, ref)),
             float(snap["reducer"][0].abs().max()),
             float((ctrl[0] - ref[3]).abs().max()),
             [tuple(s.shape) for s in snap["reducer"]])

# JAX's refusals
refusals = {}
for key, fn in (
        ("program", lambda: make_grad_reducer("synth", comm)),
        ("invalid", lambda: SynthesizedReducer(
            comm, program=Program((Step("all_reduce", 0),), (4, 2)))),
        ("product", lambda: SynthesizedReducer(
            comm, program=enumerate_programs(topo(4, 4))[0])),
        ("wire", lambda: make_grad_reducer(
            "synth", comm, program=progs["ladder-q@all-int8-block"],
            wire_format="int4-block")),
        ("state", lambda: make_grad_reducer(
            "synth", comm, program=prog).reduce([torch.zeros(1000)], ())),
        ("axes", lambda: SynthesizedReducer(
            hc, program=enumerate_programs(topo(2, 2, 2))[0]))):
    try:
        fn()
        refusals[key] = None
    except ValueError as e:
        refusals[key] = str(e)
res["refusals"] = refusals
res["ef_off"] = SynthesizedReducer(
    comm, program=progs["ladder-q@all-int4-block"], ef=False).init(
        [torch.zeros(64)])
res["layout"] = [tuple(s.shape) for s in make_grad_reducer(
    "synth", comm, program=prog).init([torch.zeros(1000)])]
with open(os.path.join(out, f"rank{r}.pkl"), "wb") as f:
    pickle.dump(res, f)
comm.barrier()
hc.finalize()
comm.finalize()
print(f"RANK{r} OK", flush=True)
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    assert_ranks_ok(run_world(_WORKER, 8, timeout=420, args=[str(d)],
                              local=4))
    return [pickle.loads((d / f"rank{r}.pkl").read_bytes())
            for r in range(8)]


@pytest.mark.parametrize("name", ["4x2", "2x2x2", "8"])
def test_every_lossless_program_bitwise_equals_flat(world, name):
    """Every lossless program of the decomposition, on 4097 integer-valued
    floats a rank (an odd length: the buckets pad), equals the flat mean
    bit for bit on every rank, statelessly, in the factored-groups mode;
    its ring bytes at each tier's collectives are ``program_wire_bytes``
    (storage and collective accounting agree without a wire step)."""
    names = [p.name for p in ts.enumerate_programs(
        tt.Topology(tuple(tt.Tier(f"t{i}", int(s), 1.0, 1.0)
                          for i, s in enumerate(name.split("x")))))]
    for w in world:
        rows = w[name]
        assert [row[0] for row in rows] == names
        for pname, mode, stateful, equal, moved, storage, coll in rows:
            assert equal and not stateful and mode == "groups", pname
            assert moved == storage == coll, pname
    assert all(w["dict_form"] for w in world)


def test_axes_mode_runs_the_same_program(world):
    for w in world:
        mode, axes, shape, equal = w["axes"]
        assert (mode, axes, shape) == ("axes", ("dcn", "ici"),
                                       {"dcn": 2, "ici": 4})
        assert equal


def test_slow_tier_placement_is_exact_on_amax_pinned_data(world):
    """``cascade-q@inter-int8-block`` with only ranks 0 and 4 contributing
    integers on a scale-1 grid: the output is the flat mean bit for bit
    and the residual (in the scattered frame, 8192 / 4) stays zero."""
    for w in world:
        stateful, regions, shapes, equal, zero = w["inter_exact"]
        assert stateful and regions == 1 and shapes == [(2048,)]
        assert equal and zero


def test_quantized_programs_carry_int32_codes(world):
    """The bytes at the collectives of the quantized placements are
    ``program_wire_bytes(wire="collective")``: int32 codes padded to
    blocks and the block maxima (JAX counts 1 B a code; ROADMAP.md queue
    3); ``tier_wire_bytes`` and ``wire_bytes`` report them."""
    for w in world:
        for pname, (moved, tiers, total) in w["quant_bytes"].items():
            prog = {p.name: p for p in ts.enumerate_programs(
                tt.two_tier(4, 2), lossy=True,
                wires=("bf16", "int8-block", "int4-block"))}[pname]
            want = ts.program_wire_bytes(prog, 8192 * 4, wire="collective")
            assert moved == want, pname
            assert tiers == {f"tier{i}": math.ceil(b)
                             for i, b in want.items()}
            assert total == math.ceil(sum(want.values()))
    row = world[0]["plan_row"]
    assert row["algorithm"] == "synth:cascade-q@inter-int4-block"
    assert set(row["tier_wire_bytes"]) == {"tier0", "tier1"}


def test_ef_residual_snapshot_resume_is_bitwise(world):
    """Six SGD steps of the slow-tier int8-block program; three, a
    ``state_dict`` snapshot, a fresh optimizer loaded from it and three
    more reproduce them bit for bit; the residual is nonzero, and
    resuming with zeroed residuals diverges."""
    for w in world:
        equal, resid, ctrl, shapes = w["ef"]
        assert equal and resid > 0 and ctrl > 0
        assert shapes == [(512,)]


def test_refusals_are_jaxs(world):
    r = world[0]["refusals"]
    assert "program=" in r["program"]
    assert "invalid program" in r["invalid"]
    assert "multiply to 16" in r["product"]
    assert "part of the program" in r["wire"]
    assert "residuals" in r["state"]
    assert "cannot map 3 tiers onto mesh axes" in r["axes"]
    assert world[0]["ef_off"] == ()
    assert world[0]["layout"] == [(250,)]
