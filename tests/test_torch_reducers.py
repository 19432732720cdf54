"""The port's gradient reducers (``chainermn_torch.collectives``) against
the JAX package's (``chainermn_tpu.collectives``).

The codecs run in this process against JAX's, bit for bit. The reducers
run in one 4-rank gloo world (``run_world``, two ranks a node), which
writes each rank's results; the JAX side runs the same numpy inputs (made
from seeds) through the JAX reducers under ``shard_map`` on 4 CPU
devices, each device one rank holding its own gradient: a ``("r",)``
mesh, and a ``("dcn", "ici")`` = (2, 2) mesh for the hierarchical
reducer's axes mode. JAX's groups mode (``intra=`` on one axis) needs
``psum(axis_index_groups=)``, which the CPU backend refuses, so the
port's groups mode is held to the flat sum.

Tolerances: ``flat`` and ``hierarchical`` at 1e-6 relative to the
addends' magnitude, Σ|x| (sums of four f32 values in another order:
where they cancel, the error is relative to the addends, not to the
sum), and bitwise on integer-valued floats
(every partial sum is exact); the quantized integer formats bitwise in
their reduced sums (the same codes and scales, summed in int32) and in
their tiles, each step fed the same residuals, the residuals within
2^-23 of the value quantized (XLA fuses ``g' − q·scale`` into one
multiply-add, torch rounds the product first); bf16 within (n − 1) bf16 half-ulps of the f32 sum
of the bf16-rounded inputs (each of the n − 1 partial sums is rounded to
bf16 on the wire, by at most 2^-8 of its magnitude, which Σ|x| bounds),
its residual at 1e-7; the auto strategy's choices exactly.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses
import inspect
import json
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu.collectives import AutoReducer as JAuto
from chainermn_tpu.collectives import CostModel as JCost
from chainermn_tpu.collectives import HierarchicalReducer as JHier
from chainermn_tpu.collectives import QuantizedReducer as JQuant
from chainermn_tpu.collectives import quantized as jq
from chainermn_tpu.comm.xla import XlaCommunicator
from chainermn_torch.collectives import quantized as tq
from tests.test_torch_mp import assert_ranks_ok, run_world

N = 4
MODES = ("bf16", "int8", "int8-block", "int4-block")
BUCKET = 3000
SHAPES = [(37, 19), (19,), (700,), (5, 3)]
SWEEP = [1 << p for p in range(8, 27)]


def inputs():
    """Each rank's gradient trees (two steps, leaves scaled 1e-2..3), an
    integer-valued tree, integer-valued flat vectors (odd length, and a
    length of 4 x 640), and a flat vector for the ZeRO hooks (4 x 512)
    (the workers run this function's source, so they need no JAX)."""
    rs = np.random.RandomState(0)
    scales = [1e-2, 1.0, 3.0, 0.1]

    def tree():
        return [(rs.randn(N, *s) * c).astype(np.float32)
                for s, c in zip(SHAPES, scales)]

    return {"steps": [tree(), tree()],
            "int": [rs.randint(-8, 8, size=(N, *s)).astype(np.float32)
                    for s in SHAPES],
            "iv_odd": rs.randint(-8, 8, size=(N, 4097)).astype(np.float32),
            "iv_rs": rs.randint(-8, 8, size=(N, N * 640)).astype(
                np.float32),
            "zv": rs.randn(N, N * 512).astype(np.float32)}


_WORKER = r'''
import json, os, pickle, sys
import numpy as np
import torch
from chainermn_torch.collectives import (AutoReducer, CostModel, FlatReducer,
                                         HierarchicalReducer,
                                         QuantizedReducer, make_grad_reducer,
                                         measure_strategies,
                                         quantize_allreduce)
from chainermn_torch.comm import create_communicator
''' + f"N, BUCKET, SHAPES, MODES = {N}, {BUCKET}, {SHAPES!r}, {MODES!r}\n" \
    + f"SWEEP = {SWEEP!r}\n" + inspect.getsource(inputs) + r'''

out, jax_cost = sys.argv[1], json.loads(sys.argv[2])
comm = create_communicator("pure_nccl", device="cpu")
r = comm.rank
d = inputs()
res = {}


def mine(tree):
    return [torch.tensor(a[r]) for a in tree]


def run(reducer, tree, state=()):
    g = mine(tree)
    before = comm.collective_bytes
    g, state = reducer.reduce(g, state)
    return [t.numpy() for t in g], state, comm.collective_bytes - before


def wire(reducer, tree):
    return sum(row["wire_bytes"] for row in reducer.plan(mine(tree)))


# -- flat ------------------------------------------------------------------
for name, red in (("flat", FlatReducer(comm)),
                  ("flat_b", FlatReducer(comm, bucket_bytes=BUCKET))):
    res[name], _, counted = run(red, d["steps"][0])
    res[name + "_int"] = run(red, d["int"])[0]
    res[name + "_wire"] = (counted, wire(red, d["steps"][0]))
res["rs_flat"] = comm.reduce_scatter_flat(torch.tensor(d["iv_rs"][r])).numpy()

# -- hierarchical: axes mode on the ("dcn", "ici") = (2, 2) mesh -----------
hc = create_communicator("hierarchical", device="cpu")
hr = HierarchicalReducer(hc)
topo = hr.topology
res["axes_topo"] = (topo.mode, topo.intra, topo.inter, hc.axis_names,
                    hc.mesh_shape, topo.intra_comm.members,
                    topo.inter_comm.members)
res["axes"] = run(hr, d["steps"][0])[0]
res["axes_int"] = run(hr, d["int"])[0]
res["axes_ar"] = topo.allreduce(torch.tensor(d["iv_odd"][r])).numpy()
res["axes_rs"] = hr.reduce_scatter_flat(torch.tensor(d["iv_rs"][r]),
                                        1).numpy()

# -- hierarchical: groups mode, intra=2 -----------------------------------
gr = HierarchicalReducer(comm, intra=2)
topo = gr.topology
res["groups_topo"] = (topo.mode, topo.intra, topo.inter,
                      topo.intra_comm.members, topo.inter_comm.members)
res["groups"] = run(gr, d["steps"][0])[0]
res["groups_int"] = run(gr, d["int"])[0]
res["groups_ar"] = topo.allreduce(torch.tensor(d["iv_odd"][r])).numpy()
res["groups_rs"] = gr.reduce_scatter_flat(torch.tensor(d["iv_rs"][r]),
                                          1).numpy()

# -- quantized -------------------------------------------------------------
for m in MODES:
    q = QuantizedReducer(comm, mode=m, bucket_bytes=BUCKET)
    state = q.init(mine(d["steps"][0]))
    steps = []
    for tree in d["steps"]:
        g, state, counted = run(q, tree, state)
        steps.append((g, [s.numpy() for s in state], counted))
    res["q_" + m] = steps
    res["q_wire_" + m] = wire(q, d["steps"][0])
    res["q_noef_" + m] = run(QuantizedReducer(comm, mode=m, ef=False,
                                              bucket_bytes=BUCKET),
                             d["steps"][0])[0]
    zv = torch.tensor(d["zv"][r])
    res["rs_ef_" + m] = [t.numpy() for t in q.reduce_scatter_flat_ef(
        zv, torch.zeros_like(zv))]
    res["rs_" + m] = QuantizedReducer(comm, mode=m, ef=False
                                      ).reduce_scatter_flat(zv).numpy()
    try:
        q.reduce_scatter_flat(zv)
        res["rs_refused_" + m] = False
    except RuntimeError as e:
        res["rs_refused_" + m] = "reduce_scatter_flat_ef" in str(e)

# -- auto --------------------------------------------------------------------
cost = CostModel(**jax_cost)
choices = {}
for intra in (2, 4):
    for lossy in (False, True):
        for wf in MODES:
            a = AutoReducer(comm, intra=intra, cost=cost, lossy=lossy,
                            wire_format=wf)
            choices[f"{intra}/{lossy}/{wf}"] = [a.choose(b) for b in SWEEP]
res["auto_choices"] = choices
res["auto"] = run(make_grad_reducer("auto", comm, intra=2),
                  d["steps"][0])[0]
lossy = AutoReducer(comm, intra=2, cost=CostModel(dcn_latency_us=0.0,
                                                  quant_overhead_us=0.0),
                    lossy=True, wire_format="bf16", bucket_bytes=BUCKET)
res["auto_lossy_plan"] = [row["algorithm"] for row in
                          lossy.plan(mine(d["steps"][0]))]
g, _, counted = run(lossy, d["steps"][0])
res["auto_lossy"] = (g, counted, wire(lossy, d["steps"][0]))
res["measured"] = measure_strategies(comm)
with open(os.path.join(out, f"rank{r}.pkl"), "wb") as f:
    pickle.dump(res, f)
hc.finalize()
comm.finalize()
print(f"RANK{r} OK", flush=True)
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("reducers")
    cost = json.dumps(dataclasses.asdict(JCost()))
    assert_ranks_ok(run_world(_WORKER, N, timeout=240, args=[str(d), cost],
                              local=2))
    return [pickle.loads((d / f"rank{r}.pkl").read_bytes())
            for r in range(N)]


@pytest.fixture(scope="module")
def jcomm():
    return XlaCommunicator(Mesh(np.array(jax.devices()[:N]), ("r",)))


@pytest.fixture(scope="module")
def jcomm2d():
    return XlaCommunicator(Mesh(np.array(jax.devices()[:N]).reshape(2, 2),
                                ("dcn", "ici")))


def _assert_sum_close(got, want, parts):
    """Mean over ranks within 1e-6 of the addends' magnitude (module
    docstring); ``parts`` has the rank axis first."""
    tol = 1e-6 * np.abs(parts).sum(0) / N
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _smap(jc, fn, *stacked):
    """``fn`` on each rank's slice of the stacked (leading ``N``) trees,
    under ``shard_map``; the results stacked again."""
    axes = jc.axis_names
    spec = P(axes if len(axes) > 1 else axes[0])

    def body(*args):
        res = fn(*jax.tree_util.tree_map(lambda t: t[0], args))
        return jax.tree_util.tree_map(lambda t: t[None], res)

    return jax.tree_util.tree_map(np.asarray, jax.jit(shard_map(
        body, mesh=jc.mesh, in_specs=spec, out_specs=spec))(*stacked))


def _ranks(world, key):
    """``world[r][key]`` stacked on a leading rank axis, leafwise."""
    return jax.tree_util.tree_map(lambda *a: np.stack(a),
                                  *[w[key] for w in world])


def _jax_reduce(jc, red, tree, state=()):
    return _smap(jc, lambda g, s: red.reduce(list(g), s), tree, state)


# -- the codecs ----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8-block", "int4-block"])
@pytest.mark.parametrize("n", [1, 255, 256, 1000])
def test_block_codec_matches_jax_bitwise(mode, n):
    """``block_quantize`` codes and scales, and ``block_dequantize``, equal
    JAX's bit for bit (values spanning four decades, a zero block)."""
    rs = np.random.RandomState(n)
    v = (rs.randn(n) * 10.0 ** rs.uniform(-3, 1, n)).astype(np.float32)
    if n > 256:
        v[:256] = 0.0
    jqv, jsc = jq.block_quantize(jnp.asarray(v), mode)
    tqv, tsc = tq.block_quantize(torch.tensor(v), mode)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(
        tq.block_dequantize(tqv, tsc, n, mode).numpy(),
        np.asarray(jq.block_dequantize(jqv, jsc, n, mode)))


@pytest.mark.parametrize("n", [1, 2, 15, 16])
def test_int4_packing_matches_jax_bitwise(n):
    q = np.arange(n) % 16 - 8
    packed = tq.pack_int4(torch.tensor(q))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(tq.unpack_int4(packed, n).numpy(), q)


@pytest.mark.parametrize("fmt", ["f32", *MODES])
def test_storage_wire_accounting_is_jaxs(fmt):
    """``wire_ratio``/``quantized_wire_bytes`` are JAX's (the storage
    wire); ``collective_wire_bytes`` counts int32 codes for the integer
    formats."""
    assert tq.wire_ratio(fmt) == jq.wire_ratio(fmt)
    for nb in (4, 1020, 4096, 1 << 20):
        assert tq.quantized_wire_bytes(nb, fmt) == \
            jq.quantized_wire_bytes(nb, fmt)
    want = {"f32": 4000, "bf16": 2000, "int8": 4004,
            "int8-block": 4 * 1024 + 16, "int4-block": 4 * 1024 + 16}
    assert tq.collective_wire_bytes(1000, fmt) == want[fmt]


# -- flat and hierarchical -------------------------------------------------------

def test_flat_matches_jax_psum(world, jcomm):
    """``flat`` (``allreduce_grad``) and the explicitly bucketed flat
    against JAX's flat reducer: 1e-6, bitwise on integer-valued floats."""
    from chainermn_tpu.collectives import FlatReducer as JFlat

    d = inputs()
    want = _jax_reduce(jcomm, JFlat(jcomm), d["steps"][0])[0]
    want_int = _jax_reduce(jcomm, JFlat(jcomm), d["int"])[0]
    for name in ("flat", "flat_b"):
        for got, w, t in zip(_ranks(world, name), want, d["steps"][0]):
            _assert_sum_close(got, w, t)
        for got, w in zip(_ranks(world, name + "_int"), want_int):
            np.testing.assert_array_equal(got, w)


def test_hierarchical_axes_mode_matches_jax(world, jcomm2d):
    """The ``hierarchical`` communicator's (2, 2) mesh: last axis the fast
    tier, the two tier groups of each rank; its reducer against JAX's
    ``HierarchicalReducer`` on the same mesh (1e-6; bitwise on integer
    floats), its padded all-reduce bitwise against the flat sum, its
    reduce-scatter tiles bitwise against JAX's flat ``psum_scatter``."""
    for r, w in enumerate(world):
        mode, intra, inter, axes, shape, intra_m, inter_m = w["axes_topo"]
        assert (mode, intra, inter, axes) == ("axes", 2, 2, ("dcn", "ici"))
        assert shape == {"dcn": 2, "ici": 2}
        assert intra_m == (r // 2 * 2, r // 2 * 2 + 1)
        assert inter_m == (r % 2, r % 2 + 2)
    d = inputs()
    red = JHier(jcomm2d)
    want = _jax_reduce(jcomm2d, red, d["steps"][0])[0]
    for got, w, t in zip(_ranks(world, "axes"), want, d["steps"][0]):
        _assert_sum_close(got, w, t)
    want_int = _jax_reduce(jcomm2d, red, d["int"])[0]
    for got, w in zip(_ranks(world, "axes_int"), want_int):
        np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(
        _ranks(world, "axes_ar"),
        np.broadcast_to(d["iv_odd"].sum(0), (N, 4097)))
    tiles = _smap(jcomm2d, lambda v: jax.lax.psum_scatter(
        v, ("dcn", "ici"), tiled=True), d["iv_rs"])
    np.testing.assert_array_equal(_ranks(world, "axes_rs"), tiles)


def test_hierarchical_groups_mode_equals_the_flat_sum(world):
    """``intra=2`` on the world: intra groups {0,1},{2,3}, inter groups
    {0,2},{1,3}; the padded all-reduce and the reducer bitwise against
    the flat sum on integer-valued floats, the reducer at 1e-6 on real
    gradients; the two-stage reduce-scatter lands tile r on rank r, bitwise
    the flat reduce-scatter's."""
    d = inputs()
    for r, w in enumerate(world):
        assert w["groups_topo"] == ("groups", 2, 2,
                                    (r // 2 * 2, r // 2 * 2 + 1),
                                    (r % 2, r % 2 + 2))
    np.testing.assert_array_equal(
        _ranks(world, "groups_ar"),
        np.broadcast_to(d["iv_odd"].sum(0), (N, 4097)))
    for got, g in zip(_ranks(world, "groups_int"), d["int"]):
        np.testing.assert_array_equal(got, np.broadcast_to(
            g.sum(0) / N, got.shape))
    for got, g in zip(_ranks(world, "groups"), d["steps"][0]):
        _assert_sum_close(got, g.mean(0), g)
    flat_tiles = _ranks(world, "rs_flat")
    np.testing.assert_array_equal(
        flat_tiles, d["iv_rs"].sum(0).reshape(N, -1))
    np.testing.assert_array_equal(_ranks(world, "groups_rs"), flat_tiles)


# -- quantized -------------------------------------------------------------------

def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


def _assert_bf16_mean(got, parts, ref=None):
    """``got`` (the mean over ranks of a bf16 sum) against the f32 mean of
    the bf16-rounded ``parts`` (rank axis first): within (n − 1) roundings
    of 2^-8 of Σ|x| each (module docstring), and f32's own rounding; and
    against another implementation's ``ref`` within twice that."""
    b = _bf16(parts)
    exact = b.sum(0) / N
    bound = (N - 1) * 2.0 ** -8 * np.abs(b).sum(0) / N \
        + 1e-6 * np.abs(exact)
    assert np.all(np.abs(got - exact) <= bound)
    if ref is not None:
        assert np.all(np.abs(got - ref) <= 2 * bound)


#: the buckets of SHAPES at BUCKET bytes (leaf indices)
BUCKETS = [[0, 1], [2, 3]]


def _bucketed(leaves):
    """Per-rank leaves (rank axis first) → their flat buckets."""
    return [np.concatenate([leaves[i].reshape(N, -1) for i in b], 1)
            for b in BUCKETS]


def _leafwise(buckets):
    """Flat buckets (rank axis first) → the leaves they hold."""
    out = []
    for b, flat in zip(BUCKETS, buckets):
        off = 0
        for i in b:
            k = int(np.prod(SHAPES[i]))
            out.append(flat[:, off:off + k].reshape(N, *SHAPES[i]))
            off += k
    return out


def _assert_residuals(got, want, quantized):
    """Within 2^-23 of the value quantized (module docstring)."""
    for g, w, v in zip(got, want, quantized):
        assert np.all(np.abs(g - w) <= 2.0 ** -23 * np.abs(v)), \
            np.abs(g - w).max()


@pytest.mark.parametrize("mode", MODES)
def test_quantized_with_error_feedback_matches_jax(world, jcomm, mode):
    """Two steps of ``QuantizedReducer(mode, ef=True)`` with 3000-byte
    buckets (two buckets, neither a whole number of blocks): each step
    against JAX's reducer in ``shard_map`` given the same residuals (zero,
    then the port's first), in the module docstring's tolerances; one
    stateless step; the plain reduce-scatter hook refuses an ef
    reducer."""
    d = inputs()
    red = JQuant(jcomm, mode=mode, bucket_bytes=BUCKET)
    port = _ranks(world, "q_" + mode)
    state = [np.zeros_like(b) for b in _bucketed(d["steps"][0])]
    for step, tree in enumerate(d["steps"]):
        want, want_state = _jax_reduce(jcomm, red, tree, tuple(state))
        got, got_state, _ = port[step]
        quantized = [t + e for t, e in zip(tree, _leafwise(state))]
        for g, w, v in zip(got, want, quantized):
            if mode == "bf16":
                _assert_bf16_mean(g, v, w)
            else:
                np.testing.assert_array_equal(g, w)
        _assert_residuals(got_state, want_state, _bucketed(quantized))
        state = got_state
    noef = _jax_reduce(jcomm, JQuant(jcomm, mode=mode, ef=False,
                                     bucket_bytes=BUCKET), d["steps"][0])[0]
    for g, w, t in zip(_ranks(world, "q_noef_" + mode), noef,
                       d["steps"][0]):
        if mode == "bf16":
            _assert_bf16_mean(g, t, w)
        else:
            np.testing.assert_array_equal(g, w)
    assert all(w["rs_refused_" + mode] for w in world)


@pytest.mark.parametrize("mode", MODES)
def test_quantized_reduce_scatter_hooks_match_jax(world, jcomm, mode):
    """The ZeRO hooks on a 2048-long vector: ``reduce_scatter_flat``
    (ef=False) and ``reduce_scatter_flat_ef`` (zero residual) against
    JAX's: rank r holds tile r."""
    d = inputs()
    jr = JQuant(jcomm, mode=mode, ef=False)
    jre = JQuant(jcomm, mode=mode, ef=True)
    tiles = _smap(jcomm, lambda v: jr.reduce_scatter_flat(v, "r", N),
                  d["zv"])
    tiles_ef, resid = _smap(jcomm, lambda v: jre.reduce_scatter_flat_ef(
        v, jnp.zeros_like(v), "r", N), d["zv"])
    got_tiles, got_resid = _ranks(world, "rs_ef_" + mode)
    if mode == "bf16":
        # parts[i][r] = rank i's slice for tile r
        parts = d["zv"].reshape(N, N, -1)
        _assert_bf16_mean(_ranks(world, "rs_" + mode), parts, tiles)
        _assert_bf16_mean(got_tiles, parts, tiles_ef)
    else:
        np.testing.assert_array_equal(_ranks(world, "rs_" + mode), tiles)
        np.testing.assert_array_equal(got_tiles, tiles_ef)
    _assert_residuals([got_resid], [resid], [d["zv"]])


@pytest.mark.parametrize("mode", MODES)
def test_wire_bytes_equal_the_bytes_at_the_collectives(world, mode):
    """Each step's bytes handed to the collectives (the communicator's
    ``collective_bytes``) equal the plan's ``wire_bytes``: int32 codes
    and the block maxima for the integer formats (queue 3 of ROADMAP.md:
    JAX counts 1 or 0.5 B), half the payload for bf16; the flat
    reducers' equal their payload."""
    payload = sum(4 * int(np.prod(s)) for s in SHAPES)
    for w in world:
        wire = w["q_wire_" + mode]
        assert [s[2] for s in w["q_" + mode]] == [wire, wire]
        if mode == "bf16":
            assert wire == payload // 2
        else:
            assert wire > payload
        for name in ("flat", "flat_b"):
            assert w[name + "_wire"] == (payload, payload)
        assert w["auto_lossy"][1] == w["auto_lossy"][2]


# -- auto ------------------------------------------------------------------------

def test_auto_choices_match_jax_except_the_int_wire(world, jcomm):
    """``AutoReducer.choose`` over JAX's size sweep (256 B to 64 MiB),
    with JAX's cost parameters, on the 4-rank world as 2 x 2 and as one
    tier of 4: the choices equal JAX's with ``lossy=False`` and with the
    bf16 wire; with ``lossy=True`` and an integer wire the port prices
    the int32 codes it sends, so it never picks the quantized candidate
    where JAX (pricing 1 or 0.5 B an element) picks it for large
    buckets. Every rank chooses alike."""
    for w in world[1:]:
        assert w["auto_choices"] == world[0]["auto_choices"]
    port = world[0]["auto_choices"]
    differs = 0
    for intra in (2, 4):
        for lossy in (False, True):
            for wf in MODES:
                jr = JAuto(jcomm, intra=intra, lossy=lossy, wire_format=wf)
                want = [jr.choose(b) for b in SWEEP]
                got = port[f"{intra}/{lossy}/{wf}"]
                if not lossy or wf == "bf16":
                    assert got == want, (intra, lossy, wf)
                else:
                    assert "quantized" not in got
                    assert [s if s != "quantized" else None for s in want
                            ] == [s if w != "quantized" else None
                                  for s, w in zip(got, want)]
                    differs += got != want
    assert differs == 6


def test_auto_reduces_like_flat_and_quantizes_when_lossy(world, jcomm):
    """``auto`` (lossy off) gives the flat result (1e-6); with
    ``lossy=True`` and a model that makes quantizing pay, every bucket is
    ``auto:quantized`` and equals JAX's bf16 quantized all-reduce within
    its bound. The CPU's measurement is the honest null ``{}``."""
    d = inputs()
    for got, g in zip(_ranks(world, "auto"), d["steps"][0]):
        _assert_sum_close(got, g.mean(0), g)
    assert world[0]["auto_lossy_plan"] == ["auto:quantized"] * 2
    want = _jax_reduce(jcomm, JQuant(jcomm, mode="bf16", ef=False,
                                     bucket_bytes=BUCKET), d["steps"][0])[0]
    got = jax.tree_util.tree_map(lambda *a: np.stack(a),
                                 *[w["auto_lossy"][0] for w in world])
    for g, w, t in zip(got, want, d["steps"][0]):
        _assert_bf16_mean(g, t, w)
    assert all(w["measured"] == {} for w in world)


# -- in one process ----------------------------------------------------------------

@pytest.fixture(scope="module")
def comm():
    from chainermn_torch.comm import create_communicator

    c = create_communicator("pure_nccl", device="cpu")
    yield c
    c.finalize()


def test_registry_and_refusals(comm, tmp_path):
    """The registry, the wire-format refusals of ``make_grad_reducer`` and
    ``create_multi_node_optimizer`` (JAX's rules), and the tuner's entry
    points on a DB with no entry: ``tune=`` is refused, ``synth`` needs a
    program, ``AutoReducer(profile=)`` reads nothing and
    ``measure_strategies(db=)`` on the CPU writes nothing."""
    from chainermn_torch.collectives import (REDUCERS, AutoReducer,
                                             FlatReducer, QuantizedReducer,
                                             make_grad_reducer,
                                             measure_strategies)
    from chainermn_torch.models import MLP
    from chainermn_torch.optimizers import create_multi_node_optimizer

    assert set(REDUCERS) >= {"flat", "hierarchical", "quantized", "auto"}
    assert make_grad_reducer(None, comm) is None
    inst = FlatReducer(comm)
    assert make_grad_reducer(inst, comm) is inst
    with pytest.raises(ValueError, match="hierarchical.*quantized"):
        make_grad_reducer("pure_nccl", comm)
    with pytest.raises(ValueError, match="op"):
        FlatReducer(comm, op="max")
    with pytest.raises(ValueError, match="uncompressed f32"):
        make_grad_reducer("hierarchical", comm, wire_format="int8")
    with pytest.raises(ValueError, match="unknown wire_format"):
        make_grad_reducer("quantized", comm, wire_format="fp8")
    with pytest.raises(ValueError, match="use the 'flat' strategy"):
        QuantizedReducer(comm, wire_format="f32")
    assert make_grad_reducer("quantized", comm,
                             wire_format="int4-block").mode == "int4-block"
    assert make_grad_reducer("flat", comm, wire_format="f32").name == "flat"
    model = MLP(n_units=4, device="cpu")
    sgd = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(ValueError, match="compressing"):
        create_multi_node_optimizer(sgd, comm, wire_format="bf16")
    opt = create_multi_node_optimizer(sgd, comm, grad_reducer="quantized",
                                      wire_format="int8")
    assert opt.grad_reducer.mode == "int8" and opt.plan is None
    empty = str(tmp_path / "empty.json")
    with pytest.raises(ValueError, match="no tuned schedule"):
        create_multi_node_optimizer(sgd, comm, tune=empty)
    for kw in ({"model_key": "m"}, {"topology": object()}):
        assert create_multi_node_optimizer(sgd, comm, **kw).plan is None
    assert "synth" in REDUCERS
    with pytest.raises(ValueError, match="program="):
        make_grad_reducer("synth", comm)
    assert AutoReducer(comm, profile=empty).measured == {}
    assert measure_strategies(comm, db=empty) == {}
    assert not (tmp_path / "empty.json").exists()


def test_plans_and_report(comm, capsys):
    """Plans account for every byte, one line a bucket; ``ReductionReport``
    prints them once and puts the totals in the observation."""
    from chainermn_torch.collectives import make_grad_reducer
    from chainermn_torch.models import MLP
    from chainermn_torch.training import ReductionReport

    model = MLP(n_units=32, device="cpu")
    total = sum(p.numel() * 4 for p in model.parameters())
    for name in ("flat", "hierarchical", "quantized", "auto"):
        red = make_grad_reducer(name, comm, bucket_bytes=40_000)
        rows = red.plan(model)
        assert sum(r["bytes"] for r in rows) == total
        assert len(red.describe(model).splitlines()) == len(rows) > 1
        assert all(r["algorithm"].endswith(name) or name == "auto"
                   for r in rows)
    red = make_grad_reducer("quantized", comm, wire_format="int8-block")
    rep = ReductionReport(red, model)

    class T:
        observation = {}

    rep(T)
    rep(T)
    assert capsys.readouterr().out.count("bucket") == len(rep.rows)
    assert T.observation["comm/strategy"] == "quantized"
    assert T.observation["comm/bytes"] == total
    assert T.observation["comm/wire_bytes"] == rep.total_wire_bytes
    assert 1.0 < T.observation["comm/wire_compression"] < 1.02


def test_optimizer_reduces_first_then_lags(comm):
    """``create_multi_node_optimizer(double_buffering=True)`` with a
    stateful reducer (bf16, error feedback) on a world of one: step 1
    applies zeros but reduces (its residual is g1 − bf16(g1)), step 2
    applies step 1's reduced gradient bf16(g1), which JAX's wrapper does
    too (the reduction first, the lag after it); the state dict carries
    the residuals beside the double buffer and loads back."""
    from chainermn_torch.optimizers import create_multi_node_optimizer

    rs = np.random.RandomState(3)
    w0, g1, g2 = (torch.tensor(rs.randn(5, 7).astype(np.float32))
                  for _ in range(3))
    w = torch.nn.Parameter(w0.clone())
    opt = create_multi_node_optimizer(
        torch.optim.SGD([w], lr=1.0), comm, double_buffering=True,
        grad_reducer="quantized", wire_format="bf16")
    assert opt.grad_reducer.stateful
    w.grad = g1.clone()
    opt.step()
    assert torch.equal(w.detach(), w0)
    (res,) = opt.reducer_state
    assert torch.equal(res, (g1 - g1.bfloat16().float()).reshape(-1))
    w.grad = g2.clone()
    opt.step()
    assert torch.equal(w.detach(), w0 - g1.bfloat16().float())
    sd = opt.state_dict()
    assert set(sd) == {"optimizer", "prev", "schedules", "reducer"}
    opt.reducer_state = (torch.zeros_like(res),)
    opt.load_state_dict(sd)
    assert torch.equal(opt.reducer_state[0], sd["reducer"][0])
