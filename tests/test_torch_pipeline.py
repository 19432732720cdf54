"""The port's micro-batched pipelines (``chainermn_torch.parallel``
``pipeline_apply``, ``pipeline_1f1b_value_and_grad``,
``pipeline_interleaved_1f1b_value_and_grad``,
``build_interleaved_schedule``) against the JAX package's.

One 4-rank gloo world (``run_world``) runs every case: the whole world
as a 4-stage communicator, ``split(("block", 2))`` for two 2-stage
pipelines side by side (S = 2: one peer is both the next and the
previous stage), and ``split(("block", 1))`` for the one-stage
degenerate case. Each rank holds only its own stage's (or chunks')
parameters, cut from the numpy-seeded stack that JAX's ``shard_map``
takes whole; the JAX side runs on as many of the 8 CPU devices.

Tolerances: forwards rtol 1e-5 / atol 1e-6 and losses rtol 1e-5 (JAX's
pipeline tests' own); gradients, head gradients and input gradients rtol
2e-4 / atol 1e-6 (JAX's interleaved tests' own: the same f32 products
summed in another order). Schedule tables, ``T`` and depths are equal
exactly; refusal texts are equal as strings.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu.parallel import pipeline as jpipe
from chainermn_torch.parallel import pipeline as tpipe
from tests.test_torch_mp import assert_ranks_ok, run_world

DIM, MB, VOCAB = 8, 2, 12
# (S, V, M) of the interleaved cases; V = 1 is the classic schedule
INTERLEAVED = [(4, 2, 4), (4, 3, 8), (2, 2, 4), (2, 3, 6), (4, 1, 8)]
PLAIN_M = [2, 8]     # m < S exercises the bubble; m > 2(S-1) slot reuse


def _full(n, seed):
    rs = np.random.RandomState(seed)
    return {"w": (rs.randn(n, DIM, DIM) * 0.5).astype(np.float32),
            "b": (rs.randn(n, DIM) * 0.1).astype(np.float32)}


def _inputs():
    rs = np.random.RandomState(0)
    out = {"apply": (_full(4, 1), rs.randn(4, 3, DIM).astype(np.float32))}
    for m in PLAIN_M:
        out[("plain", m)] = (_full(4, 2 + m),
                             rs.randn(m, MB, DIM).astype(np.float32),
                             rs.randn(m, MB, DIM).astype(np.float32))
    for S, V, M in INTERLEAVED:
        out[("inter", S, V, M)] = (
            _full(S * V, S * 10 + V),
            rs.randn(M, MB, DIM).astype(np.float32),
            rs.randint(0, VOCAB, (M, MB)).astype(np.int32),
            (rs.randn(DIM, VOCAB) * 0.3).astype(np.float32))
    out["single"] = (_full(1, 3), rs.randn(4, MB, DIM).astype(np.float32),
                     rs.randn(4, MB, DIM).astype(np.float32))
    out["nan"] = ({"w": (rs.randn(4, DIM, DIM) * 0.3).astype(np.float32)},
                  (1.0 + rs.rand(4, 2, DIM)).astype(np.float32),
                  rs.randn(4, 2, DIM).astype(np.float32))
    return out


_WORKER = r'''
import os, pickle, sys
import numpy as np
import torch
from chainermn_torch.comm import create_communicator
from chainermn_torch.parallel import (pipeline_1f1b_value_and_grad,
    pipeline_apply, pipeline_interleaved_1f1b_value_and_grad)

out_dir = sys.argv[1]
with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
world = create_communicator("pure_nccl", device="cpu")
pairs = world.split(("block", 2))
solo = world.split(("block", 1))
r = world.rank
t = lambda a: torch.tensor(np.asarray(a))
res = {}


def stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def mse(out, tgt):
    return ((out - tgt) ** 2).mean()


def head_loss(hp, out, tgt):
    lp = torch.log_softmax(out @ hp["w"], -1)
    return -lp.gather(-1, tgt.long()[..., None]).squeeze(-1).mean()


def rows(full, idx):
    return {k: t(v[idx]) for k, v in full.items()}


def np_tree(tree):
    return {k: v.numpy() for k, v in tree.items()}


full, x = inp["apply"]
res["apply"] = pipeline_apply(stage, rows(full, r), t(x), world).numpy()

for m in inp["plain_m"]:
    full, x, y = inp[("plain", m)]
    loss, g = pipeline_1f1b_value_and_grad(stage, mse, rows(full, r), t(x),
                                           t(y), world)
    res[("plain", m)] = (loss.item(), np_tree(g))

for S, V, M in inp["interleaved"]:
    comm = world if S == 4 else pairs
    full, x, y, hw = inp[("inter", S, V, M)]
    d = comm.rank
    mine = rows(full, [v * S + d for v in range(V)])
    loss, g, aux = pipeline_interleaved_1f1b_value_and_grad(
        stage, head_loss, mine, t(x), t(y), comm, V,
        head_params={"w": t(hw)}, return_input_grads=True)
    res[("inter", S, V, M)] = (loss.item(), np_tree(g),
                              aux["head_grads"]["w"].numpy(),
                              aux["input_grads"].numpy())
    if V == 1:
        # the classic 1F1B with the same hooks, its chunk unstacked
        loss, g, aux = pipeline_1f1b_value_and_grad(
            stage, head_loss, {k: v[0] for k, v in mine.items()}, t(x),
            t(y), comm, head_params={"w": t(hw)}, return_input_grads=True)
        res[("classic", S, M)] = (loss.item(), np_tree(g),
                                  aux["head_grads"]["w"].numpy(),
                                  aux["input_grads"].numpy())

full, x, y = inp["single"]
loss, g = pipeline_1f1b_value_and_grad(stage, mse, rows(full, 0), t(x),
                                       t(y), solo)
res["single"] = (loss.item(), np_tree(g))


def nan_stage(p, h):
    return (h @ p["w"]) / torch.sqrt((h ** 2).mean())


full, x, y = inp["nan"]
d = pairs.rank
loss, g = pipeline_interleaved_1f1b_value_and_grad(
    nan_stage, mse, {"w": t(full["w"][[d, 2 + d]])}, t(x), t(y), pairs, 2)
res["nan"] = (loss.item(), g["w"].numpy())

# a stage that changes the activation shape is refused on every rank
# before any message
try:
    pipeline_1f1b_value_and_grad(
        lambda p, h: h[..., :4] @ p["w"][:4, :4], mse, rows(full, r),
        t(x), t(y), world)
except ValueError as e:
    res["refusal"] = str(e)
with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
    pickle.dump(res, f)
solo.finalize()
pairs.finalize()
world.finalize()
print(f"RANK{r} OK", flush=True)
'''


def _mesh(S):
    return Mesh(np.array(jax.devices()[:S]), ("stage",))


def _stage(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def _mse(out, tgt):
    return jnp.mean((out - tgt) ** 2)


def _head_loss(hp, out, tgt):
    lp = jax.nn.log_softmax(out @ hp["w"])
    return -jnp.mean(jnp.take_along_axis(lp, tgt[..., None],
                                         -1).squeeze(-1))


def _jax_plain(full, x, y, S, loss_fn=_mse):
    def f(sp, x, y):
        my = jax.tree_util.tree_map(lambda l: l[0], sp)
        loss, g = jpipe.pipeline_1f1b_value_and_grad(
            _stage, loss_fn, my, x, y, "stage")
        return loss, jax.tree_util.tree_map(lambda q: q[None], g)

    return jax.jit(shard_map(f, mesh=_mesh(S), in_specs=(P("stage"), P(),
                                                          P()),
                             out_specs=(P(), P("stage"))))(full, x, y)


def _jax_interleaved(full, x, y, hw, S, V):
    arranged = jax.tree_util.tree_map(
        lambda p: p.reshape((V, S) + p.shape[1:]), full)

    def fn(sp, hp, xs, ys):
        sp = jax.tree_util.tree_map(lambda p: p.squeeze(1), sp)
        loss, g, aux = jpipe.pipeline_interleaved_1f1b_value_and_grad(
            _stage, _head_loss, sp, xs, ys, "stage", V,
            head_params=hp, return_input_grads=True)
        return (loss, jax.tree_util.tree_map(lambda p: p[:, None], g),
                aux["head_grads"], aux["input_grads"])

    return jax.jit(shard_map(
        fn, mesh=_mesh(S), in_specs=(P(None, "stage"), P(), P(), P()),
        out_specs=(P(), P(None, "stage"), P(), P())))(
            arranged, {"w": hw}, x, y)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs):
    d = tmp_path_factory.mktemp("pipe")
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(dict(inputs, plain_m=PLAIN_M, interleaved=INTERLEAVED),
                    f)
    assert_ranks_ok(run_world(_WORKER, 4, timeout=300, args=[str(d)]))
    return [pickle.loads((d / f"rank{r}.pkl").read_bytes())
            for r in range(4)]


def test_pipeline_apply_matches_jax(world, inputs):
    full, x = inputs["apply"]
    ax = "stage"

    def f(stacked, x):
        my = jax.tree_util.tree_map(lambda l: l[0], stacked)
        return jpipe.pipeline_apply(_stage, my, x, axis_name=ax)

    want = np.asarray(jax.jit(shard_map(
        f, mesh=_mesh(4), in_specs=(P(ax), P()), out_specs=P()))(full, x))
    for res in world:
        np.testing.assert_allclose(res["apply"], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", PLAIN_M)
def test_1f1b_matches_jax(world, inputs, m):
    full, x, y = inputs[("plain", m)]
    loss, grads = _jax_plain(full, x, y, 4)
    for r, res in enumerate(world):
        got_loss, got = res[("plain", m)]
        np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], np.asarray(grads[k])[r],
                                       rtol=2e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("S,V,M", INTERLEAVED)
def test_interleaved_1f1b_with_hooks_matches_jax(world, inputs, S, V, M):
    """The loss, every chunk's gradient, the head's gradient and the
    input cotangents, on every stage rank (two S = 2 pipelines run side
    by side in the world)."""
    full, x, y, hw = inputs[("inter", S, V, M)]
    loss, grads, hg, dx = _jax_interleaved(full, x, y, hw, S, V)
    for r, res in enumerate(world):
        d = r % S
        got_loss, got, got_hg, got_dx = res[("inter", S, V, M)]
        np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], np.asarray(grads[k])[:, d],
                                       rtol=2e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got_hg, np.asarray(hg["w"]), rtol=2e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(got_dx, np.asarray(dx), rtol=2e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("S,M", [(4, 8)])
def test_classic_1f1b_hooks_match_jax(world, inputs, S, M):
    """The plain schedule carries the same composition hooks; JAX's
    classic 1F1B is red there in its TP form only, so its plain form is
    the reference."""
    full, x, y, hw = inputs[("inter", S, 1, M)]

    def fn(sp, hp, xs, ys):
        my = jax.tree_util.tree_map(lambda l: l[0], sp)
        loss, g, aux = jpipe.pipeline_1f1b_value_and_grad(
            _stage, _head_loss, my, xs, ys, "stage", head_params=hp,
            return_input_grads=True)
        return (loss, jax.tree_util.tree_map(lambda q: q[None], g),
                aux["head_grads"], aux["input_grads"])

    loss, grads, hg, dx = jax.jit(shard_map(
        fn, mesh=_mesh(S), in_specs=(P("stage"), P(), P(), P()),
        out_specs=(P(), P("stage"), P(), P())))(full, {"w": hw}, x, y)
    for r, res in enumerate(world):
        got_loss, got, got_hg, got_dx = res[("classic", S, M)]
        np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], np.asarray(grads[k])[r],
                                       rtol=2e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got_hg, np.asarray(hg["w"]), rtol=2e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(got_dx, np.asarray(dx), rtol=2e-4,
                                   atol=1e-6)


def test_single_stage_degenerates(world, inputs):
    """One stage rank: plain gradient accumulation, no exchange."""
    full, x, y = inputs["single"]
    loss, grads = _jax_plain(full, x, y, 1)
    for res in world:
        got_loss, got = res["single"]
        np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], np.asarray(grads[k])[0],
                                       rtol=2e-4, atol=1e-6)


def test_nan_prone_stage_stays_finite(world):
    """A stage whose gradient is not finite at a zero input (a norm
    without eps): JAX masks its bubble ticks with ``where``; the port
    never computes on them."""
    for res in world:
        loss, g = res["nan"]
        assert np.isfinite(loss) and np.isfinite(g).all()


def test_shape_changing_stage_refused_with_jaxs_text(world, inputs):
    full, x, y = inputs["nan"]

    def f(sp, x, y):
        my = jax.tree_util.tree_map(lambda l: l[0], sp)
        return jpipe.pipeline_1f1b_value_and_grad(
            lambda p, h: h[..., :4] @ p["w"][:4, :4], _mse, my, x, y,
            "stage")[0]

    with pytest.raises(ValueError) as err:
        shard_map(f, mesh=_mesh(4), in_specs=(P("stage"), P(), P()),
                  out_specs=P())(full, x, y)
    for res in world:
        assert res["refusal"] == str(err.value)


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
def test_schedule_tables_equal_jaxs(S):
    for V in (1, 2, 3, 4):
        for M in (S, 2 * S, 3 * S):
            want = jpipe.build_interleaved_schedule(S, V, M)
            got = tpipe.build_interleaved_schedule(S, V, M)
            assert got._fields == want._fields
            for name in want._fields:
                a, b = getattr(got, name), getattr(want, name)
                if isinstance(b, np.ndarray):
                    np.testing.assert_array_equal(a, b, err_msg=name)
                else:
                    assert a == b, (S, V, M, name)


def test_schedule_refusals_carry_jaxs_texts():
    for args in ((4, 2, 6), (2, 0, 4)):
        with pytest.raises(ValueError) as want:
            jpipe.build_interleaved_schedule(*args)
        with pytest.raises(ValueError) as got:
            tpipe.build_interleaved_schedule(*args)
        assert str(got.value) == str(want.value)


def test_plain_schedule_is_the_classic_1f1b():
    """The classic schedule's own tables: T = 2(S-1) + M, every stage's
    forward and backward of each micro-batch exactly once, a transfer one
    tick after its producer, and each arrival consumed the tick it
    lands (inboxes of one slot)."""
    for S, M in ((1, 3), (2, 4), (4, 2), (4, 8)):
        sc = tpipe._plain_schedule(S, M)
        assert sc.T == 2 * (S - 1) + M
        assert (sc.f_valid.sum(1) == M).all()
        assert (sc.b_valid.sum(1) == M).all()
        np.testing.assert_array_equal(sc.fr_valid[1:], sc.f_valid[1:])
        np.testing.assert_array_equal(sc.br_valid[:-1], sc.b_valid[:-1])
        for s in range(1, S):
            np.testing.assert_array_equal(sc.fr_valid[s, 1:],
                                          sc.f_valid[s - 1, :-1])
        assert tpipe.schedule_idle_share(sc) == pytest.approx(
            1 - M / sc.T)
