"""The port's heterogeneous pipeline (``chainermn_torch.parallel``
``HeteroPipeline``, ``hetero_pipeline_1f1b_value_and_grad``,
``hetero_pipeline_apply``, and ``MultiNodeChainList.to_hetero_pipeline``)
against the JAX package's.

An LM-shaped chain, embed → block → block → head (int tokens →
``[mb, L, D]`` → ``[mb, L, vocab]`` logits), each an ORDINARY stage with
its own parameter structure, and a float chain of three stage kinds and
uneven widths. One 4-rank gloo world (``run_world``) runs every step;
each rank builds the pipeline from the same numpy-seeded parameters and
packs only its own row. JAX runs the same stages under ``shard_map`` on 4
of the 8 CPU devices.

Tolerances: losses rtol 1e-5, forwards rtol 1e-5 / atol 1e-6, per-stage
gradients rtol 2e-4 / atol 1e-6 (3e-4 for the float chain), JAX's own
hetero tests' bars; the codec, the packed rows and ``wire_elems`` are
equal exactly; refusal texts are equal as strings, with JAX's
``jnp.float32`` named ``torch.float32`` in the port's.
"""

import pickle
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu.parallel import (HeteroPipeline as JPipe,
                                    hetero_pipeline_1f1b_value_and_grad as
                                    j_step, hetero_pipeline_apply as j_apply)
from chainermn_torch.parallel import HeteroPipeline
from tests.test_torch_mp import assert_ranks_ok, run_world

V, D, L, MB, S = 64, 16, 8, 2, 4


def _params(seed=0):
    rs = np.random.RandomState(seed)

    def f32(*shape, scale=0.1):
        return (rs.randn(*shape) * scale).astype(np.float32)

    embed = {"emb": f32(V, D, scale=0.5), "pos": f32(L, D)}
    blocks = [{"mix": f32(L, L), "w1": f32(D, 2 * D), "w2": f32(2 * D, D)}
              for _ in range(2)]
    return [embed, *blocks, {"w": f32(D, V, scale=0.2)}]


# the float chain: (kind, d_in, d_out) a stage, as JAX's fuzz test builds
FLOAT = [(0, 4, 12), (1, 12, 8), (2, 8, 16), (0, 16, 12)]


def _float_params(seed=7):
    rs = np.random.RandomState(seed)
    out = []
    for kind, din, dout in FLOAT:
        a = (rs.randn(din, dout) * 0.3).astype(np.float32)
        b = (rs.randn(din, dout) * 0.3).astype(np.float32)
        if kind == 0:
            out.append({"w": a, "b": (rs.randn(dout) * 0.1).astype(
                np.float32)})
        elif kind == 1:
            out.append({"a": a, "g": b})
        else:
            out.append({"m": [a, {"s": (rs.rand(dout) + 0.5).astype(
                np.float32)}]})
    return out


def _data(m, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, V, size=(m, MB, L)).astype(np.int32),
            rs.randint(0, V, size=(m, MB, L)).astype(np.int32))


def _float_data(m, seed=2):
    rs = np.random.RandomState(seed)
    return ((rs.randn(m, MB, FLOAT[0][1]) * 0.5).astype(np.float32),
            (rs.randn(m, MB, FLOAT[-1][2]) * 0.5).astype(np.float32))


# ---- the JAX side -------------------------------------------------------

def _j_embed(p, tok):
    return p["emb"][tok] + p["pos"][None, :, :]


def _j_norm(h):
    return (h - h.mean(-1, keepdims=True)) / jnp.sqrt(
        h.var(-1, keepdims=True) + 1e-5)


def _j_block(p, h):
    h = h + jnp.einsum("blq,qk->blk", _j_norm(h).swapaxes(1, 2),
                       p["mix"]).swapaxes(1, 2)
    return h + jnp.tanh(_j_norm(h) @ p["w1"]) @ p["w2"]


def _j_head(p, h):
    return h @ p["w"]


def _j_loss(logits, tgt):
    lse = jax.nn.logsumexp(logits, axis=-1)
    picked = jnp.take_along_axis(logits, tgt[..., None], axis=-1)[..., 0]
    return jnp.mean(lse - picked)


def _j_mse(out, tgt):
    return jnp.mean((out - tgt) ** 2)


_J_KINDS = [lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
            lambda p, h: (h @ p["a"]) * jax.nn.sigmoid(h @ p["g"]),
            lambda p, h: (h @ p["m"][0]) * p["m"][1]["s"]]


def _j_defs(params):
    fns = [_j_embed, _j_block, _j_block, _j_head]
    return [(f, jax.tree_util.tree_map(jnp.asarray, p))
            for f, p in zip(fns, params)]


def _j_float_defs(params):
    return [(_J_KINDS[k], jax.tree_util.tree_map(jnp.asarray, p))
            for (k, _, _), p in zip(FLOAT, params)]


def _mesh():
    return Mesh(np.asarray(jax.devices()[:S]), ("stage",))


def _jax_step(pipe, loss_fn, xs, ys):
    def run(stacked, xw, ys):
        my = jax.tree_util.tree_map(lambda l: l[0], stacked)
        loss, g = j_step(pipe, loss_fn, my, xw, ys)
        return loss, g[None]

    loss, flat = jax.jit(shard_map(
        run, mesh=_mesh(), in_specs=(P("stage"), P(), P()),
        out_specs=(P(), P("stage"))))(pipe.pack_params(),
                                      pipe.encode_inputs(xs), ys)
    return float(loss), pipe.unpack_grads(flat)


def _jax_apply(pipe, xs):
    def run(stacked, xw):
        my = jax.tree_util.tree_map(lambda l: l[0], stacked)
        return j_apply(pipe, my, xw)

    return np.asarray(jax.jit(shard_map(
        run, mesh=_mesh(), in_specs=(P("stage"), P()), out_specs=P()))(
            pipe.pack_params(), pipe.encode_inputs(xs)))


# ---- the port's side ----------------------------------------------------

_STAGES = r'''
import numpy as np
import torch


def norm(h):
    return (h - h.mean(-1, keepdim=True)) / torch.sqrt(
        h.var(-1, keepdim=True, unbiased=False) + 1e-5)


def embed(p, tok):
    return p["emb"][tok.long()] + p["pos"][None, :, :]


def block(p, h):
    h = h + torch.einsum("blq,qk->blk", norm(h).transpose(1, 2),
                         p["mix"]).transpose(1, 2)
    return h + torch.tanh(norm(h) @ p["w1"]) @ p["w2"]


def head(p, h):
    return h @ p["w"]


def ce(logits, tgt):
    lse = torch.logsumexp(logits, -1)
    picked = logits.gather(-1, tgt.long()[..., None])[..., 0]
    return (lse - picked).mean()


def mse(out, tgt):
    return ((out - tgt) ** 2).mean()


KINDS = [lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
         lambda p, h: (h @ p["a"]) * torch.sigmoid(h @ p["g"]),
         lambda p, h: (h @ p["m"][0]) * p["m"][1]["s"]]


def tensors(tree):
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tensors(v) for v in tree]
    return torch.tensor(np.asarray(tree))


def lm_defs(params):
    return [(f, tensors(p)) for f, p in zip([embed, block, block, head],
                                            params)]


def float_defs(params, kinds):
    return [(KINDS[k], tensors(p)) for k, p in zip(kinds, params)]
'''

_WORKER = _STAGES + r'''
import os, pickle, sys
from torch import nn
from chainermn_torch.comm import create_communicator
from chainermn_torch.links import MultiNodeChainList
from chainermn_torch.parallel import (HeteroPipeline,
    hetero_pipeline_1f1b_value_and_grad, hetero_pipeline_apply)

out_dir = sys.argv[1]
with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
comm = create_communicator("pure_nccl", device="cpu")
r = comm.rank
t = lambda a: torch.tensor(np.asarray(a))
res = {}


def grads_of(pipe, g):
    tree = pipe.unpack_grads(g, r)
    return tensors_np(tree)


def tensors_np(tree):
    if isinstance(tree, dict):
        return {k: tensors_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tensors_np(v) for v in tree]
    return tree.detach().numpy()


sample = (inp["mb_shape"], torch.int64)
for hil in (True, False):
    pipe = HeteroPipeline(lm_defs(inp["params"]), sample, comm,
                          head_in_loss=hil)
    row = pipe.pack_params(r)
    for m in (4, 8):
        xs, ys = inp[("data", m)]
        loss, g = hetero_pipeline_1f1b_value_and_grad(
            pipe, ce, row, pipe.encode_inputs(t(xs).long()), t(ys))
        res[("lm", hil, m)] = (loss.item(), grads_of(pipe, g))
    xs, _ = inp[("data", 4)]
    res[("apply", hil)] = hetero_pipeline_apply(
        pipe, row, pipe.encode_inputs(t(xs).long())).numpy()

pipe = HeteroPipeline(float_defs(inp["float_params"], inp["kinds"]),
                      (inp["float_mb"], torch.float32), comm)
xs, ys = inp["float_data"]
loss, g = hetero_pipeline_1f1b_value_and_grad(
    pipe, mse, pipe.pack_params(r), pipe.encode_inputs(t(xs)), t(ys))
res["float"] = (loss.item(), grads_of(pipe, g))

# the chain list's lowering: Linear + tanh parts, this rank's own stage
# real and the others' read for their shapes only


class Part(nn.Module):
    def __init__(self, n_in, n_out):
        super().__init__()
        self.dense = nn.Linear(n_in, n_out)

    def forward(self, x):
        return torch.tanh(self.dense(x))


chain = MultiNodeChainList(comm)
widths = inp["chain_widths"]
for i, (w, b) in enumerate(inp["chain_params"]):
    part = Part(widths[i], widths[i + 1])
    with torch.no_grad():
        part.dense.weight.copy_(t(w).T)
        part.dense.bias.copy_(t(b))
    chain.add_link(part, rank=i, rank_in=None if i == 0 else i - 1,
                   rank_out=None if i == 3 else i + 1)
xs, ys = inp["chain_data"]
pipe = chain.to_hetero_pipeline(None, (inp["chain_mb"], torch.float32))
loss, g = hetero_pipeline_1f1b_value_and_grad(
    pipe, mse, pipe.pack_params(r), pipe.encode_inputs(t(xs)), t(ys))
res["chain"] = (loss.item(), grads_of(pipe, g), pipe.wire_elems)
with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
    pickle.dump(res, f)
comm.finalize()
print(f"RANK{r} OK", flush=True)
'''

CHAIN = [6, 10, 4, 8, 3]


def _chain_params(seed=5):
    rs = np.random.RandomState(seed)
    return [((rs.randn(a, b) * 0.4).astype(np.float32),
             (rs.randn(b) * 0.1).astype(np.float32))
            for a, b in zip(CHAIN[:-1], CHAIN[1:])]


def _chain_data(m=4, seed=6):
    rs = np.random.RandomState(seed)
    return (rs.randn(m, MB, CHAIN[0]).astype(np.float32),
            rs.randn(m, MB, CHAIN[-1]).astype(np.float32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("hetero")
    inp = {"params": _params(), "mb_shape": (MB, L),
           "float_params": _float_params(), "kinds": [k for k, _, _ in FLOAT],
           "float_mb": (MB, FLOAT[0][1]), "float_data": _float_data(8),
           "chain_widths": CHAIN, "chain_params": _chain_params(),
           "chain_data": _chain_data(), "chain_mb": (MB, CHAIN[0])}
    for m in (4, 8):
        inp[("data", m)] = _data(m)
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    assert_ranks_ok(run_world(_WORKER, S, timeout=300, args=[str(d)]))
    return [pickle.loads((d / f"rank{r}.pkl").read_bytes())
            for r in range(S)]


def _assert_tree(got, want, rtol, atol, msg):
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
            err_msg=msg), got, want)


@pytest.mark.parametrize("head_in_loss", [True, False])
@pytest.mark.parametrize("m", [4, 8])
def test_1f1b_matches_jax(world, head_in_loss, m):
    pipe = JPipe(_j_defs(_params()), jax.ShapeDtypeStruct((MB, L),
                                                          jnp.int32),
                 axis_name="stage", head_in_loss=head_in_loss)
    xs, ys = _data(m)
    loss, grads = _jax_step(pipe, _j_loss, xs, ys)
    for r, res in enumerate(world):
        got_loss, got = res[("lm", head_in_loss, m)]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        _assert_tree(got, grads[r], 2e-4, 1e-6, f"stage {r}")


@pytest.mark.parametrize("head_in_loss", [True, False])
def test_apply_matches_jax(world, head_in_loss):
    pipe = JPipe(_j_defs(_params()), jax.ShapeDtypeStruct((MB, L),
                                                          jnp.int32),
                 axis_name="stage", head_in_loss=head_in_loss)
    want = _jax_apply(pipe, _data(4)[0])
    for res in world:
        np.testing.assert_allclose(res[("apply", head_in_loss)], want,
                                   rtol=1e-5, atol=1e-6)


def test_float_chain_of_uneven_stages_matches_jax(world):
    pipe = JPipe(_j_float_defs(_float_params()), jax.ShapeDtypeStruct(
        (MB, FLOAT[0][1]), jnp.float32), axis_name="stage")
    xs, ys = _float_data(8)
    loss, grads = _jax_step(pipe, _j_mse, xs, ys)
    for r, res in enumerate(world):
        got_loss, got = res["float"]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        _assert_tree(got, grads[r], 3e-4, 1e-6, f"stage {r}")


def test_chain_list_lowering_matches_jax(world):
    """``to_hetero_pipeline`` on a linear chain of Linear + tanh parts:
    the loss and each stage's gradients equal JAX's lowering of the same
    stages (its kernels ``[in, out]``, the port's weights ``[out, in]``),
    the wire sized by the widest input edge."""
    params = [{"b": b, "w": w} for w, b in _chain_params()]
    pipe = JPipe([(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
                   jax.tree_util.tree_map(jnp.asarray, p)) for p in params],
                 jax.ShapeDtypeStruct((MB, CHAIN[0]), jnp.float32),
                 axis_name="stage")
    xs, ys = _chain_data()
    loss, grads = _jax_step(pipe, _j_mse, xs, ys)
    for r, res in enumerate(world):
        got_loss, got, wire = res["chain"]
        assert wire == pipe.wire_elems == MB * max(CHAIN[:-1])
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        np.testing.assert_allclose(got["dense.weight"].T,
                                   np.asarray(grads[r]["w"]), rtol=2e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(got["dense.bias"],
                                   np.asarray(grads[r]["b"]), rtol=2e-4,
                                   atol=1e-6)


# ---- the codec, in one process -----------------------------------------

def _stub(rank=0):
    return types.SimpleNamespace(rank=rank, size=S)


def _port_defs():
    ns = {}
    exec(_STAGES, ns)
    return ns["lm_defs"](_params()), ns


def test_wire_excludes_final_edge_and_packs_jaxs_rows():
    defs, _ = _port_defs()
    jdefs = _j_defs(_params())
    sample = (MB, L)
    for hil, want in ((True, MB * L * D), (False, MB * L * V)):
        pipe = HeteroPipeline(defs, (sample, torch.int64), _stub(),
                              head_in_loss=hil)
        jp = JPipe(jdefs, jax.ShapeDtypeStruct(sample, jnp.int32),
                   axis_name="stage", head_in_loss=hil)
        assert pipe.head_in_loss == jp.head_in_loss == hil
        assert pipe.wire_elems == jp.wire_elems == want
        assert pipe.wire_dtype == torch.float32
        assert pipe.param_elems == jp.param_elems
        stack = np.asarray(jp.pack_params())
        np.testing.assert_array_equal(pipe.pack_params().numpy(), stack)
        for s in range(S):
            np.testing.assert_array_equal(pipe.pack_params(s).numpy(),
                                          stack[s])
        assert [tuple(a.shape) for a in pipe.out_avals] == [
            tuple(a.shape) for a in jp.out_avals]


def test_codec_roundtrip_matches_jax():
    defs, _ = _port_defs()
    pipe = HeteroPipeline(defs, (((MB, L)), torch.int64), _stub())
    tok = np.random.RandomState(0).randint(0, V, size=(MB, L))
    back = pipe.decode_act(pipe.encode_act(torch.tensor(tok)),
                           pipe.in_avals[0])
    np.testing.assert_array_equal(back.numpy(), tok)
    # tokens ride an f32 wire exactly below 2^24
    big = torch.tensor([2 ** 24 - 1, 2 ** 23 + 1])
    np.testing.assert_array_equal(
        pipe.decode_act(pipe.encode_act(big), big).numpy(), big.numpy())
    # params round-trip through the row
    p0 = pipe._unflatten(0, pipe.pack_params(0))
    for k in p0:
        np.testing.assert_array_equal(p0[k].numpy(), _params()[0][k])
    # an f32 activation crossing a bf16 wire is rounded as JAX rounds it
    h = np.random.RandomState(1).randn(MB, L, D).astype(np.float32)
    bf = HeteroPipeline([(defs[1][0], defs[1][1]), (defs[2][0], defs[2][1])],
                        (h.shape, torch.float32), _stub(),
                        wire_dtype=torch.bfloat16)
    jbf = JPipe([(_j_block, jax.tree_util.tree_map(jnp.asarray, p))
                 for p in _params()[1:3]],
                jax.ShapeDtypeStruct(h.shape, jnp.float32),
                axis_name="stage", wire_dtype=jnp.bfloat16)
    got = bf.decode_act(bf.encode_act(torch.tensor(h)), bf.in_avals[0])
    want = jbf.decode_act(jbf.encode_act(jnp.asarray(h)), jbf.in_avals[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), h)


def _jax_text(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_validation_texts_match_jax():
    defs, ns = _port_defs()
    jdefs = _j_defs(_params())
    jsample = jax.ShapeDtypeStruct((MB, L), jnp.int32)
    cases = [
        (lambda: JPipe(jdefs, jsample, "stage", wire_dtype=jnp.bfloat16),
         lambda: HeteroPipeline(defs, ((MB, L), torch.int64), _stub(),
                                wire_dtype=torch.bfloat16)),
        (lambda: JPipe(jdefs[:1], jsample, "stage", head_in_loss=True),
         lambda: HeteroPipeline(defs[:1], ((MB, L), torch.int64), _stub(),
                                head_in_loss=True)),
        (lambda: JPipe([], jsample, "stage"),
         lambda: HeteroPipeline([], ((MB, L), torch.int64), _stub())),
        (lambda: JPipe([(jdefs[0][0], {**jdefs[0][1], "n": jnp.zeros(
            3, jnp.int32)})] + jdefs[1:], jsample, "stage"),
         lambda: HeteroPipeline([(defs[0][0], {**defs[0][1], "n": torch.zeros(
             3, dtype=torch.int32)})] + defs[1:], ((MB, L), torch.int64),
             _stub())),
    ]
    for jax_fn, port_fn in cases:
        want = _jax_text(jax_fn).replace("jnp.float32", "torch.float32")
        with pytest.raises(ValueError) as err:
            port_fn()
        assert str(err.value) == want
    # a declared int_bound below the bf16 mantissa bound is accepted
    pipe = HeteroPipeline(defs, ((MB, L), torch.int64), _stub(),
                          wire_dtype=torch.bfloat16, int_bound=2 ** 8)
    assert pipe.wire_dtype == torch.bfloat16


def test_stage_count_must_match_the_communicator():
    defs, ns = _port_defs()
    pipe = HeteroPipeline(defs, ((MB, L), torch.int64),
                          types.SimpleNamespace(rank=0, size=8))
    from chainermn_torch.parallel import hetero_pipeline_1f1b_value_and_grad
    xs, ys = _data(4)
    with pytest.raises(ValueError, match="stages"):
        hetero_pipeline_1f1b_value_and_grad(
            pipe, ns["ce"], pipe.pack_params(0),
            pipe.encode_inputs(torch.tensor(xs).long()), torch.tensor(ys))
