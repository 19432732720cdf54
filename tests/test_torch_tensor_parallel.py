"""The port's Megatron tensor parallelism (``chainermn_torch.parallel``
column/row pair, ``TensorParallelMLP``, ``vocab_parallel_cross_entropy``;
the ``tp_axis`` block and the ``lm_head_tp`` LM with ``tp_lm_loss``)
against the JAX package's and against the port's dense model.

One 4-rank gloo world (``run_world``, TP = 4) runs every case and writes
each rank's results. The JAX trees come from ``shard_map`` inits on 4 of
the 8 CPU devices with ``out_specs=P("tp")`` (each leaf the ranks' leaves
concatenated on axis 0): the column- and row-parallel kernels drawn per
rank (``fold_in`` of the rank), every other leaf rank 0's (as
``init_expert_parallel_state`` replicates them); the port takes its
rank's slice through ``rank_params_from_flax``.

JAX's TP backward is red under jax 0.9 (its custom VJPs' cotangents are
typed invariant for inputs typed varying: ROADMAP.md queue 3), so the
port's TP gradients are held to independent oracles: the full-softmax
cross-entropy's gradient, the full matmul's, and the port's dense LM on
the weights gathered from the ranks (``dense_params_from_ranks``), whose
forward and gradients earlier slices hold to JAX's dense model. That is
where an all-reducing backward of the *g* operator (every gradient n
times too large) would show.

Tolerances: forwards against JAX rtol 2e-5 / atol 2e-5 (JAX's TP block
test); the column/row pair against the full matmul rtol 1e-5 / atol
1e-5; CE values rtol 1e-5 and gradients rtol 1e-4 / atol 1e-6 (JAX's
CE test); the TP LM's loss rtol 1e-5 and gradients rtol 1e-4 / atol
1e-6 against the dense LM (the same f32 sums split over four ranks);
replicated leaves bitwise equal after 3 Adam steps.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import pickle
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu.models.transformer import (TransformerBlock as JBlock,
                                               TransformerLM as JLM)
from chainermn_tpu.parallel import (TensorParallelMLP as JMLP,
                                    vocab_parallel_cross_entropy as j_vpce)
from chainermn_torch.models.transformer import (TransformerBlock,
                                                TransformerLM, tp_lm_loss)
from tests.test_torch_mp import assert_ranks_ok, run_world

N, B, L, D, H, FF, V = 4, 2, 16, 32, 4, 64, 32
LM = dict(vocab=V, d_model=D, n_heads=H, n_layers=2, d_ff=FF, max_len=L,
          pos_emb="rope")
LR, STEPS = 3e-3, 3


def _inputs():
    rs = np.random.RandomState(0)
    return dict(
        x=rs.randn(B, L, D).astype(np.float32),
        mlp_x=rs.randn(4, 8).astype(np.float32),
        pair=(rs.randn(5, 16).astype(np.float32),
              rs.randn(16, 6).astype(np.float32),
              rs.randn(3, 5).astype(np.float32)),
        logits=rs.randn(B, 8, 8 * N).astype(np.float32),
        targets=rs.randint(0, 8 * N, (B, 8)).astype(np.int32),
        toks=rs.randint(0, V, (B, L + 1)).astype(np.int32))


_WORKER = r'''
import hashlib, os, pickle, sys
import numpy as np
import torch
import torch.nn.functional as F
from chainermn_torch.comm import create_communicator
from chainermn_torch.models.convert import (block_param_map,
    dense_params_from_ranks, rank_params_from_flax)
from chainermn_torch.models.transformer import (TransformerBlock,
    TransformerLM, lm_loss_with_aux, tp_lm_loss)
from chainermn_torch.parallel import (ColumnParallelDense, RowParallelDense,
    TensorParallelMLP, vocab_parallel_cross_entropy)

out_dir = sys.argv[1]
with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
comm = create_communicator("pure_nccl", device="cpu")
r, n = comm.rank, comm.size
comms = {"tp": comm}
res = {}
t = lambda a: torch.tensor(np.asarray(a))


def cut(a):
    a = np.asarray(a)
    per = a.shape[0] // n
    return a[r * per:(r + 1) * per]


# the column/row pair against the full matmul, and the input's gradient
w1, w2, xp = inp["pair"]
col = ColumnParallelDense(5, 16, comm, use_bias=False, device="cpu")
row = RowParallelDense(16 // n, 6, comm, use_bias=False, device="cpu")
with torch.no_grad():
    col.dense.weight.copy_(t(w1).T.chunk(n)[r])
    row.dense.weight.copy_(t(w2).T.chunk(n, dim=1)[r])
xt = t(xp).requires_grad_(True)
y = row(torch.relu(col(xt)))
(y ** 2).sum().backward()
res["pair"] = (y.detach().numpy(), xt.grad.numpy())

# TensorParallelMLP from JAX's stacked tree
tree = inp["mlp_tree"]
mlp = TensorParallelMLP(8, 16, 8, comm, device="cpu")
with torch.no_grad():
    c = tree["ColumnParallelDense_0"]["Dense_0"]
    mlp.column.dense.weight.copy_(t(cut(c["kernel"])).T)
    mlp.column.dense.bias.copy_(t(cut(c["bias"])))
    rw = tree["RowParallelDense_0"]
    mlp.row.dense.weight.copy_(t(cut(rw["Dense_0"]["kernel"])).T)
    mlp.row.bias.copy_(t(cut(rw["bias"])))
    res["mlp"] = mlp(t(inp["mlp_x"])).numpy()

# the TP block from JAX's stacked tree
for attention in ("reference", "flash"):
    blk = TransformerBlock(inp["D"], inp["H"], inp["FF"], pos_emb="rope",
                           attention=attention, tp_axis="tp", comms=comms,
                           device="cpu")
    sd = {}
    for name, (path, perm) in block_param_map(blk).items():
        leaf = inp["block_tree"]
        for k in path:
            leaf = leaf[k]
        v = t(cut(leaf))
        sd[name] = v.permute(perm) if perm else v
    blk.load_state_dict(sd)
    with torch.no_grad():
        res[("block", attention)] = blk(t(inp["x"])).numpy()

# the vocabulary-parallel CE: value and this rank's logits' gradient
lg = t(inp["logits"]).chunk(n, dim=-1)[r].clone().requires_grad_(True)
ce = vocab_parallel_cross_entropy(lg, t(inp["targets"]), comm).mean()
ce.backward()
res["ce"] = (ce.item(), lg.grad.numpy())

# the lm_head_tp LM: forward against JAX, loss and gradients against the
# dense LM on the gathered weights, then Adam steps
toks = t(inp["toks"]).long()
x, y = toks[:, :-1], toks[:, 1:]
tp = TransformerLM(**inp["lm_cfg"], tp_axis="tp", lm_head_tp=True,
                   comms=comms, device="cpu")
tp.load_state_dict(rank_params_from_flax(tp, inp["lm_tree"], r, n))
with torch.no_grad():
    res["lm_logits"] = tp(x).numpy()
loss, (acc, _) = tp_lm_loss(tp, x, y)
loss.backward()
sds = comm.allgather_obj({k: v.detach().clone()
                          for k, v in tp.state_dict().items()})
gsd = comm.allgather_obj({k: p.grad.clone()
                          for k, p in tp.named_parameters()})
dense = TransformerLM(**inp["lm_cfg"], device="cpu")
dense.load_state_dict(dense_params_from_ranks(dense, sds))
dloss, (dacc, _) = lm_loss_with_aux(dense, x, y)
dloss.backward()
res["lm_loss"] = (loss.item(), acc.item(), dloss.item(), dacc.item())
res["lm_grads"] = (
    {k: v.numpy() for k, v in dense_params_from_ranks(dense, gsd).items()},
    {k: p.grad.numpy() for k, p in dense.named_parameters()})
opt = torch.optim.Adam(tp.parameters(), lr=inp["lr"], eps=1e-8)
losses = []
for _ in range(inp["steps"]):
    opt.zero_grad(set_to_none=True)
    loss, _ = tp_lm_loss(tp, x, y)
    loss.backward()
    opt.step()
    losses.append(loss.item())
res["adam"] = (losses, {k: hashlib.sha256(p.detach().numpy().tobytes())
                        .hexdigest() for k, p in tp.named_parameters()})
with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
    pickle.dump(res, f)
comm.finalize()
print(f"RANK{r} OK", flush=True)
'''


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:N]), ("tp",))


def _own(path) -> bool:
    """A column- or row-parallel layer's own kernel or bias (drawn per
    rank); every other leaf is replicated."""
    return "Dense_0" in [str(getattr(k, "key", k)) for k in path]


def _stacked_init(mesh, module, *args):
    """``module``'s params inited on each of the 4 ranks, its own leaves
    from the rank's ``fold_in`` key and the replicated ones rank 0's,
    stacked on axis 0 (``out_specs=P("tp")``)."""
    def init(*a):
        key = jax.random.fold_in(jax.random.PRNGKey(3),
                                 lax.axis_index("tp"))
        p = module.init(key, *a)["params"]
        return jax.tree_util.tree_map_with_path(
            lambda path, leaf: leaf if _own(path)
            else lax.all_gather(leaf, "tp")[0], p)

    tree = jax.jit(shard_map(init, mesh=mesh, in_specs=(P(),) * len(args),
                             out_specs=P("tp"), check_vma=False))(*args)
    return jax.tree_util.tree_map(np.asarray, tree)


def _apply(mesh, module, tree, *args, out_specs=P("tp")):
    """JAX's forward of ``module`` on the stacked tree, each rank's output
    stacked on a new axis 0."""
    def f(p, *a):
        return module.apply({"params": p}, *a)[None]

    return np.asarray(jax.jit(shard_map(
        f, mesh=mesh, in_specs=(P("tp"),) + (P(),) * len(args),
        out_specs=out_specs, check_vma=False))(tree, *args))


@pytest.fixture(scope="module")
def jax_side(mesh):
    inp = _inputs()
    x, mx = jnp.asarray(inp["x"]), jnp.asarray(inp["mlp_x"])
    toks = jnp.asarray(inp["toks"][:, :-1])
    mlp = JMLP(hidden=16, out=8, axis_name="tp")
    blocks = {a: JBlock(d_model=D, n_heads=H, d_ff=FF, pos_emb="rope",
                        attention=a, tp_axis="tp")
              for a in ("reference", "flash")}
    lm = JLM(**LM, attention="reference", tp_axis="tp", lm_head_tp=True)
    trees = {"mlp_tree": _stacked_init(mesh, mlp, mx),
             "block_tree": _stacked_init(mesh, blocks["reference"], x),
             "lm_tree": _stacked_init(mesh, lm, toks)}
    want = {"mlp": _apply(mesh, mlp, trees["mlp_tree"], mx),
            "lm_logits": _apply(mesh, lm, trees["lm_tree"], toks)}
    for a, blk in blocks.items():
        want[("block", a)] = _apply(mesh, blk, trees["block_tree"], x)

    def ce(lg, tg):
        return jnp.mean(j_vpce(lg, tg, "tp"))

    want["ce"] = float(jax.jit(shard_map(
        ce, mesh=mesh, in_specs=(P(None, None, "tp"), P()),
        out_specs=P()))(jnp.asarray(inp["logits"]),
                        jnp.asarray(inp["targets"])))
    return inp, trees, want


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_side):
    inp, trees, _ = jax_side
    d = tmp_path_factory.mktemp("tp")
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(dict(inp, **trees, D=D, H=H, FF=FF, lm_cfg=LM, lr=LR,
                         steps=STEPS), f)
    assert_ranks_ok(run_world(_WORKER, N, timeout=300, args=[str(d)]))
    return [pickle.loads((d / f"rank{r}.pkl").read_bytes())
            for r in range(N)]


def test_column_row_pair_matches_full_matmul(world, jax_side):
    """relu between a column- and a row-parallel Dense equals the full
    matmul; the input's gradient (through *f*'s all-reduce) is the full
    one."""
    w1, w2, x = (torch.tensor(a) for a in jax_side[0]["pair"])
    xt = x.clone().requires_grad_(True)
    y = torch.relu(xt @ w1) @ w2
    (y ** 2).sum().backward()
    for res in world:
        np.testing.assert_allclose(res["pair"][0], y.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["pair"][1], xt.grad.numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["mlp", "block-reference", "block-flash",
                                  "lm_head_tp"])
def test_tp_forwards_match_jax(world, jax_side, case):
    want = jax_side[2]
    key = {"mlp": "mlp", "lm_head_tp": "lm_logits",
           "block-reference": ("block", "reference"),
           "block-flash": ("block", "flash")}[case]
    for r, res in enumerate(world):
        np.testing.assert_allclose(res[key], want[key][r], rtol=2e-5,
                                   atol=2e-5)


def test_vocab_parallel_cross_entropy(world, jax_side):
    """The value equals JAX's; the gradient, this rank's slice of the
    full-softmax CE's (JAX's own gradient is red)."""
    inp, _, want = jax_side
    logits = torch.tensor(inp["logits"]).requires_grad_(True)
    full = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]),
        torch.tensor(inp["targets"]).long().reshape(-1))
    full.backward()
    np.testing.assert_allclose(full.item(), want["ce"], rtol=1e-5)
    for r, res in enumerate(world):
        np.testing.assert_allclose(res["ce"][0], want["ce"], rtol=1e-5)
        np.testing.assert_allclose(res["ce"][1],
                                   logits.grad.chunk(N, -1)[r].numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_tp_lm_gradients_equal_the_dense_models(world):
    """The TP LM's loss and accuracy equal the dense LM's on the gathered
    weights, and so does every gradient gathered into the dense layout:
    *g*'s backward is the identity (an all-reducing one would make every
    gradient below the first row-parallel layer 4x too large)."""
    for res in world:
        loss, acc, dloss, dacc = res["lm_loss"]
        np.testing.assert_allclose(loss, dloss, rtol=1e-5)
        assert acc == dacc
        got, want = res["lm_grads"]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_replicated_leaves_stay_bitwise_equal_after_adam(world):
    losses, digests = world[0]["adam"]
    assert losses[-1] < losses[0]
    shared = [k for k in digests if ".dense." not in k]
    assert len(shared) == 1 + 2 * 5 + 2     # tok_emb, 5 a block, ln_f
    for res in world[1:]:
        assert res["adam"][0] == losses
        for k in shared:
            assert res["adam"][1][k] == digests[k], k
    # the column- and row-parallel leaves are each rank's own
    own = [k for k in digests if ".dense." in k]
    assert len({tuple(res["adam"][1][k] for k in own)
                for res in world}) == N


def _jax_error(mesh, block):
    x = jnp.zeros((1, 8, D), jnp.float32)
    with pytest.raises(ValueError) as err:
        jax.jit(shard_map(lambda x: block.init(jax.random.PRNGKey(0), x),
                          mesh=mesh, in_specs=P(), out_specs=P("tp"),
                          check_vma=False))(x)
    return str(err.value)


def test_tp_refusals_carry_jaxs_texts(mesh):
    stub = types.SimpleNamespace(size=N, rank=0)
    cases = [
        (dict(n_heads=H, tp_axis="tp", moe_experts_per_device=1), {}),
        (dict(n_heads=2, tp_axis="tp", attention="reference"), {}),
        (dict(n_heads=H, tp_axis="tp", attention="ring", seq_axis="sp"),
         {}),
        (dict(n_heads=H, attention="ring_flash"), {}),
    ]
    for kw, _ in cases:
        want = _jax_error(mesh, JBlock(d_model=D, d_ff=FF, **kw))
        with pytest.raises(ValueError) as err:
            TransformerBlock(D, kw.pop("n_heads"), FF, comms={"tp": stub},
                             device="cpu", **kw)
        assert str(err.value) == want
    with pytest.raises(ValueError, match="lm_head_tp requires tp_axis"):
        TransformerLM(**LM, lm_head_tp=True, device="cpu")
    with pytest.raises(ValueError, match="expects an lm_head_tp model"):
        tp_lm_loss(TransformerLM(**LM, device="cpu"),
                   torch.zeros(1, 4).long(), torch.zeros(1, 4).long())
