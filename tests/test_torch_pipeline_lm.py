"""The port's pipeline LM example (``chainermn_torch.examples.
train_pipeline_lm``) against the JAX package's
(``examples/pipeline_lm/train_pipeline_lm.py``), its converters, and its
tensor-parallel form against the port's dense pipeline.

One 4-rank gloo world (``run_world``) runs every case:

* the interleaved default (S 4, V 2, M 4: 8 TransformerBlocks with
  ``attention="flash"``, the embedding outside, the head in the loss
  hook) and ``--hetero`` (embed + 2 blocks + head), each from the JAX
  example's flax inits converted to flax-layout tensor trees: the loss
  and every gradient of one step against JAX's step on the same trees
  and batch (JAX's flash runs its Pallas kernels in interpret mode on
  the CPU, as its own tests run them), then 3 Adam steps each;
* ``--tp 2`` (S 2 x T 2, V 1): JAX's TP x PP is red (queue 3: its TP
  custom VJPs fail under jax 0.9, and its plain 1F1B head gradient is off
  by a constant factor), so the port's step is held to the port's dense
  pipeline (``--tp 1``, S 2) from the same seed, every gradient gathered
  into the dense layout (``dense_params_from_ranks``), then 3 Adam steps
  with the ``model``-replicated leaves bitwise equal along ``model``;
* the CLI ``main`` in all three forms, losses falling.

Tolerances: loss rtol 1e-5; gradients rtol 2e-4 / atol 1e-6 (JAX's
pipeline tests' bar: the same f32 products summed in another order);
the 3-step Adam losses rtol 1e-3 (Adam's first update is lr·sign(g), so a
gradient that cancels to ~1e-7 moves its weight by a part of lr on
last-bit differences); the TP step against the dense one rtol 1e-5 (loss)
and rtol 1e-4 / atol 1e-6 (gradients: the same sums split over two
ranks, the TP tests' bar); the converters' forwards rtol 1e-5 /
atol 1e-6 and their round trips exactly; the flags' refusal texts equal
as strings.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import importlib.util
import pickle
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu.models.transformer import TransformerBlock as JBlock
from chainermn_tpu.parallel import (HeteroPipeline as JHetero,
                                    hetero_pipeline_1f1b_value_and_grad,
                                    pipeline_interleaved_1f1b_value_and_grad,
                                    stack_stage_params)
from chainermn_torch.examples import train_pipeline_lm as tpl
from chainermn_torch.models.convert import (flax_tree_apply,
                                            module_flax_tree,
                                            module_params_from_flax,
                                            stacked_params_from_flax,
                                            stage_stack_from_flax)
from chainermn_torch.models.transformer import TransformerBlock
from tests.test_torch_mp import assert_ranks_ok, run_world

REPO = Path(__file__).resolve().parents[1]
S, V, M, MB, L, VOCAB, D, H, FF = 4, 2, 4, 2, 16, 32, 32, 4, 64
LR, STEPS = 3e-3, 3
ARGV = ["-V", str(V), "-M", str(M), "--mb-size", str(MB), "-L", str(L),
        "--vocab", str(VOCAB), "--d-model", str(D), "--n-heads", str(H),
        "--d-ff", str(FF), "--lr", str(LR), "--device", "cpu"]


def _jax_example():
    """The JAX example's module (its flax EmbedIn/HeadOut, its flags)."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_pipeline_lm",
        REPO / "examples" / "pipeline_lm" / "train_pipeline_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batches(n):
    args = tpl.parse_args(ARGV)
    data = tpl.batches(args, M, "cpu")
    return [tuple(t.numpy() for t in next(data)) for _ in range(n)]


def _jax_trees(jex):
    """The JAX example's inits: (emb, [V, S, ...] stages, head) and the
    hetero stages' trees (embed, S-2 blocks, head)."""
    block = JBlock(d_model=D, n_heads=H, d_ff=FF, attention="flash")
    embed, head = jex.EmbedIn(VOCAB, D, L), jex.HeadOut(VOCAB)
    rng = jax.random.PRNGKey(0)
    toks0 = np.zeros((MB, L), np.int32)
    h0 = np.zeros((MB, L, D), np.float32)
    emb_p = embed.init(rng, toks0)["params"]
    stage_p = stack_stage_params([
        block.init(jax.random.fold_in(rng, k), h0)["params"]
        for k in range(S * V)])
    stage_p = jax.tree_util.tree_map(
        lambda q: q.reshape((V, S) + q.shape[1:]), stage_p)
    head_p = head.init(jax.random.fold_in(rng, 999), h0)["params"]
    hetero = ([emb_p] + [block.init(jax.random.fold_in(rng, k), h0)["params"]
                         for k in range(S - 2)]
              + [head.init(jax.random.fold_in(rng, 999), h0)["params"]])
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (np_(emb_p), np_(stage_p), np_(head_p)), [np_(t) for t in hetero]


def _jax_interleaved(jex, trees, batches):
    """JAX's default step (its ``pipe`` + the embedding's vjp + optax
    Adam): the first step's loss and gradients, and every step's loss."""
    block = JBlock(d_model=D, n_heads=H, d_ff=FF, attention="flash")
    embed, head = jex.EmbedIn(VOCAB, D, L), jex.HeadOut(VOCAB)
    mesh = Mesh(np.array(jax.devices()[:S]), ("stage",))

    def head_loss(hp, out, tgt):
        logits = head.apply({"params": hp}, out)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, tgt).mean()

    def pipe(sp, hp, x_mb, tgts):
        sp = jax.tree_util.tree_map(lambda q: q.squeeze(1), sp)
        loss, g, aux = pipeline_interleaved_1f1b_value_and_grad(
            lambda p, h: block.apply({"params": p}, h), head_loss, sp, x_mb,
            tgts, "stage", V, head_params=hp, return_input_grads=True)
        return (loss, jax.tree_util.tree_map(lambda q: q[:, None], g),
                aux["head_grads"], aux["input_grads"])

    pipe_sm = shard_map(pipe, mesh=mesh,
                        in_specs=(P(None, "stage"), P(), P(), P()),
                        out_specs=(P(), P(None, "stage"), P(), P()))

    @jax.jit
    def grads(params, toks, tgts):
        emb_p, stage_p, head_p = params
        x_mb, emb_vjp = jax.vjp(
            lambda ep: jax.vmap(
                lambda t: embed.apply({"params": ep}, t))(toks), emb_p)
        loss, sg, hg, dxs = pipe_sm(stage_p, head_p, x_mb, tgts)
        return loss, (emb_vjp(dxs)[0], sg, hg)

    opt = optax.adam(LR)
    params = jax.tree_util.tree_map(jnp.asarray, trees)
    state = opt.init(params)
    losses, first = [], None
    for toks, tgts in batches:
        loss, g = grads(params, toks.astype(np.int32), tgts.astype(np.int32))
        first = first or (float(loss), jax.tree_util.tree_map(np.asarray,
                                                               g))
        losses.append(float(loss))
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return first, losses


def _jax_hetero(jex, trees, batches):
    block = JBlock(d_model=D, n_heads=H, d_ff=FF, attention="flash")
    embed, head = jex.EmbedIn(VOCAB, D, L), jex.HeadOut(VOCAB)
    fns = ([lambda p, t: embed.apply({"params": p}, t)]
           + [lambda p, h: block.apply({"params": p}, h)] * (S - 2)
           + [lambda p, h: head.apply({"params": p}, h)])
    pipe = JHetero([(f, jax.tree_util.tree_map(jnp.asarray, t))
                    for f, t in zip(fns, trees)],
                   jax.ShapeDtypeStruct((MB, L), jnp.int32),
                   axis_name="stage")
    mesh = Mesh(np.array(jax.devices()[:S]), ("stage",))

    def loss_fn(logits, tgt):
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, tgt).mean()

    def run(stacked, xw, tgts):
        my = jax.tree_util.tree_map(lambda l: l[0], stacked)
        loss, g = hetero_pipeline_1f1b_value_and_grad(pipe, loss_fn, my, xw,
                                                      tgts)
        return loss, g[None]

    run_sm = jax.jit(shard_map(run, mesh=mesh,
                               in_specs=(P("stage"), P(), P()),
                               out_specs=(P(), P("stage"))))
    opt = optax.adam(LR)
    packed = pipe.pack_params()
    state = opt.init(packed)
    losses, first = [], None
    for toks, tgts in batches:
        loss, g = run_sm(packed, pipe.encode_inputs(toks.astype(np.int32)),
                         tgts.astype(np.int32))
        first = first or (float(loss), np.asarray(g))
        losses.append(float(loss))
        upd, state = opt.update(g, state, packed)
        packed = optax.apply_updates(packed, upd)
    return np.asarray(pipe.pack_params()), first, losses


_WORKER = r'''
import hashlib, os, pickle, sys
import numpy as np
import torch
from chainermn_torch.comm import create_communicator
from chainermn_torch.examples import train_pipeline_lm as tpl
from chainermn_torch.models.convert import (dense_params_from_ranks,
    module_params_from_flax, stacked_params_from_flax,
    stage_stack_from_flax)
from chainermn_torch.models.transformer import TransformerBlock
from chainermn_torch.parallel.pipeline import (_stage_act_dtype,
                                               tree_leaves, tree_map)

out_dir = sys.argv[1]
with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
comm = create_communicator("pure_nccl", device="cpu")
r = comm.rank
t = lambda a: torch.tensor(np.asarray(a))
res = {}


def np_tree(tree):
    return tree_map(lambda x: x.detach().numpy(), tree)


def run(model, first_only=False):
    out, losses = None, []
    for toks, tgts in inp["batches"]:
        if out is None:
            loss, g = model.value_and_grad(t(toks).long(), t(tgts).long())
            out = (loss.item(), np_tree(g))
        losses.append(model.step(t(toks).long(), t(tgts).long()))
    return out, losses


# the interleaved default from JAX's trees
argv = inp["argv"]
emb, stages, head = inp["trees"]
args = tpl.parse_args(argv)
model = tpl.PipelineLM(args, comm, params=(
    stacked_params_from_flax(emb), stage_stack_from_flax(stages, r),
    stacked_params_from_flax(head)))
res["interleaved"] = run(model)

# --hetero from JAX's trees: this rank's stage and the others' shapes
trees = [stacked_params_from_flax(tr) if i == r else
         tree_map(lambda x: x.to("meta"), stacked_params_from_flax(tr))
         for i, tr in enumerate(inp["hetero"])]
hargs = tpl.parse_args(argv + ["--hetero"])
hm = tpl.HeteroPipelineLM(hargs, comm, trees=trees)
res["hetero_row"] = hm.row.detach().numpy().copy()
res["hetero"] = run(hm)

# --tp 2 against the dense pipeline on the same seed: S 2 x T 2, and the
# dense S 2 pipeline on ranks {0, 2} and {1, 3}
targs = tpl.parse_args(argv + ["--tp", "2", "-V", "1"])
tp = tpl.PipelineLM(targs, comm, seed=3)
dargs = tpl.parse_args(argv + ["-V", "1"])
dense = tpl.PipelineLM(dargs, comm.split(("stride", 2)), seed=3)
toks, tgts = (t(a).long() for a in inp["batches"][0])
tl, (te, ts, th) = tp.value_and_grad(toks, tgts)
dl, (de, ds, dh) = dense.value_and_grad(toks, tgts)
tblock = TransformerBlock(inp["D"], inp["H"], inp["FF"], tp_axis="model",
                          comms={"model": tp.model}, device="meta")
dblock = TransformerBlock(inp["D"], inp["H"], inp["FF"], device="meta")
own = {k: v.contiguous() for k, v in module_params_from_flax(
    tblock, tree_map(lambda x: x[0], ts)).items()}
pieces = tp.model.allgather_obj(own)
gathered = dense_params_from_ranks(dblock, pieces)
want = module_params_from_flax(dblock, tree_map(lambda x: x[0], ds))
res["tp"] = dict(
    loss=(tl.item(), dl.item()),
    emb=(np_tree(te), np_tree(de)),
    head_ln=(np_tree(th["LayerNorm_0"]), np_tree(dh["LayerNorm_0"])),
    head_out=(th["out"]["kernel"].numpy(), dh["out"]["kernel"].numpy(),
              tp.model.rank),
    block=({k: v.numpy() for k, v in gathered.items()},
           {k: v.detach().numpy() for k, v in want.items()}))
# the TP stage on meta tensors: the all-reduce passes them through, so
# the stage's activation type comes from its shapes, with no message
x_mb = tp._embed(tp.embed_tree, toks).detach()
res["tp_meta"] = (
    str(_stage_act_dtype(tp._stage, tree_map(lambda x: x[0], tp.stage_tree),
                         tuple(x_mb.shape[1:]), x_mb.dtype)),
    tp.model.allreduce(torch.empty(3, 5, device="meta")).is_meta,
    tuple(tp.model.allreduce(torch.empty(3, 5, device="meta")).shape))
losses = [tp.step(toks, tgts) for _ in range(inp["steps"])]
sha = lambda x: hashlib.sha256(x.detach().numpy().tobytes()).hexdigest()
res["tp_adam"] = (losses, tp.model.rank, tp.stage.rank, {
    "embed": [sha(x) for x in tree_leaves(tp.embed_tree)],
    "head_ln": [sha(x) for x in tree_leaves(tp.head_tree["LayerNorm_0"])],
    "ln": [sha(x) for k in ("LayerNorm_0", "LayerNorm_1")
           for x in tree_leaves(tp.stage_tree[k])],
    "row_bias": sha(tp.stage_tree["tp_ffn"]["RowParallelDense_0"]["bias"]),
    "own": sha(tp.stage_tree["tp_ffn"]["ColumnParallelDense_0"]["Dense_0"][
        "kernel"])})

# the CLI in its three forms, on this world
tpl.create_communicator = lambda *a, **kw: comm
finalize, comm.finalize = comm.finalize, lambda: None
for name, extra in (("default", []), ("hetero", ["--hetero"]),
                    ("tp", ["--tp", "2", "-V", "1"])):
    res[("main", name)] = tpl.main(argv + extra + ["--steps", "12"])
with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
    pickle.dump(res, f)
finalize()
print(f"RANK{r} OK", flush=True)
'''


@pytest.fixture(scope="module")
def jex():
    return _jax_example()


@pytest.fixture(scope="module")
def jax_side(jex):
    trees, hetero = _jax_trees(jex)
    batches = _batches(STEPS)
    return dict(trees=trees, hetero=hetero, batches=batches,
                interleaved=_jax_interleaved(jex, trees, batches),
                hetero_run=_jax_hetero(jex, hetero, batches))


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_side):
    d = tmp_path_factory.mktemp("pipelm")
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(dict(trees=jax_side["trees"], hetero=jax_side["hetero"],
                         batches=jax_side["batches"], argv=ARGV, D=D, H=H,
                         FF=FF, steps=STEPS), f)
    assert_ranks_ok(run_world(_WORKER, S, timeout=600, args=[str(d)]))
    return [pickle.loads((d / f"rank{r}.pkl").read_bytes())
            for r in range(S)]


def _close(got, want, rtol, atol, msg=""):
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
            err_msg=msg), got, want)


def test_interleaved_step_matches_jaxs_example(world, jax_side):
    (loss, (demb, dstage, dhead)), losses = jax_side["interleaved"]
    for r, res in enumerate(world):
        (got_loss, (ge, gs, gh)), got_losses = res["interleaved"]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        _close(ge, demb, 2e-4, 1e-6, "embedding")
        _close(gs, jax.tree_util.tree_map(lambda q: q[:, r], dstage), 2e-4,
               1e-6, f"rank {r} chunks")
        _close(gh, dhead, 2e-4, 1e-6, "head")
        np.testing.assert_allclose(got_losses, losses, rtol=1e-3)
        assert got_losses[-1] < got_losses[0]


def test_hetero_step_matches_jaxs_example(world, jax_side):
    """The row each rank packs is JAX's row bit for bit; the loss and
    the row's gradient equal JAX's."""
    stack, (loss, grads), losses = jax_side["hetero_run"]
    for r, res in enumerate(world):
        np.testing.assert_array_equal(res["hetero_row"], stack[r])
        (got_loss, g), got_losses = res["hetero"]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
        np.testing.assert_allclose(g, grads[r], rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(got_losses, losses, rtol=1e-3)
        assert got_losses[-1] < got_losses[0]


def test_tp_pipeline_equals_the_dense_pipeline(world):
    """S 2 x T 2 against the dense S 2 pipeline from the same seed: the
    loss, the embedding's and the head LayerNorm's gradients (averaged
    over ``model``), the head kernel's column slice, and every block
    gradient gathered into the dense layout. An all-reducing backward of
    *g* would make the block gradients 2x too large."""
    for res in world:
        tp = res["tp"]
        np.testing.assert_allclose(*tp["loss"], rtol=1e-5)
        _close(*tp["emb"], 1e-4, 1e-6, "embedding")
        _close(*tp["head_ln"], 1e-4, 1e-6, "head LayerNorm")
        got, want, t = tp["head_out"]
        vl = VOCAB // 2
        np.testing.assert_allclose(got, want[:, t * vl:(t + 1) * vl],
                                   rtol=1e-4, atol=1e-6)
        got, want = tp["block"]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_tp_stage_types_on_meta_tensors(world):
    """The TP stage runs on meta tensors (the activation type comes from
    there, no first-forward fallback): the communicator's all-reduce
    passes a meta tensor through with its shape."""
    for res in world:
        assert res["tp_meta"] == ("torch.float32", True, (3, 5))


def test_tp_replicated_leaves_stay_bitwise_equal(world):
    rows = {}
    for res in world:
        losses, t, s, digests = res["tp_adam"]
        assert losses[-1] < losses[0] and np.isfinite(losses).all()
        rows[(s, t)] = (losses, digests)
    for s in range(2):
        (l0, d0), (l1, d1) = rows[(s, 0)], rows[(s, 1)]
        assert l0 == l1
        for key in ("embed", "head_ln", "ln", "row_bias"):
            assert d0[key] == d1[key], (s, key)
        assert d0["own"] != d1["own"]


@pytest.mark.parametrize("form", ["default", "hetero", "tp"])
def test_cli_trains_on_the_cpu(world, form):
    for res in world:
        losses = res[("main", form)]
        assert len(losses) == 12 and np.isfinite(losses).all()
        assert losses[-1] < 0.8 * losses[0], losses


def test_sequential_oracle_matches_jaxs_step(jax_side):
    """``sequential_value_and_grad`` (the one-rank oracle the card's
    pipeline phase holds the schedules to) on JAX's trees: the blocks in
    logical order k = v·S + d, the mean loss over micro-batches; its loss
    and gradients equal JAX's pipelined step."""
    emb_p, stage_p, head_p = jax_side["trees"]
    (loss, (demb, dstage, dhead)), _ = jax_side["interleaved"]
    args = tpl.parse_args(ARGV)
    blocks = [stacked_params_from_flax(jax.tree_util.tree_map(
        lambda q, k=k: q[k // S, k % S], stage_p)) for k in range(S * V)]
    toks, tgts = (torch.tensor(a).long() for a in jax_side["batches"][0])
    got, (ge, gb, gh) = tpl.sequential_value_and_grad(
        args, stacked_params_from_flax(emb_p), blocks,
        stacked_params_from_flax(head_p), toks, tgts)
    np.testing.assert_allclose(got, loss, rtol=1e-5)
    _close(ge, demb, 2e-4, 1e-6, "embedding")
    _close(gh, dhead, 2e-4, 1e-6, "head")
    for k in range(S * V):
        _close(gb[k], jax.tree_util.tree_map(
            lambda q, k=k: q[k // S, k % S], dstage), 2e-4, 1e-6,
            f"block {k}")


def test_converters_match_jaxs_modules(jex, jax_side):
    """EmbedIn, HeadOut and the block through ``flax_tree_apply`` on the
    converted flax trees equal the JAX modules' forwards; the trees
    round-trip through the modules' names exactly."""
    emb_p, stage_p, head_p = jax_side["trees"]
    rs = np.random.RandomState(0)
    toks = rs.randint(0, VOCAB, (MB, L))
    h = rs.randn(MB, L, D).astype(np.float32)
    jemb = jex.EmbedIn(VOCAB, D, L).apply({"params": emb_p}, toks)
    jhead = jex.HeadOut(VOCAB).apply({"params": head_p}, h)
    block0 = jax.tree_util.tree_map(lambda q: q[1, 2], stage_p)
    jblk = JBlock(d_model=D, n_heads=H, d_ff=FF,
                  attention="reference").apply({"params": block0}, h)
    embed = tpl.EmbedIn(VOCAB, D, L, device="meta")
    head = tpl.HeadOut(VOCAB, D, device="meta")
    block = TransformerBlock(D, H, FF, attention="reference", device="meta")
    ht = torch.tensor(h)
    np.testing.assert_allclose(
        flax_tree_apply(embed)(stacked_params_from_flax(emb_p),
                               torch.tensor(toks)).numpy(),
        np.asarray(jemb), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        flax_tree_apply(head)(stacked_params_from_flax(head_p), ht).numpy(),
        np.asarray(jhead), rtol=1e-5, atol=1e-6)
    chunks = stage_stack_from_flax(stage_p, 2)
    np.testing.assert_allclose(
        flax_tree_apply(block)({k: _index(v, 1) for k, v in chunks.items()},
                               ht).detach().numpy(),
        np.asarray(jblk), rtol=1e-5, atol=1e-5)
    for mod, tree in ((embed, emb_p), (head, head_p)):
        sd = {k: v.contiguous() for k, v in module_params_from_flax(
            mod, stacked_params_from_flax(tree)).items()}
        back = module_flax_tree(mod, sd)
        _close(back, tree, 0, 0)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def test_flag_refusals_carry_jaxs_texts(jex, monkeypatch):
    stub = types.SimpleNamespace(size=8, rank=0)
    for argv in (["--hetero", "-S", "2"], ["--tp", "3"],
                 ["--tp", "2", "--vocab", "33"], ["-S", "8", "--tp", "2"]):
        monkeypatch.setattr(sys, "argv", ["train_pipeline_lm.py"] + argv)
        with pytest.raises(SystemExit) as want:
            jex.main()
        with pytest.raises(SystemExit) as got:
            tpl.build(tpl.parse_args(argv + ["--device", "cpu"]), stub)
        assert str(got.value) == str(want.value)
