"""The port's seq2seq example (config #4) on the CPU against the JAX
example's first steps on one and two ranks, and a run from a BPE corpus
(tolerances beside them).
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import os
import pickle

import numpy as np
import optax
import torch

import jax

import chainermn_tpu
from chainermn_torch.datasets import SubDataset, split_indices
from chainermn_torch.iterators import SerialIterator
from tests.test_torch_mp import assert_ranks_ok, run_world


# the same parameters on each rank's batches (the JAX package's
# split_indices, SerialIterator and pad_batch), the gradients averaged over
# ranks, optax.adam(1e-3), the loss averaged over ranks: the JAX example's
# local_step (model.apply, seq2seq_loss, pmean, allreduce_grad "mean",
# adam). Tolerance 1e-4 relative: f32 LSTMs summed in other orders (4e-7
# relative a step), carried through 3 Adam steps.

S2S_ARGS = ["--device", "cpu", "--vocab", "30", "--unit", "16", "--layer",
            "2", "--n-train", "48", "--batchsize", "8", "--bucket", "8"]
S2S_STEPS = 3


def _jax_seq2seq(n_ranks):
    """The JAX model's parameters and the losses of the JAX example's
    first steps on ``n_ranks`` ranks."""
    from chainermn_tpu.datasets import SubDataset as JSub
    from chainermn_tpu.datasets import split_indices as jsplit
    from chainermn_tpu.datasets.toy import synthetic_translation
    from chainermn_tpu.iterators import SerialIterator as JIter
    from chainermn_tpu.models.seq2seq import Seq2Seq as JSeq2Seq
    from chainermn_tpu.models.seq2seq import pad_batch, seq2seq_loss

    train = synthetic_translation(48, src_vocab=30, tgt_vocab=30, seed=0)
    its = [JIter(JSub(train, p), 8, shuffle=True, seed=0)
           for p in jsplit(len(train), n_ranks, shuffle=True, seed=0)]
    model = JSeq2Seq(n_layers=2, n_units=16, src_vocab=30, tgt_vocab=30)
    sample = pad_batch([train[i] for i in range(2)], 8)
    params = model.init(jax.random.PRNGKey(0), *sample[:3])["params"]
    start = jax.tree_util.tree_map(np.asarray, params)
    opt = optax.adam(1e-3)
    state = opt.init(params)

    def f(p, src, src_len, tgt_in, tgt_out):
        logits = model.apply({"params": p}, src, src_len, tgt_in)
        return seq2seq_loss(logits, tgt_out)[0]

    vg = jax.jit(jax.value_and_grad(f))
    losses = []
    for _ in range(S2S_STEPS):
        vals, grads = zip(*(vg(params, *pad_batch(it.next(), 8))
                            for it in its))
        g = jax.tree_util.tree_map(lambda *gs: sum(gs) / n_ranks, *grads)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(sum(vals) / n_ranks))
    return start, losses


_S2S_WORKER = r'''
import os, pickle, sys
import torch
from chainermn_torch.examples import train_seq2seq

out, argv = sys.argv[1], sys.argv[2:]
args = train_seq2seq.parse_args(argv)
with open(os.path.join(out, "params.pkl"), "rb") as f:
    sd = pickle.load(f)
run = train_seq2seq.build(args)
run.model.load_state_dict(sd)
losses = []
for _ in range(3):
    arrays = train_seq2seq.pad_batch(run.iterator.next(), args.bucket)
    m = run.step(*(torch.from_numpy(a) for a in arrays))
    losses.append(float(m["main/loss"]))
hyp, bleu = train_seq2seq.translate_demo(run, args)
assert hyp.shape == (4, args.bucket) and 0.0 <= bleu <= 1.0
if run.comm.rank == 0:
    with open(os.path.join(out, "losses.pkl"), "wb") as f:
        pickle.dump(losses, f)
print(f"RANK{run.comm.rank} OK", flush=True)
run.comm.finalize()
'''


def test_seq2seq_one_rank_matches_the_jax_examples_steps():
    from chainermn_torch.examples import train_seq2seq
    from chainermn_torch.models.convert import seq2seq_params_from_flax

    start, want = _jax_seq2seq(1)
    args = train_seq2seq.parse_args(S2S_ARGS + ["--beam", "2"])
    run = train_seq2seq.build(args)
    try:
        run.model.load_state_dict(seq2seq_params_from_flax(start))
        got = []
        for _ in range(S2S_STEPS):
            arrays = train_seq2seq.pad_batch(run.iterator.next(), 8)
            got.append(float(run.step(*(torch.from_numpy(a)
                                        for a in arrays))["main/loss"]))
        hyp, bleu = train_seq2seq.translate_demo(run, args)
    finally:
        run.comm.finalize()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert hyp.shape == (4, 8) and 0.0 <= bleu <= 1.0


def test_seq2seq_two_ranks_match_the_jax_examples_steps(tmp_path):
    """Two gloo ranks: the root's pairs scattered as payloads, each rank
    its own batches, the multi-node optimizer's gradient mean."""
    from chainermn_torch.models.convert import seq2seq_params_from_flax

    start, want = _jax_seq2seq(2)
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(seq2seq_params_from_flax(start), f)
    assert_ranks_ok(run_world(_S2S_WORKER, 2, timeout=120,
                              args=[str(tmp_path), *S2S_ARGS]))
    got = pickle.loads((tmp_path / "losses.pkl").read_bytes())
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_seq2seq_main_trains_from_a_bpe_corpus(tmp_path, capsys):
    """``--src-file``/``--tgt-file``: the root trains byte-BPE on the
    parallel text (cached beside it) and the example runs to its
    translate demo."""
    from chainermn_torch.examples import train_seq2seq

    rs = np.random.RandomState(0)
    words = ["ka", "mo", "tesu", "bilo", "dana", "remi"]
    src = [" ".join(rs.choice(words, rs.randint(2, 6))) for _ in range(24)]
    (tmp_path / "c.src").write_text("\n".join(src) + "\n")
    (tmp_path / "c.tgt").write_text(
        "\n".join(" ".join(s.split()[::-1]) for s in src) + "\n")
    final = train_seq2seq.main(
        ["--device", "cpu", "--src-file", str(tmp_path / "c.src"),
         "--tgt-file", str(tmp_path / "c.tgt"), "--bpe-vocab", "280",
         "--unit", "8", "--epoch", "1", "--batchsize", "8"])
    out = capsys.readouterr().out
    assert "BPE vocab" in out and "translate demo (greedy)" in out
    assert np.isfinite(final)
    assert (tmp_path / "c.src.bpe280.json").exists()
