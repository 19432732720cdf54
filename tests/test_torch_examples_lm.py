"""The port's ``train_lm`` (data-parallel and ZeRO-1/2) against the JAX
example's steps and its refusals, and ``serve_transformer_lm``
(tolerances beside them).
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import os

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import chainermn_tpu
from tests.test_torch_mp import assert_ranks_ok, run_world


# -- train_lm ----------------------------------------------------------------
# The port's train_lm against the JAX example's steps at 2 layers, d 32,
# vocab 64, seq 16, per-rank batch 8, Adam 3e-3 with lm_loss_with_aux,
# from the same flax parameters on the batches the port's step took, one
# rank: the data-parallel step (jax.value_and_grad + optax.adam, as the
# JAX example's wrapper computes it on one device), and JAX's own
# make_zero1_train_step/make_zero2_train_step (flat, bucketed at 8 KiB,
# two micro-batches) on a 1-device mesh. The dense flags (--rope
# --n-kv-heads 2 --window 8) run the JAX flash kernels in interpret mode.
# Losses at 1e-5 relative over 3 steps (f32 sums in other orders; Adam's
# first step moves each weight by ~lr).

LM_ARGS = ["--device", "cpu", "--d-model", "32", "--n-heads", "4",
           "--n-layers", "2", "--vocab", "64", "--seq-len", "16",
           "--n-train", "64", "--batchsize", "8", "--iterations", "3",
           "--lr", "3e-3"]
LM_MODES = {"dp": [], "zero1": ["--zero", "1"],
            "zero1-bucketed": ["--zero", "1", "--zero-bucket-kib", "8"],
            "zero2-bucketed": ["--zero", "2", "--zero-bucket-kib", "8"],
            "dense-flags": ["--rope", "--n-kv-heads", "2", "--window", "8"]}


def _jax_lm(dense: bool):
    from chainermn_tpu.models.transformer import TransformerLM as JLM

    kw = (dict(pos_emb="rope", n_kv_heads=2, attention_window=8,
               attention="flash") if dense else dict(attention="reference"))
    model = JLM(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=128,
                max_len=16, **kw)
    params = model.init(jax.random.PRNGKey(0), np.zeros((1, 16), np.int32))
    return model, jax.tree_util.tree_map(np.asarray, params["params"])


def _run_lm_example(argv, params):
    """``train_lm`` built from ``argv`` with the flax ``params``
    converted: its (x, y, loss) per step."""
    from chainermn_torch.examples import train_lm
    from chainermn_torch.models.convert import params_from_flax

    trainer, model = train_lm.build_trainer(train_lm.parse_args(argv))
    model.load_state_dict(params_from_flax(model, params))
    up, seen = trainer.updater, []
    if hasattr(up.optimizer, "refresh"):     # a ZeRO state: re-shard
        up.optimizer.refresh()
    step = up.step_fn

    def recording(x, y):
        m = step(x, y)
        seen.append((x.numpy().copy(), y.numpy().copy(),
                     float(m["main/loss"])))
        return m

    up.step_fn = recording
    try:
        trainer.run()
    finally:
        up.comm.finalize()
    return seen


def _jax_lm_losses(mode, model, params, batches):
    from chainermn_tpu.models.transformer import lm_loss_with_aux as jloss
    from chainermn_tpu.optimizers import (make_zero1_train_step,
                                          make_zero2_train_step)

    tx = optax.adam(3e-3)
    losses = []
    if not mode.startswith("zero"):
        vg = jax.jit(jax.value_and_grad(
            lambda p, x, y: jloss(model, p, x, y)[0]))
        state = tx.init(params)
        for x, y in batches:
            loss, g = vg(params, x, y)
            updates, state = tx.update(g, state, params)
            params = optax.apply_updates(params, updates)
            losses.append(float(loss))
        return losses
    comm = chainermn_tpu.create_communicator(
        "xla", mesh=Mesh(np.array(jax.devices()[:1]), ("r",)))
    bb = 8 * 1024 if "bucketed" in mode else None
    if mode.startswith("zero1"):
        step, state = make_zero1_train_step(model, tx, comm, params,
                                            loss_fn=jloss, bucket_bytes=bb,
                                            donate=False)
    else:
        step, state = make_zero2_train_step(model, tx, comm, params,
                                            n_microbatches=2, loss_fn=jloss,
                                            bucket_bytes=bb, donate=False)
    for x, y in batches:
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(m["main/loss"]))
    return losses


@pytest.mark.parametrize("mode", list(LM_MODES))
def test_train_lm_matches_the_jax_steps(tmp_path, mode):
    model, params = _jax_lm(mode == "dense-flags")
    seen = _run_lm_example(LM_ARGS + LM_MODES[mode] + ["--out",
                                                       str(tmp_path)],
                           params)
    assert len(seen) == 3
    want = _jax_lm_losses(mode, model, params,
                          [(x, y) for x, y, _ in seen])
    np.testing.assert_allclose([s[2] for s in seen], want, rtol=1e-5)


_LM_PARALLEL_WORKER = r"""
import os, sys
from chainermn_torch.examples import train_lm
train_lm.main(sys.argv[1:])
print(f"RANK{os.environ['RANK']} OK", flush=True)
"""

LM_PARALLEL_ARGS = ["--device", "cpu", "--n-train", "32", "--batchsize",
                    "4", "--iterations", "2", "--seq-len", "16", "--vocab",
                    "32", "--d-model", "32", "--n-heads", "4"]


@pytest.mark.parametrize("flags,error,match", [
    (["--zero", "3", "--moe", "2"], None, None),
    (["--fsdp-scan"], SystemExit, "vocab % 128"),
    (["--moe", "2", "--moe-top-k", "2"], None, None),
    (["--ring"], None, "ring-attention"),
    (["--ring", "--seq-impl", "ulysses"], None, "ulysses-attention"),
    (["--ring", "--seq-impl", "ring_flash"], None, "ring_flash-attention"),
    (["--autotune-blocks"], NotImplementedError, "item 6"),
    (["--zero", "3", "--zero-bucket-kib", "64"], SystemExit,
     "applies to --zero 1/2 only"),
    (["--fsdp-scan", "--zero", "1"], SystemExit, "exclusive"),
    (["--fsdp-scan", "--vocab", "128", "--moe", "2"], SystemExit,
     "does not compose with --moe")],
    ids=["zero3", "fsdp-scan", "moe", "ring", "seq-impl", "seq-impl-flash",
         "autotune", "zero3-bucket", "fsdp-scan-zero", "fsdp-scan-moe"])
def test_train_lm_refuses_what_waits_for_later_slices(tmp_path, flags,
                                                       error, match):
    """JAX's own refusals exit with its messages (``--fsdp-scan`` on a
    vocabulary that is not a multiple of 128, or with ``--zero`` or
    ``--moe``); ``--autotune-blocks`` does not apply (item 6). The
    parallel flags that waited for their slice now run, on 2 CPU ranks:
    ``--moe`` (with ``--zero 3`` too, which the MoE branch takes first,
    as in JAX) and ``--ring`` with each ``--seq-impl``, which prints the
    trained weights' next-token accuracy."""
    from chainermn_torch.examples import train_lm

    if error is not None:
        with pytest.raises(error, match=match):
            train_lm.build_trainer(train_lm.parse_args(
                ["--device", "cpu", *flags]))
        return
    results = run_world(_LM_PARALLEL_WORKER, 2, timeout=120, args=[
        *LM_PARALLEL_ARGS, *flags, "--out", str(tmp_path)])
    assert_ranks_ok(results)
    out = results[0][1]
    final = [ln for ln in out.splitlines() if ln.startswith("final: ")]
    assert len(final) == 1, out[-2000:]
    loss = float(final[0].split("loss=")[1].split()[0])
    assert np.isfinite(loss), final
    if match is not None:
        acc = [ln for ln in out.splitlines()
               if ln.startswith(match) and "next-token acc: " in ln]
        assert len(acc) == 1, out[-2000:]
        assert 0.0 <= float(acc[0].rsplit(" ", 1)[1]) <= 1.0


def test_train_lm_trains_from_a_bpe_text_file(tmp_path, capsys):
    """``--text-file`` with ``--bpe-vocab``: the file is tokenized, the
    vocabulary cached beside it, and 2 ZeRO-2 steps run to a finite
    loss."""
    from chainermn_torch.examples import train_lm

    text = tmp_path / "corpus.txt"
    text.write_text(" ".join(f"word{i % 37} tok{i % 11}."
                             for i in range(400)), encoding="utf-8")
    trainer = train_lm.main(
        ["--device", "cpu", "--text-file", str(text), "--bpe-vocab", "300",
         "--seq-len", "16", "--d-model", "32", "--n-heads", "4",
         "--batchsize", "4", "--iterations", "2", "--zero", "2",
         "--out", str(tmp_path / "out")])
    assert np.isfinite(trainer.observation["main/loss"])
    assert (tmp_path / "corpus.txt.bpe300.json").is_file()
    assert "BPE vocab" in capsys.readouterr().out


def test_serve_transformer_lm_trains_publishes_and_serves(tmp_path,
                                                           capsys):
    """The serving example on the CPU at its own small size: a short
    training run continues most prompts' strides, the published weights
    verify, and the Frontend serves every request."""
    from chainermn_torch.examples import serve_transformer_lm
    from chainermn_torch.serving import load_weights

    path = str(tmp_path / "w.npz")
    hits = serve_transformer_lm.main(
        ["--device", "cpu", "--train-steps", "80", "--requests", "3",
         "--max-new-tokens", "6", "--publish", path])
    out = capsys.readouterr().out
    assert f"published weights to {path}" in out
    assert '"completed": 3' in out and '"aborted": 0' in out
    assert hits >= 9, out                  # of 18 tokens
    flat, src = load_weights(path)
    assert src == path and "lm_head.weight" in flat
