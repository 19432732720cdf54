"""Port parity: chainermn_torch's fused LM-head cross-entropy (its plain
versions, which CPU tensors run) against the JAX package's fused_ce_head,
whose Pallas kernels run in interpret mode on the CPU.

Inputs are made with numpy from a seed and fed to both. Tolerance: f32
at rtol = atol = 1e-4 (the two sum in different orders); bf16 at 2e-2
(the hidden states, head and dl are rounded to bf16 in both, the
products and sums differ in order).
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.ops.fused_ce import fused_ce_head as jax_fused_ce_head
from chainermn_torch.ops import _cuda
from chainermn_torch.ops.fused_ce import (ce_dh_reference, ce_dw_reference,
                                          ce_forward_cuda,
                                          ce_forward_reference,
                                          ce_fwd_combine_reference,
                                          ce_fwd_partial_reference,
                                          ce_fwd_plan, ce_fwd_splits,
                                          fused_ce_head, fused_lm_loss)

N, D, V = 96, 32, 256          # N not a multiple of the TPU row block
BR, BV = 64, 128
TOL = dict(rtol=1e-4, atol=1e-4)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)


def _data(seed=0, n=N, ties=False):
    rs = np.random.RandomState(seed)
    if ties:
        # small integers: every logit exact; head columns v and v + V/2
        # are equal, so every row's max is attained twice
        h = rs.randint(-2, 3, size=(n, D)).astype(np.float32)
        half = rs.randint(-2, 3, size=(D, V // 2)).astype(np.float32)
        w = np.concatenate([half, half], axis=1)
    else:
        h = (rs.randn(n, D) * 0.5).astype(np.float32)
        w = (rs.randn(D, V) * 0.2).astype(np.float32)
    y = rs.randint(0, V, size=(n,)).astype(np.int32)
    return h, w, y


def _jax(h, w, y, dtype=jnp.float32):
    """(loss, acc, dh, dw) from the JAX custom_vjp (Pallas, interpret)."""
    def f(h, w):
        return jax_fused_ce_head(h, w, jnp.asarray(y), BR, BV)

    (loss, acc), vjp = jax.vjp(f, jnp.asarray(h, dtype),
                               jnp.asarray(w, dtype))
    dh, dw = vjp((jnp.ones_like(loss), jnp.zeros_like(acc)))
    return (float(loss), float(acc), np.asarray(dh.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


def _port(h, w, y, dtype=torch.float32):
    ht = torch.from_numpy(h).to(dtype).requires_grad_()
    wt = torch.from_numpy(w).to(dtype).requires_grad_()
    loss, acc = fused_ce_head(ht, wt, torch.from_numpy(y), BR, BV)
    loss.backward()
    return (loss.item(), acc.item(), ht.grad.float().numpy(),
            wt.grad.float().numpy())


def test_loss_accuracy_and_both_gradients_match_fused_ce_head():
    h, w, y = _data()
    ref = _jax(h, w, y)
    got = _port(h, w, y)
    np.testing.assert_allclose(got[0], ref[0], **TOL)
    assert got[1] == ref[1]
    np.testing.assert_allclose(got[2], ref[2], **TOL)
    np.testing.assert_allclose(got[3], ref[3], **TOL)
    assert np.abs(got[3]).max() > 0 and np.abs(got[2]).max() > 0


def test_bf16_hidden_and_head_match():
    h, w, y = _data(seed=2)
    ref = _jax(h, w, y, jnp.bfloat16)
    got = _port(h, w, y, torch.bfloat16)
    np.testing.assert_allclose(got[0], ref[0], **TOL_BF16)
    np.testing.assert_allclose(got[2], ref[2], **TOL_BF16)
    np.testing.assert_allclose(got[3], ref[3], **TOL_BF16)


def test_argmax_ties_take_the_first_index_like_jax():
    h, w, y = _data(seed=3, ties=True)
    y[: N // 2] = np.argmax(h[: N // 2] @ w, -1)   # half the rows right
    ref = _jax(h, w, y)
    got = _port(h, w, y)
    assert got[1] == ref[1] == pytest.approx(0.5, abs=0.1)
    _, _, am = ce_forward_reference(torch.from_numpy(h),
                                    torch.from_numpy(w.T.copy()),
                                    torch.from_numpy(y))
    assert (am < V // 2).all()
    np.testing.assert_array_equal(am.numpy(), np.argmax(h @ w, -1))


def test_plain_backward_pieces_are_unscaled_dl_products():
    """ce_dh/ce_dw_reference are dl·W and dlᵀ·h before the dloss/N
    scale, with dl = softmax − onehot."""
    h, w, y = _data(seed=4)
    ht, wt, yt = (torch.from_numpy(h), torch.from_numpy(w.T.copy()),
                  torch.from_numpy(y))
    lse = ce_forward_reference(ht, wt, yt)[0]
    logits = ht @ wt.t()
    dl = torch.softmax(logits, -1) - torch.nn.functional.one_hot(
        yt.long(), V).float()
    torch.testing.assert_close(ce_dh_reference(ht, wt, yt, lse), dl @ wt,
                               **TOL)
    torch.testing.assert_close(ce_dw_reference(ht, wt, yt, lse),
                               dl.t() @ ht, **TOL)


def test_cpu_tensors_take_the_plain_versions_without_a_launch():
    h, w, y = _data(seed=5)
    before = _cuda.launches()
    _port(h, w, y)
    assert _cuda.launches() == before


def test_kernel_wrapper_refuses_cpu_tensors():
    h, w, y = _data()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ce_forward_cuda(torch.from_numpy(h), torch.from_numpy(w.T.copy()),
                        torch.from_numpy(y))


def test_fused_lm_loss_refuses_mutable_and_moe():
    class Moe:
        moe_experts_per_device = 2

    x = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="mutable"):
        fused_lm_loss(object(), x, x, mutable=("batch_stats",))
    with pytest.raises(ValueError, match="MoE"):
        fused_lm_loss(Moe(), x, x)


def _ranges_forward(h, wt, y, width):
    """ce_forward_reference's vocabulary cut into ranges of ``width``
    columns (the last one ragged), each range's partials combined."""
    v = wt.shape[0]
    bounds = list(range(0, v, width)) + [v]
    parts = [ce_fwd_partial_reference(h, wt, y, lo, hi)
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    stacked = [torch.stack(p) for p in zip(*parts)]
    return ce_fwd_combine_reference(*stacked), len(parts)


@pytest.mark.parametrize("ties", [False, True])
def test_vocabulary_ranges_combine_to_the_whole_forward(ties):
    """The bf16 forward's split: 6 ranges of 48 columns (the last 16), so
    columns v and v + V/2, equal under ties, fall in different ranges and
    the first index must still win; a label in every range. The combined
    partials equal the whole-vocabulary reference, and their loss and
    accuracy equal JAX fused_ce_head's (Pallas, interpret mode)."""
    h, w, y = _data(seed=6, ties=ties)
    width = 48
    y[:6] = np.arange(6) * width + 5
    if ties:
        y[N // 2:] = np.argmax(h[N // 2:] @ w, -1)  # half the rows right
    ht, wt, yt = (torch.from_numpy(h), torch.from_numpy(w.T.copy()),
                  torch.from_numpy(y))
    (lse, tl, am), ranges = _ranges_forward(ht, wt, yt, width)
    assert ranges == 6
    r_lse, r_tl, r_am = ce_forward_reference(ht, wt, yt)
    torch.testing.assert_close(lse, r_lse, **TOL)
    torch.testing.assert_close(tl, r_tl, **TOL)
    assert torch.equal(am, r_am)
    if ties:
        assert (am < V // 2).all()
    loss, acc = jax_fused_ce_head(jnp.asarray(h), jnp.asarray(w),
                                  jnp.asarray(y), BR, BV)
    np.testing.assert_allclose((lse - tl).mean().item(), float(loss), **TOL)
    assert (am.long() == yt.long()).float().mean().item() == float(acc)


def test_a_range_without_the_label_adds_no_target_logit():
    h, w, y = _data(seed=7)
    ht, wt, yt = (torch.from_numpy(h), torch.from_numpy(w.T.copy()),
                  torch.from_numpy(y))
    m, s, t, a = ce_fwd_partial_reference(ht, wt, yt, 100, 140)
    inside = (yt >= 100) & (yt < 140)
    assert (t[~inside] == 0).all() and (t[inside] != 0).all()
    assert ((a >= 100) & (a < 140)).all()
    # one range is the whole forward
    lse, tl, am = ce_fwd_combine_reference(
        *(x[None] for x in ce_fwd_partial_reference(ht, wt, yt, 0, V)))
    ref = ce_forward_reference(ht, wt, yt)
    torch.testing.assert_close(lse, ref[0], **TOL)
    assert torch.equal(tl, ref[1]) and torch.equal(am, ref[2])


def test_vocabulary_split_fills_the_card_and_leaves_no_range_empty():
    for sms in (132, 114, 8):
        for n in (1, 2, 127, 128, 129, 1000, 8192, 10000, 65536):
            for v in (1, 100, 255, 256, 257, 1000, 4097, 30000, 32768,
                      50257):
                s, per = ce_fwd_splits(n, v, sms)
                tiles = -(-v // 256)
                assert 1 <= s <= tiles, (sms, n, v, s)
                assert (s - 1) * per < tiles <= s * per, (sms, n, v, s, per)
    # the training shape: 64 row blocks x 2 ranges on 132 SMs
    assert ce_fwd_splits(8192, 32768, 132) == (2, 64)
    plan = ce_fwd_plan(8192, 768, 32768, 132)
    assert plan["grid"] == (64, 2)
    assert plan["smem_bytes"] == 64 * 128 * 12 * (128 + 256) * 64 * 2
    # one row: every tile its own range
    assert ce_fwd_splits(1, 32768, 132) == (128, 1)
