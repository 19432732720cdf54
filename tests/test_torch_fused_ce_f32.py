"""The f32 fused CE's vocabulary split on the CPU: the plain versions of
its forward ranges at the f32 tile width and of its dh ranges, held to the
whole-vocabulary plain versions and to JAX's fused_ce_head (Pallas,
interpret mode), and the planners that pick its ranges.

Inputs are made with numpy from a seed and fed to both. Tolerance: rtol =
atol = 1e-4 (the ranges and JAX sum in different orders); argmax exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.ops.fused_ce import fused_ce_head as jax_fused_ce_head
from chainermn_torch.ops.fused_ce import (ce_dh_combine_reference,
                                          ce_dh_cuda, ce_dh_partial_reference,
                                          ce_dh_plan, ce_dh_reference,
                                          ce_dh_splits, ce_forward_reference,
                                          ce_fwd_combine_reference,
                                          ce_fwd_partial_reference,
                                          ce_fwd_plan, ce_fwd_splits)

from tests.test_torch_cuda import F32_DH_TILE as DH_TILE
from tests.test_torch_cuda import F32_FWD_TILE as FWD_TILE

N, D, V = 96, 32, 640
TOL = dict(rtol=1e-4, atol=1e-4)


def _data(seed, ties=False):
    rs = np.random.RandomState(seed)
    if ties:
        # small integers: every logit exact; head columns v and v + V/2
        # are equal, so every row's max is attained twice
        h = rs.randint(-2, 3, size=(N, D)).astype(np.float32)
        half = rs.randint(-2, 3, size=(D, V // 2)).astype(np.float32)
        w = np.concatenate([half, half], axis=1)
    else:
        h = (rs.randn(N, D) * 0.5).astype(np.float32)
        w = (rs.randn(D, V) * 0.3).astype(np.float32)
    y = rs.randint(0, V, size=(N,)).astype(np.int32)
    return h, w, y


def _bounds(width):
    return list(zip(range(0, V, width), list(range(width, V, width)) + [V]))


@pytest.mark.parametrize("ties", [False, True])
def test_f32_forward_ranges_at_the_tile_width_combine_to_the_whole_forward(
        ties):
    """Five ranges of the f32 tile's 128 columns: under ties columns v and
    v + 320 (equal) lie in different ranges and the first index must win;
    a label in every range. The combined partials equal the whole
    forward, and their loss and accuracy JAX fused_ce_head's."""
    h, w, y = _data(0, ties)
    width = FWD_TILE[1]
    bounds = _bounds(width)
    assert len(bounds) == 5
    y[:5] = [lo + 7 for lo, _ in bounds]
    if ties:
        y[N // 2:] = np.argmax(h[N // 2:] @ w, -1)   # half the rows right
    ht, wt, yt = (torch.from_numpy(h), torch.from_numpy(w.T.copy()),
                  torch.from_numpy(y))
    parts = [ce_fwd_partial_reference(ht, wt, yt, lo, hi)
             for lo, hi in bounds]
    lse, tl, am = ce_fwd_combine_reference(
        *[torch.stack(p) for p in zip(*parts)])
    r_lse, r_tl, r_am = ce_forward_reference(ht, wt, yt)
    torch.testing.assert_close(lse, r_lse, **TOL)
    torch.testing.assert_close(tl, r_tl, **TOL)
    assert torch.equal(am, r_am)
    if ties:
        assert (am < V // 2).all()
        # each row's max lies in two ranges; the lower one's index wins
        assert (am.numpy() == np.argmax(h @ w, -1)).all()
    loss, acc = jax_fused_ce_head(jnp.asarray(h), jnp.asarray(w),
                                  jnp.asarray(y), 64, 128)
    np.testing.assert_allclose((lse - tl).mean().item(), float(loss), **TOL)
    assert (am.long() == yt.long()).float().mean().item() == float(acc)


def _jax_dh(h, w, y):
    """Unscaled dh = dl . W from JAX fused_ce_head's custom_vjp (Pallas,
    interpret mode): its dh is the mean loss's, dl . W / N."""
    def f(h):
        return jax_fused_ce_head(h, jnp.asarray(w), jnp.asarray(y), 64,
                                 128)[0]

    _, vjp = jax.vjp(f, jnp.asarray(h))
    return np.asarray(vjp(jnp.ones(()))[0]) * h.shape[0]


@pytest.mark.parametrize("width", [DH_TILE[1], 48])
def test_dh_ranges_sum_to_the_whole_dh_and_to_jax(width):
    """The f32 dh's split: ranges of ``width`` vocabulary rows (the last
    ragged), a label in every range, partials summed in range order. The
    sum equals ce_dh_reference and JAX's dh."""
    h, w, y = _data(1)
    bounds = _bounds(width)
    y[:len(bounds)] = [lo + 3 for lo, _ in bounds]
    ht, wt, yt = (torch.from_numpy(h), torch.from_numpy(w.T.copy()),
                  torch.from_numpy(y))
    lse = ce_forward_reference(ht, wt, yt)[0]
    parts = torch.stack([ce_dh_partial_reference(ht, wt, yt, lse, lo, hi)
                         for lo, hi in bounds])
    assert parts.dtype == torch.float32 and parts.shape == (len(bounds), N, D)
    dh = ce_dh_combine_reference(parts)
    torch.testing.assert_close(dh, ce_dh_reference(ht, wt, yt, lse), **TOL)
    np.testing.assert_allclose(dh.numpy(), _jax_dh(h, w, y), **TOL)
    # every range adds its own share: none of the partials is zero
    assert (parts.abs().amax((1, 2)) > 0).all()


def test_a_dh_range_without_a_label_is_the_softmax_term_alone():
    h, w, y = _data(2)
    y[:] = 5                                   # every label in range 0
    ht, wt, yt = (torch.from_numpy(h), torch.from_numpy(w.T.copy()),
                  torch.from_numpy(y))
    lse = ce_forward_reference(ht, wt, yt)[0]
    lo, hi = 200, 330
    got = ce_dh_partial_reference(ht, wt, yt, lse, lo, hi)
    p = torch.softmax(ht @ wt.t(), -1)[:, lo:hi]
    torch.testing.assert_close(got, p @ wt[lo:hi], **TOL)
    # one range is the whole dh, cast to the requested dtype
    whole = ce_dh_combine_reference(
        ce_dh_partial_reference(ht, wt, yt, lse, 0, V)[None], torch.float32)
    torch.testing.assert_close(whole, ce_dh_reference(ht, wt, yt, lse),
                               **TOL)


def test_the_combine_sums_in_range_order():
    """The card's combine adds range 1, then 2, ... to range 0: the plain
    version rounds the same way (1 + 2^-24 + 2^-24 stays 1 in f32 left to
    right)."""
    parts = torch.tensor([[[1.0]], [[2.0 ** -24]], [[2.0 ** -24]]])
    assert ce_dh_combine_reference(parts).item() == 1.0
    assert ce_dh_combine_reference(parts.flip(0)).item() > 1.0


def test_f32_planners_cover_the_vocabulary_with_no_empty_range():
    fr, fc, fk, fctas = FWD_TILE
    hr, hv, hc, hctas = DH_TILE
    for sms in (132, 114, 8):
        for n in (1, 2, 127, 128, 129, 1000, 8192, 10000, 65536):
            for v in (1, 100, 255, 256, 257, 1000, 4097, 30000, 32768,
                      50257):
                for s, per, tiles in (
                        ce_fwd_splits(n, v, sms, fr, fc, fctas)
                        + (-(-v // fc),),
                        ce_dh_splits(n, 768, v, sms, hr, hv, hc, hctas)
                        + (-(-v // hv),),
                        ce_dh_splits(n, 1152, v, sms, hr, hv, hc, hctas)
                        + (-(-v // hv),)):
                    assert 1 <= s <= tiles, (sms, n, v, s)
                    assert (s - 1) * per < tiles <= s * per, (sms, n, v, s,
                                                              per)
    # the ZeRO phase's batch and the f32 LM loss of batch 4 x 2048 on an
    # H100's 132 SMs: 128 CTAs or more, few ranges at N 8192
    fwd = {n: ce_fwd_plan(n, 768, 32768, 132, fr, fc, fk, fctas, 4)
           for n in (1024, 8192)}
    assert fwd[1024]["grid"] == (8, 16) and fwd[1024]["per"] == 16
    assert fwd[8192]["grid"] == (64, 2) and fwd[8192]["per"] == 128
    assert fwd[8192]["smem_bytes"] == 64 * 256 * 12 * (128 + 128) * 64 * 4
    dh = {n: ce_dh_plan(n, 768, 32768, 132, *DH_TILE) for n in (1024, 8192)}
    assert dh[1024]["grid"] == (32, 4, 1)
    assert dh[1024]["workspace_bytes"] == 4 * 4 * 1024 * 768
    assert dh[8192]["grid"] == (256, 1, 1)
    assert dh[8192]["workspace_bytes"] == 0
    # D past one chunk: two chunks, each recomputing the logits
    assert ce_dh_plan(1024, 1152, 32768, 132, *DH_TILE)["grid"] == (32, 2, 2)


def test_the_dh_kernel_wrapper_refuses_cpu_tensors():
    h, w, y = _data(3)
    ht, wt, yt = (torch.from_numpy(h), torch.from_numpy(w.T.copy()),
                  torch.from_numpy(y))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ce_dh_cuda(ht, wt, yt, torch.zeros(N))


@pytest.mark.parametrize("d", [4, 36, 768, 772, 1152, 1544])
def test_the_dh_grid_covers_every_row_and_column_once(d):
    """The dh grid's row blocks and D chunks tile [N, D] with no chunk
    left empty, and its workspace holds one [N, D] slice a range."""
    rows, _, chunk, _ = DH_TILE
    for n in (1, 32, 33, 1024, 8192):
        plan = ce_dh_plan(n, d, 32768, 132, *DH_TILE)
        blocks, splits, chunks = plan["grid"]
        assert (blocks - 1) * rows < n <= blocks * rows
        assert (chunks - 1) * chunk < d <= chunks * chunk
        assert splits == plan["splits"] >= 1
        assert plan["workspace_bytes"] == (4 * splits * n * d
                                           if splits > 1 else 0)
