"""The f32 fused CE's splits on the CPU: the plain versions of its forward
ranges at the f32 tile width, of its dh ranges (of the vocabulary) and of
its dW ranges (of h's rows), held to the whole plain versions and to
JAX's fused_ce_head (Pallas, interpret mode), and the planners that pick
its ranges.

Inputs are made with numpy from a seed and fed to both. Tolerance: rtol =
atol = 1e-4 (the ranges and JAX sum in different orders); argmax exact.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.ops.fused_ce import fused_ce_head as jax_fused_ce_head
from chainermn_torch.ops.fused_ce import (ce_dh_cuda, ce_dh_partial_reference,
                                          ce_dh_plan, ce_dh_reference,
                                          ce_dh_splits, ce_dw_cuda,
                                          ce_dw_partial_reference,
                                          ce_dw_plan, ce_dw_reference,
                                          ce_dw_splits, ce_forward_reference,
                                          ce_fwd_combine_reference,
                                          ce_fwd_partial_reference,
                                          ce_fwd_plan, ce_fwd_splits,
                                          ce_sum_ranges_reference)

from tests.test_torch_cuda import F32_DH_TILE as DH_TILE
from tests.test_torch_cuda import F32_DW_TILE as DW_TILE
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
    dh = ce_sum_ranges_reference(parts)
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
    whole = ce_sum_ranges_reference(
        ce_dh_partial_reference(ht, wt, yt, lse, 0, V)[None], torch.float32)
    torch.testing.assert_close(whole, ce_dh_reference(ht, wt, yt, lse),
                               **TOL)


def test_the_combine_sums_in_range_order():
    """The card's combine adds range 1, then 2, ... to range 0: the plain
    version rounds the same way (1 + 2^-24 + 2^-24 stays 1 in f32 left to
    right)."""
    parts = torch.tensor([[[1.0]], [[2.0 ** -24]], [[2.0 ** -24]]])
    assert ce_sum_ranges_reference(parts).item() == 1.0
    assert ce_sum_ranges_reference(parts.flip(0)).item() > 1.0


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


def _jax_dw(h, w, y):
    """Unscaled dWᵀ = dlᵀ . h ``[V, D]`` from JAX fused_ce_head's
    custom_vjp (Pallas, interpret mode): its dW is the mean loss's,
    hᵀ . dl / N, in the head's [D, V] layout."""
    def f(w):
        return jax_fused_ce_head(jnp.asarray(h), w, jnp.asarray(y), 64,
                                 128)[0]

    _, vjp = jax.vjp(f, jnp.asarray(w))
    return np.asarray(vjp(jnp.ones(()))[0]).T * h.shape[0]


def _row_bounds(width):
    return list(zip(range(0, N, width), list(range(width, N, width)) + [N]))


@pytest.mark.parametrize("width", [DW_TILE[1], 40])
def test_dw_ranges_sum_to_the_whole_dw_and_to_jax(width):
    """The f32 dW's split, dh's mirror image: ranges of ``width`` rows of h
    (the last ragged; the kernel's 256-row tile makes one range of the
    96 rows), partials summed in range order. The sum equals
    ce_dw_reference and JAX's gradient in w within 1e-5."""
    h, w, y = _data(4)
    bounds = _row_bounds(width)
    ht, wt, yt = (torch.from_numpy(h), torch.from_numpy(w.T.copy()),
                  torch.from_numpy(y))
    lse = ce_forward_reference(ht, wt, yt)[0]
    parts = torch.stack([ce_dw_partial_reference(ht, wt, yt, lse, lo, hi)
                         for lo, hi in bounds])
    assert parts.dtype == torch.float32 and parts.shape == (len(bounds), V, D)
    dwt = ce_sum_ranges_reference(parts)
    torch.testing.assert_close(dwt, ce_dw_reference(ht, wt, yt, lse), **TOL)
    np.testing.assert_allclose(dwt.numpy(), _jax_dw(h, w, y), rtol=1e-5,
                               atol=1e-5)
    assert (parts.abs().amax((1, 2)) > 0).all()


def test_a_dw_range_adds_the_softmax_term_alone_where_it_holds_no_label():
    """In a range of h's rows, the vocabulary rows that no row of the
    range has as its label get p . h alone; the labelled ones also lose
    their rows of h."""
    h, w, y = _data(5)
    lo, hi = 30, 70
    y[lo:hi] = 9                               # one label in the range
    ht, wt, yt = (torch.from_numpy(h), torch.from_numpy(w.T.copy()),
                  torch.from_numpy(y))
    lse = ce_forward_reference(ht, wt, yt)[0]
    got = ce_dw_partial_reference(ht, wt, yt, lse, lo, hi)
    p = torch.softmax(ht @ wt.t(), -1)[lo:hi]
    soft = p.t() @ ht[lo:hi]
    free = torch.ones(V, dtype=torch.bool)
    free[9] = False
    torch.testing.assert_close(got[free], soft[free], **TOL)
    torch.testing.assert_close(got[9], soft[9] - ht[lo:hi].sum(0), **TOL)


def test_the_f32_dw_planner_splits_h_rows_only_where_the_vocabulary_is_small():
    """One range (no workspace) at the LM's vocabulary on an H100's 132
    SMs, at the ZeRO phase's N 1024 and the f32 loss's N 8192; a small
    vocabulary fills the card with ranges of h's rows instead."""
    rows, tile, chunk, ctas = DW_TILE
    for n in (1024, 8192):
        plan = ce_dw_plan(n, 768, 32768, 132, *DW_TILE)
        assert plan["splits"] == 1 and plan["workspace_bytes"] == 0
        assert plan["grid"] == (1024, 1, 1)
    small = ce_dw_plan(2048, 768, 300, 132, *DW_TILE)
    assert small["splits"] > 1
    assert small["grid"] == (10, small["splits"], 1)
    assert small["workspace_bytes"] == 4 * small["splits"] * 300 * 768
    for sms in (132, 114, 8):
        for n in (1, 255, 256, 257, 1000, 8192, 65536):
            for v in (1, 31, 33, 300, 4097, 32768, 50257):
                s, per = ce_dw_splits(n, 768, v, sms, rows, tile, chunk,
                                      ctas)
                tiles = -(-n // tile)
                assert 1 <= s <= tiles, (sms, n, v, s)
                assert (s - 1) * per < tiles <= s * per, (sms, n, v, s, per)


@pytest.mark.parametrize("d", [4, 36, 768, 772, 1152, 1544])
def test_the_dw_grid_covers_every_vocabulary_row_and_column_once(d):
    """The dW grid's vocabulary blocks and D chunks tile dWᵀ [V, D] with no
    chunk left empty, its ranges cover h's row tiles with none empty, and
    its workspace holds one [V, D] slice a range."""
    rows, tile, chunk, _ = DW_TILE
    for n in (1, 256, 257, 1024, 8192):
        for v in (1, 32, 33, 300, 32768):
            plan = ce_dw_plan(n, d, v, 132, *DW_TILE)
            blocks, splits, chunks = plan["grid"]
            assert (blocks - 1) * rows < v <= blocks * rows
            assert (chunks - 1) * chunk < d <= chunks * chunk
            tiles = -(-n // tile)
            assert splits == plan["splits"] >= 1
            assert (splits - 1) * plan["per"] < tiles <= splits * plan["per"]
            assert plan["workspace_bytes"] == (4 * splits * v * d
                                               if splits > 1 else 0)


def test_the_dw_kernel_wrapper_refuses_cpu_tensors():
    h, w, y = _data(6)
    ht, wt, yt = (torch.from_numpy(h), torch.from_numpy(w.T.copy()),
                  torch.from_numpy(y))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ce_dw_cuda(ht, wt, yt, torch.zeros(N))
