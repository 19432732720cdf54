"""Port parity: chainermn_torch's flash-attention forward and backward
(the plain PyTorch versions, which CPU tensors run) against the JAX
package's flash_attention, whose Pallas kernels run in interpret mode on
the CPU.

Inputs are made with numpy from a seed and fed to both. Tolerance: f32
at rtol = atol = 1e-4 (the two sum in different orders: tiled online
softmax vs one dense pass); bf16 outputs at 2e-2 (one bf16 rounding of
the output and of P apart).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.ops.flash_attention import _flash_fwd
from chainermn_tpu.ops.flash_attention import flash_attention as jax_flash
from chainermn_torch.ops import _cuda
from chainermn_torch.ops.flash_attention import (
    flash_attention, flash_attention_backward_reference,
    flash_attention_bwd_cuda, flash_attention_cuda, flash_attention_reference)

TOL = dict(rtol=1e-4, atol=1e-4)

# name: (b, l, hq, hkv, d, causal, window, segments)
CASES = {
    "mha-causal": (2, 64, 4, 4, 16, True, None, False),
    "mha-noncausal": (2, 64, 4, 4, 16, False, None, False),
    "gqa": (2, 64, 4, 2, 16, True, None, False),
    "mqa": (1, 64, 4, 1, 16, True, None, False),
    "window": (1, 64, 4, 2, 16, True, 24, False),
    "segments": (2, 64, 4, 2, 16, True, None, True),
    "ragged-100": (1, 100, 4, 4, 16, True, None, False),
}


def _inputs(b, l, hq, hkv, d, segments, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, l, hq, d).astype(dtype)
    k = rng.randn(b, l, hkv, d).astype(dtype)
    v = rng.randn(b, l, hkv, d).astype(dtype)
    seg = None
    if segments:
        kv_seg = np.zeros((b, l), np.int32)
        kv_seg[:, l // 2:] = 1
        q_seg = kv_seg.copy()
        q_seg[0, 5] = -1        # a query row that matches no key at all
        seg = (q_seg, kv_seg)
    return q, k, v, seg


def _jax_fwd(q, k, v, causal, window, seg):
    """(out, lse [B, H, L]) from the JAX forward rule, which runs
    _flash_fwd_3d (the Pallas kernel) in interpret mode here."""
    jseg = None if seg is None else tuple(jnp.asarray(s) for s in seg)
    out, res = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal, None, 1024, 1024, True, jseg, window)
    b, l, h, _ = q.shape
    lse = np.asarray(res[4]).reshape(b, h, -1)[:, :, :l]
    return np.asarray(out), lse


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_forward_matches_pallas_kernel(name):
    b, l, hq, hkv, d, causal, window, segments = CASES[name]
    q, k, v, seg = _inputs(b, l, hq, hkv, d, segments)
    ref_out, ref_lse = _jax_fwd(q, k, v, causal, window, seg)
    out, lse = flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        segment_ids=None if seg is None else tuple(
            torch.from_numpy(s) for s in seg),
        window=window)
    np.testing.assert_allclose(out.numpy(), ref_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, **TOL)
    if segments:
        # a fully masked row is exactly zero, with lse at the finite -1e30
        assert (out[0, 5] == 0).all()
        assert (lse[0, :, 5] <= -1e29).all()


def test_flash_attention_entry_matches_jax_entry():
    """The public entry points agree (out only), through the dispatcher."""
    q, k, v, _ = _inputs(2, 48, 4, 2, 16, False, seed=1)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True))
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_bf16_casts_p_like_the_kernel():
    """bf16 inputs: P is rounded to bf16 before P·V in both; outputs
    agree to bf16 precision (2e-2)."""
    q, k, v, _ = _inputs(1, 64, 4, 4, 16, False, seed=2)
    qj, kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(jax_flash(qj, kj, vj, causal=True).astype(jnp.float32))
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2e-2,
                               atol=2e-2)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    q, k, v, _ = _inputs(1, 16, 2, 2, 8, False)
    before = _cuda.launches()["flash_fwd"]
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True)
    ref_out, _ = flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), True)
    assert torch.equal(out, ref_out)
    assert _cuda.launches()["flash_fwd"] == before


# name: (b, lq, lk, hq, hkv, d, causal, window, segments)
BWD_CASES = {
    "mha-causal": (2, 64, 64, 4, 4, 16, True, None, False),
    "mha-noncausal": (2, 64, 64, 4, 4, 16, False, None, False),
    "gqa": (2, 64, 64, 4, 2, 16, True, None, False),
    "mqa": (1, 64, 64, 4, 1, 16, True, None, False),
    "window": (1, 64, 64, 4, 2, 16, True, 24, False),
    "segments": (2, 64, 64, 4, 2, 16, True, None, True),
    "ragged-100": (1, 100, 100, 4, 4, 16, True, None, False),
    "noncausal-lq-ne-lk": (1, 40, 72, 4, 2, 16, False, None, False),
    "causal-lq-ne-lk": (1, 40, 72, 4, 2, 16, True, None, False),
}


def _bwd_inputs(b, lq, lk, hq, hkv, d, segments, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, lq, hq, d).astype(np.float32)
    k = rng.randn(b, lk, hkv, d).astype(np.float32)
    v = rng.randn(b, lk, hkv, d).astype(np.float32)
    do = rng.randn(b, lq, hq, d).astype(np.float32)
    seg = None
    if segments:
        kv_seg = np.zeros((b, lk), np.int32)
        kv_seg[:, lk // 2:] = 1
        q_seg = np.zeros((b, lq), np.int32)
        q_seg[:, lq // 2:] = 1
        q_seg[0, 5] = -1        # a query row that matches no key at all
        seg = (q_seg, kv_seg)
    return q, k, v, do, seg


@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_backward_matches_jax_grad_of_pallas_kernel(name):
    """dq, dk, dv of the port's differentiable entry (the plain backward
    on CPU tensors) against ``jax.vjp`` of the JAX flash_attention, whose
    backward runs the fused or the split Pallas kernels in interpret
    mode; f32 at 1e-4."""
    b, lq, lk, hq, hkv, d, causal, window, segments = BWD_CASES[name]
    q, k, v, do, seg = _bwd_inputs(b, lq, lk, hq, hkv, d, segments)
    jseg = None if seg is None else tuple(jnp.asarray(s) for s in seg)
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash(q_, k_, v_, causal, None, 1024, 1024,
                                     None, jseg, window),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(
        qt, kt, vt, causal=causal, window=window,
        segment_ids=None if seg is None else tuple(
            torch.from_numpy(s) for s in seg))
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, **TOL)
    if segments:
        # the row that matches no key gets exactly zero gradient
        assert (got[0][0, 5] == 0).all()


def test_backward_reference_sums_gqa_groups_and_casts_like_the_kernel():
    """The plain backward on its own: GQA dk/dv are the per-query-head
    gradients summed over each group, returned in the inputs' dtype."""
    q, k, v, do, _ = _bwd_inputs(1, 32, 32, 4, 2, 16, False, seed=3)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = flash_attention_reference(qt, kt, vt, True)
    dq, dk, dv = flash_attention_backward_reference(qt, kt, vt, out, lse,
                                                    dot, True)
    kr, vr = (x.repeat_interleave(2, dim=2).requires_grad_()
              for x in (kt, vt))
    qr = qt.clone().requires_grad_()
    out_r, _ = flash_attention_reference(qr, kr, vr, True)
    gq, gk, gv = torch.autograd.grad(out_r, (qr, kr, vr), dot)
    torch.testing.assert_close(dq, gq, **TOL)
    torch.testing.assert_close(dk, gk.reshape(1, 32, 2, 2, 16).sum(3), **TOL)
    torch.testing.assert_close(dv, gv.reshape(1, 32, 2, 2, 16).sum(3), **TOL)
    bf = [x.to(torch.bfloat16) for x in (qt, kt, vt)]
    ob, lb = flash_attention_reference(*bf, True)
    grads = flash_attention_backward_reference(*bf, ob, lb,
                                               dot.to(torch.bfloat16), True)
    assert all(g.dtype == torch.bfloat16 for g in grads)


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_arguments():
    q = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, q, q, causal=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_cuda(q, q, q, q, torch.zeros(1, 2, 8), q,
                                 causal=True)
    with pytest.raises(ValueError, match="requires causal"):
        flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(torch.zeros(1, 8, 3, 8), q, q)
