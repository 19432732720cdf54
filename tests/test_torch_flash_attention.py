"""Port parity: chainermn_torch's flash-attention forward (its plain
PyTorch version, which CPU tensors run) against the JAX package's
flash_attention, whose Pallas kernel runs in interpret mode on the CPU.

Inputs are made with numpy from a seed and fed to both. Tolerance: f32
at rtol = atol = 1e-4 (the two sum in different orders: tiled online
softmax vs one dense pass); bf16 outputs at 2e-2 (one bf16 rounding of
the output and of P apart).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chainermn_tpu.ops.flash_attention import _flash_fwd
from chainermn_tpu.ops.flash_attention import flash_attention as jax_flash
from chainermn_torch.ops import _cuda
from chainermn_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_cuda,
                                                 flash_attention_reference)

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


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_arguments():
    q = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, q, q, causal=True)
    with pytest.raises(ValueError, match="requires causal"):
        flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(torch.zeros(1, 8, 3, 8), q, q)
