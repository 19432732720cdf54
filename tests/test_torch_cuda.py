"""Card-only tests of the port's hand-written CUDA kernel. A CUDA kernel
has no CPU mode, so without a GPU every test here skips.

This file imports no JAX, so it runs on a GPU machine without the JAX
package's test set-up:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: f32 at rtol = atol = 1e-4; bf16 out at 2e-2 and lse at 2e-3
absolute (the kernel and its plain version round P and O to bf16 at the
same places but sum in different orders).
"""

import pytest
import torch

from chainermn_torch.models.transformer import TransformerLM
from chainermn_torch.ops import _cuda
from chainermn_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_cuda,
                                                 flash_attention_reference)
from chainermn_torch.serving.kv_cache import init_cache, prefill_apply

pytestmark = pytest.mark.cuda

# name: (b, lq, lk, hq, hkv, d, dtype, causal, window, segments)
CASES = {
    "mha-bf16": (2, 256, 256, 4, 4, 64, torch.bfloat16, True, None, False),
    "gqa-bf16": (2, 200, 200, 8, 2, 64, torch.bfloat16, True, None, False),
    "mqa-f32-d8": (1, 70, 70, 4, 1, 8, torch.float32, True, None, False),
    "window-f32": (1, 300, 300, 4, 2, 32, torch.float32, True, 37, False),
    "segments-f32": (2, 130, 130, 4, 2, 64, torch.float32, True, None,
                     True),
    "noncausal-lq-ne-lk-d128": (1, 65, 150, 2, 2, 128, torch.float32,
                                False, None, False),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(cuda, name):
    b, lq, lk, hq, hkv, d, dtype, causal, window, segments = CASES[name]
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, lq, hq, d, device=cuda, generator=gen).to(dtype)
    k = torch.randn(b, lk, hkv, d, device=cuda, generator=gen).to(dtype)
    v = torch.randn(b, lk, hkv, d, device=cuda, generator=gen).to(dtype)
    seg = None
    if segments:
        ks = torch.zeros(b, lk, dtype=torch.int32, device=cuda)
        ks[:, lk // 2:] = 1
        qs = ks.clone()
        qs[0, 3] = -1
        seg = (qs, ks)
    out, lse = flash_attention_cuda(q, k, v, causal, None, seg, window)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_reference(q, k, v, causal, None, seg,
                                                 window)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref_out, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                                   atol=2e-2)
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=2e-3)
    if segments:
        assert (out[0, 3] == 0).all()


def test_dispatcher_launches_the_kernel_for_cuda_tensors(cuda):
    q = torch.randn(1, 64, 2, 16, device=cuda)
    before = _cuda.launches()["flash_fwd"]
    flash_attention(q, q, q, causal=True)
    assert _cuda.launches()["flash_fwd"] == before + 1
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half(), causal=True)


def test_prefill_launches_once_per_layer(cuda):
    model = TransformerLM(vocab=64, d_model=64, n_heads=4, n_layers=3,
                          d_ff=128, max_len=64, pos_emb="rope",
                          dtype=torch.bfloat16, device=cuda)
    cache = init_cache(model, 2, 32)
    toks = torch.randint(0, 64, (2, 32), device=cuda)
    before = _cuda.launches()["flash_fwd"]
    logits, _ = prefill_apply(model, cache, toks, [32, 20], [0, 1])
    assert _cuda.launches()["flash_fwd"] == before + 3
    assert torch.isfinite(logits).all()
