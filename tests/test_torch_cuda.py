"""Card-only tests of the port's hand-written CUDA kernels (flash
forward and backward, the fused CE's forward, dh and dW) and of the
training step on the card. A CUDA kernel has no CPU mode, so without a
GPU every test here skips.

This file imports no JAX, so it runs on a GPU machine without the JAX
package's test set-up:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: f32 at rtol = atol = 1e-4. bf16 outputs (flash out, dq, dk,
dv, dh, dW) may sit two bf16 roundings apart (an intermediate, P, dS or
the CE's dl, is rounded from f32 values that differ in their last bits,
then the output is rounded), and each entry is held to its own vector's
scale so small vectors are checked as closely as large ones: |err| <=
2e-2 |ref| + 3e-2 rms(ref vector) + 1e-3 rms(ref tensor), a vector being
the last axis (:func:`_assert_bf16_close`; the reasoning is in
``chip_smoke.py`` beside ``TOL_BF16_REL``).
bf16 lse and CE statistics at 2e-3 and 1e-3 absolute.
"""

import pytest
import torch

from chainermn_torch.comm import create_communicator
from chainermn_torch.models.transformer import TransformerLM
from chainermn_torch.ops import _cuda
from chainermn_torch.ops.flash_attention import (
    flash_attention, flash_attention_backward_reference,
    flash_attention_bwd_cuda, flash_attention_cuda, flash_attention_reference)
from chainermn_torch.ops.fused_ce import (ce_dh_cuda, ce_dh_reference,
                                          ce_dw_cuda, ce_dw_reference,
                                          ce_forward_cuda,
                                          ce_forward_reference,
                                          fused_ce_head, fused_lm_loss)
from chainermn_torch.optimizers import create_multi_node_optimizer
from chainermn_torch.serving.kv_cache import init_cache, prefill_apply
from chainermn_torch.training import make_data_parallel_train_step

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
    "d48-f32": (1, 200, 200, 4, 2, 48, torch.float32, True, None, False),
    "d96-f32": (1, 200, 200, 4, 2, 96, torch.float32, True, None, False),
    # the tensor-core (bf16) paths beyond d 64 and the plain causal mask
    "window-bf16-d32": (1, 300, 300, 4, 2, 32, torch.bfloat16, True, 37,
                        False),
    "segments-bf16": (2, 130, 130, 4, 2, 64, torch.bfloat16, True, None,
                      True),
    "mqa-bf16-d8": (1, 70, 70, 4, 1, 8, torch.bfloat16, True, None, False),
    "noncausal-lq-ne-lk-d128-bf16": (1, 65, 150, 2, 2, 128, torch.bfloat16,
                                     False, None, False),
    "d40-bf16": (1, 200, 200, 4, 2, 40, torch.bfloat16, True, None, False),
    "d48-bf16": (1, 200, 200, 4, 2, 48, torch.bfloat16, True, None, False),
    "d96-bf16": (1, 200, 200, 4, 2, 96, torch.bfloat16, True, None, False),
    "ragged-1000-bf16": (1, 1000, 1000, 4, 4, 64, torch.bfloat16, True,
                         None, False),
}


def _assert_bf16_close(got, ref):
    """The bf16 rule of the module docstring."""
    g, r = got.float(), ref.float()
    tol = (2e-2 * r.abs() + 3e-2 * r.pow(2).mean(-1, keepdim=True).sqrt()
           + 1e-3 * r.pow(2).mean().sqrt())
    bad = (g - r).abs() > tol
    assert not bad.any(), (f"{int(bad.sum())} entries out of tolerance, "
                           f"max error {(g - r).abs().max().item():.3g}")


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
        _assert_bf16_close(out, ref_out)
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


def _qkv(cuda, b, lq, lk, hq, hkv, d, dtype, segments, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, do = (torch.randn(b, lq, hq, d, device=cuda, generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, lk, hkv, d, device=cuda, generator=gen).to(dtype)
            for _ in range(2))
    seg = None
    if segments:
        ks = torch.zeros(b, lk, dtype=torch.int32, device=cuda)
        ks[:, lk // 2:] = 1
        qs = torch.zeros(b, lq, dtype=torch.int32, device=cuda)
        qs[:, lq // 2:] = 1
        qs[0, 3] = -1
        seg = (qs, ks)
    return q, k, v, do, seg


BWD_CASES = dict(CASES, **{
    "causal-lq-ne-lk-bf16": (1, 100, 300, 4, 2, 64, torch.bfloat16, True,
                             None, False),
})


@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_flash_bwd_matches_plain_version(cuda, name):
    b, lq, lk, hq, hkv, d, dtype, causal, window, segments = BWD_CASES[name]
    q, k, v, do, seg = _qkv(cuda, b, lq, lk, hq, hkv, d, dtype, segments)
    out, lse = flash_attention_reference(q, k, v, causal, None, seg, window)
    got = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal, None, seg,
                                   window)
    torch.cuda.synchronize()
    ref = flash_attention_backward_reference(q, k, v, out, lse, do, causal,
                                             None, seg, window)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
        else:
            _assert_bf16_close(g, r)
    if segments:
        assert (got[0][0, 3] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_negative_scale_matches_plain_version(cuda, dtype):
    """The forward kernel folds a non-negative scale into its exponent;
    the wrapper runs a negative one as (-q)·kᵀ·|scale|."""
    q, k, v, do, _ = _qkv(cuda, 1, 130, 130, 4, 2, 64, dtype, False)
    out, lse = flash_attention_cuda(q, k, v, True, -0.1)
    got = flash_attention_bwd_cuda(q, k, v, out, lse, do, True, -0.1)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_reference(q, k, v, True, -0.1)
    ref = flash_attention_backward_reference(q, k, v, out, lse, do, True,
                                             -0.1)
    for g, r in zip((out, *got), (ref_out, *ref)):
        if dtype == torch.float32:
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
        else:
            _assert_bf16_close(g, r)
    tol = 1e-4 if dtype == torch.float32 else 2e-3
    torch.testing.assert_close(lse, ref_lse, rtol=tol, atol=tol)


def test_gradient_flows_through_the_cuda_flash_path(cuda):
    """q, k and v receive their gradients from flash_bwd through the
    autograd Function (the repair of an output with no graph), equal to
    the plain path's on the CPU."""
    q, k, v, do, _ = _qkv(cuda, 2, 96, 96, 4, 2, 32, torch.float32, False)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = _cuda.launches()
    out = flash_attention(*leaves, causal=True)
    assert out.requires_grad
    grads = torch.autograd.grad(out, leaves, do)
    after = _cuda.launches()
    assert after["flash_fwd"] == before["flash_fwd"] + 1
    assert after["flash_bwd"] == before["flash_bwd"] + 1
    cpu = [x.detach().cpu().requires_grad_() for x in (q, k, v)]
    ref = torch.autograd.grad(flash_attention(*cpu, causal=True), cpu,
                              do.cpu())
    for g, r in zip(grads, ref):
        assert g.abs().max() > 0
        torch.testing.assert_close(g.cpu(), r, rtol=1e-4, atol=1e-4)


# name: (n, d, v, dtype, ties)
CE_CASES = {
    "f32-ragged": (100, 32, 300, torch.float32, False),
    "bf16": (200, 64, 1000, torch.bfloat16, False),
    "bf16-ties": (64, 32, 512, torch.bfloat16, True),
}


def _ce_inputs(cuda, n, d, v, dtype, ties):
    gen = torch.Generator(device=cuda).manual_seed(1)
    if ties:
        h = torch.randint(-2, 3, (n, d), device=cuda, generator=gen)
        half = torch.randint(-2, 3, (v // 2, d), device=cuda, generator=gen)
        wt = torch.cat([half, half])
    else:
        # logits with a std of about 2 to 3: a peaked softmax, so the
        # softmax term of dh and dW is not swamped by the one-hot term
        h = torch.randn(n, d, device=cuda, generator=gen)
        wt = torch.randn(v, d, device=cuda, generator=gen) * 0.35
    y = torch.randint(0, v, (n,), device=cuda, generator=gen,
                      dtype=torch.int32)
    return h.to(dtype), wt.to(dtype), y


@pytest.mark.parametrize("name", sorted(CE_CASES))
def test_fused_ce_kernels_match_plain_versions(cuda, name):
    n, d, v, dtype, ties = CE_CASES[name]
    h, wt, y = _ce_inputs(cuda, n, d, v, dtype, ties)
    lse, tl, am = ce_forward_cuda(h, wt, y)
    dh = ce_dh_cuda(h, wt, y, lse)
    dwt = ce_dw_cuda(h, wt, y, lse)
    torch.cuda.synchronize()
    r_lse, r_tl, r_am = ce_forward_reference(h, wt, y)
    r_dh = ce_dh_reference(h, wt, y, r_lse)
    r_dw = ce_dw_reference(h, wt, y, r_lse)
    stat = 1e-4 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(lse, r_lse, rtol=stat, atol=stat)
    torch.testing.assert_close(tl, r_tl, rtol=stat, atol=stat)
    assert torch.equal(am, r_am)
    if ties:
        assert (am < v // 2).all()
    for got, ref in ((dh, r_dh), (dwt, r_dw)):
        assert got.dtype == ref.dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        else:
            _assert_bf16_close(got, ref)


def test_fused_ce_head_differentiates_through_the_kernels(cuda):
    h, wt, y = _ce_inputs(cuda, 100, 32, 300, torch.float32, False)
    hl = h.clone().requires_grad_()
    wl = wt.t().clone().requires_grad_()        # [D, V], as fused_ce_head
    before = _cuda.launches()
    loss, acc = fused_ce_head(hl, wl, y)
    loss.backward()
    after = _cuda.launches()
    assert [after[k] - before[k] for k in ("ce_fwd", "ce_dh", "ce_dw")] \
        == [1, 1, 1]
    hc = h.cpu().requires_grad_()
    wc = wt.t().cpu().requires_grad_()
    ref = torch.nn.functional.cross_entropy(hc @ wc, y.cpu().long())
    ref.backward()
    torch.testing.assert_close(loss.cpu(), ref.detach(), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(hl.grad.cpu(), hc.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(wl.grad.cpu(), wc.grad, rtol=1e-4, atol=1e-4)


def test_train_step_on_the_card_runs_the_kernels(cuda):
    """One ``make_data_parallel_train_step`` call (two scanned steps) of a
    small bf16 LM with the fused loss on one NCCL rank: every kernel of
    the path launches its expected count and the losses are finite."""
    comm = create_communicator("pure_nccl")
    try:
        torch.manual_seed(0)
        model = TransformerLM(vocab=512, d_model=64, n_heads=4, n_layers=2,
                              d_ff=128, max_len=64, pos_emb="rope",
                              dtype=torch.bfloat16, device=cuda)
        opt = create_multi_node_optimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3,
                              weight_decay=1e-4), comm)
        step = make_data_parallel_train_step(model, opt, comm,
                                             loss_fn=fused_lm_loss,
                                             scan_steps=2)
        toks = torch.randint(0, 512, (2, 4, 65), device=cuda)
        before = _cuda.launches()
        m = step(toks[..., :-1], toks[..., 1:])
        torch.cuda.synchronize()
        after = _cuda.launches()
        want = {"flash_fwd": 4, "flash_bwd": 4, "ce_fwd": 2, "ce_dh": 2,
                "ce_dw": 2}
        assert {k: after[k] - before[k] for k in want} == want
        assert m["main/loss"].shape == (2,)
        assert torch.isfinite(m["main/loss"]).all()
        assert all(p.dtype == torch.float32 for p in model.parameters())
    finally:
        comm.finalize()
