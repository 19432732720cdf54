"""Card-only tests of the port's hand-written CUDA kernels (flash
forward and backward, the fused CE's forward, dh and dW) and of the
training step on the card (the data-parallel step, a ZeRO-1 step against
the same step on the CPU, and FSDP, plain and over the scanned stack,
against the data-parallel step with their kernel launches, and a pipeline
stage's remat backward through the flash kernels) and of the serving
engines (speculative and int8-page engines on the flash prefill). A CUDA
kernel has no CPU mode, so without a GPU every test here skips.

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
    flash_attention_bwd_cuda, flash_attention_cuda, flash_attention_reference,
    flash_bwd_f32_tile)
from chainermn_torch.ops.fused_ce import (ce_dh_cuda, ce_dh_reference,
                                          ce_dw_cuda, ce_dw_cuda_plan,
                                          ce_dw_reference,
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
    # the f32 body's 128-row tiles: ragged Lq of 129 and 200, causal
    # Lq != Lk both ways, a fully masked row (segments), and every head
    # dim's template (d 16 ... 128: 1, 2 or 4 columns a read)
    "ragged-129-f32-d64": (1, 129, 129, 4, 4, 64, torch.float32, True,
                           None, False),
    "ragged-129-f32-d40": (1, 129, 129, 4, 2, 40, torch.float32, True,
                           None, False),
    "ragged-200-f32-d128": (1, 200, 200, 2, 1, 128, torch.float32, True,
                            None, False),
    "causal-lq-lt-lk-f32-d80": (1, 100, 300, 4, 2, 80, torch.float32,
                                True, None, False),
    "causal-lq-gt-lk-f32-d112": (1, 300, 70, 2, 2, 112, torch.float32,
                                 True, None, False),
    "segments-129-f32-d16": (2, 129, 129, 2, 1, 16, torch.float32, True,
                             None, True),
    "window-200-f32-d64": (1, 200, 200, 2, 2, 64, torch.float32, True, 150,
                           False),
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
    # the f32 body's key tiles (128 keys at d <= 64, 64 above): a ragged
    # last tile (Lk 129: one key; 200), GQA summed in the CTA, a window
    # crossing tile edges, a fully masked row (segments), d 8 and d 128
    # (64-key tiles, swizzled rows), causal Lq > Lk
    "bwd-lk-129-f32": (1, 100, 129, 4, 2, 64, torch.float32, False, None,
                       False),
    "bwd-lk-200-f32": (2, 150, 200, 4, 2, 64, torch.float32, False, None,
                       False),
    "bwd-gqa-12-4-f32": (1, 256, 256, 12, 4, 64, torch.float32, True, None,
                         False),
    "bwd-window-100-f32": (1, 400, 400, 2, 2, 64, torch.float32, True, 100,
                           False),
    "bwd-segments-f32": (2, 200, 200, 4, 2, 64, torch.float32, True, None,
                         True),
    "bwd-d8-f32": (1, 150, 150, 4, 1, 8, torch.float32, True, None, False),
    "bwd-d128-f32": (1, 200, 200, 4, 2, 128, torch.float32, True, None,
                     False),
    "bwd-lq-gt-lk-f32": (1, 300, 129, 4, 2, 64, torch.float32, True, None,
                         False),
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


@pytest.mark.parametrize("name", ["bwd-gqa-12-4-f32", "bwd-window-100-f32",
                                  "bwd-segments-f32", "bwd-d128-f32"])
def test_flash_bwd_f32_dk_dv_are_bitwise_reproducible(cuda, name):
    """The f32 body sums dk and dv in registers in a fixed order, with no
    atomics (dq's f32 atomics land in any order)."""
    b, lq, lk, hq, hkv, d, dtype, causal, window, segments = BWD_CASES[name]
    q, k, v, do, seg = _qkv(cuda, b, lq, lk, hq, hkv, d, dtype, segments)
    out, lse = flash_attention_reference(q, k, v, causal, None, seg, window)
    first = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal, None,
                                     seg, window)
    again = flash_attention_bwd_cuda(q, k, v, out, lse, do, causal, None,
                                     seg, window)
    assert torch.equal(first[1], again[1]) and torch.equal(first[2], again[2])


def test_the_f32_flash_bwd_tile_is_the_one_the_cpu_tests_plan_with(cuda):
    """tests/test_torch_flash_attention.py checks the tiles that
    ``flash_bwd_f32_plan`` visits and masks; the kernel runs the same."""
    for d in range(8, 129, 8):
        assert _cuda.flash_bwd_f32_tile(d) == flash_bwd_f32_tile(d), d


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


def test_pipeline_stage_backward_runs_the_cuda_flash_path(cuda):
    """One stage rank of the interleaved 1F1B schedule (S 1, V 2 chunks,
    the wrap from chunk 0 to chunk 1 kept on the rank) over flash
    TransformerBlocks on the card: each chunk runs its forward twice a
    micro-batch (the forward and its remat in the backward) and its
    backward once, so flash_fwd launches 2·V·M times and flash_bwd V·M;
    the gradients are nonzero and equal the same step on the CPU's plain
    versions at rtol = atol = 1e-4."""
    from types import SimpleNamespace

    from chainermn_torch.examples import train_pipeline_lm as tpl
    from chainermn_torch.models.convert import flax_tree_apply
    from chainermn_torch.models.transformer import TransformerBlock
    from chainermn_torch.parallel import (
        pipeline_interleaved_1f1b_value_and_grad, stack_stage_params)
    from chainermn_torch.parallel.pipeline import tree_leaves, tree_map

    V, M = 2, 3
    args = tpl.parse_args(["--d-model", "64", "--n-heads", "4", "--d-ff",
                           "128", "-L", "96"])
    _, blocks, _ = tpl.init_trees(args, 0, range(V))
    stacked = stack_stage_params(blocks)
    stage = flax_tree_apply(TransformerBlock(64, 4, 128, device="meta"))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(M, 2, 96, 64, generator=g)
    y = torch.randn(M, 2, 96, 64, generator=g)
    one = SimpleNamespace(rank=0, size=1)

    def mse(out, tgt):
        return ((out - tgt) ** 2).mean()

    def run(dev):
        return pipeline_interleaved_1f1b_value_and_grad(
            stage, mse, tree_map(lambda t: t.to(dev), stacked), x.to(dev),
            y.to(dev), one, V)

    _cuda.reset_launches()
    loss, grads = run(cuda)
    launched = _cuda.launches()
    assert launched["flash_fwd"] == 2 * V * M
    assert launched["flash_bwd"] == V * M
    ref_loss, ref = run("cpu")
    torch.testing.assert_close(loss.cpu(), ref_loss, rtol=1e-4, atol=1e-4)
    for got, want in zip(tree_leaves(grads), tree_leaves(ref)):
        assert got.abs().max() > 0
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# name: (n, d, v, dtype, ties)
CE_CASES = {
    "f32-ragged": (100, 32, 300, torch.float32, False),
    "bf16": (200, 64, 1000, torch.bfloat16, False),
    "bf16-ties": (64, 32, 512, torch.bfloat16, True),
    # the bf16 backward's tensor-core kernel: the widest D of one pass,
    # two 768-column chunks of its accumulator (D 776: the second chunk
    # nearly all padding; D 1536: the widest D that fits shared memory),
    # D zero-padded; ragged N, V
    "bf16-d768": (100, 768, 300, torch.bfloat16, False),
    "bf16-d776-chunked": (90, 776, 500, torch.bfloat16, False),
    "bf16-d1024-chunked": (150, 1024, 700, torch.bfloat16, False),
    "bf16-d1536-widest": (70, 1536, 400, torch.bfloat16, False),
    "bf16-d200-padded": (77, 200, 1003, torch.bfloat16, False),
    # the f32 forward and dh (register-tiled FMAs, the vocabulary split
    # into ranges): one row (one row block, many ranges), V below one
    # tile, ties whose columns v and v + V/2 lie in different ranges, D
    # not a whole 16- or 32-deep slab, D past one 768-column chunk of dh's
    # accumulator (772: the second chunk 4 columns wide; 1152: the widest
    # f32 dh before), the ZeRO phase's batch
    "f32-n1": (1, 768, 32768, torch.float32, False),
    # dW on dh's mirror image: D 1544 (refused before: the old f32 dW
    # kept a [32, D] accumulator in shared memory), the f32 LM loss of
    # batch 4 x 2048, and a small vocabulary that splits h's rows into
    # ranges summed from a workspace
    "f32-d1544": (70, 1544, 3000, torch.float32, False),
    "f32-n8192": (8192, 768, 32768, torch.float32, False),
    "f32-dw-ranges": (600, 768, 2000, torch.float32, False),
    "f32-v-below-a-tile": (300, 768, 100, torch.float32, False),
    "f32-ties-across-ranges": (512, 64, 4096, torch.float32, True),
    "f32-d36": (333, 36, 2000, torch.float32, False),
    "f32-d772": (200, 772, 3000, torch.float32, False),
    "f32-d1152": (150, 1152, 2500, torch.float32, False),
    "f32-zero-shape": (1024, 768, 32768, torch.float32, False),
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


@pytest.mark.parametrize("name", ["bf16-d768", "bf16-d1024-chunked",
                                  "f32-ragged", "f32-d1152",
                                  "f32-zero-shape", "f32-d1544",
                                  "f32-dw-ranges"])
def test_fused_ce_backward_is_bitwise_reproducible(cuda, name):
    """No atomics: each output element is owned by one CTA, so two calls
    on the same inputs give the same bits."""
    h, wt, y = _ce_inputs(cuda, *CE_CASES[name])
    lse = ce_forward_cuda(h, wt, y)[0]
    for fn in (ce_dh_cuda, ce_dw_cuda):
        first, second = fn(h, wt, y, lse), fn(h, wt, y, lse)
        torch.cuda.synchronize()
        assert first.abs().max() > 0
        assert torch.equal(first, second)


def test_the_small_vocabulary_case_splits_dw_into_ranges(cuda):
    """``f32-dw-ranges`` runs dW with S > 1 (a workspace and its sum in
    range order) on this card."""
    n, d, v, _, _ = CE_CASES["f32-dw-ranges"]
    assert ce_dw_cuda_plan(n, d, v, cuda)["splits"] > 1


def test_fused_ce_backward_refuses_d_past_shared_memory(cuda):
    h, wt, y = _ce_inputs(cuda, 8, 1544, 16, torch.bfloat16, False)
    lse = ce_forward_cuda(h, wt, y)[0]
    for fn in (ce_dh_cuda, ce_dw_cuda):
        with pytest.raises(ValueError, match="shared memory"):
            fn(h, wt, y, lse)


# the bf16 forward's edges (wgmma over TMA boxes, the vocabulary split
# into ranges): name -> (n, d, v, dtype, ties)
CE_FWD_CASES = {
    # one row: one row block, so every 256-column tile is its own range
    "bf16-n1": (1, 768, 32768, torch.bfloat16, False),
    # V below one tile: columns past V masked in the only tile
    "bf16-v-below-a-tile": (300, 768, 100, torch.bfloat16, False),
    # 16 ranges of 256 columns: v and v + V/2 (equal) in different ranges
    "bf16-ties-across-ranges": (512, 64, 4096, torch.bfloat16, True),
    # D past the backward's 1536: the forward's shared memory is fixed
    "bf16-d1544": (70, 1544, 3000, torch.bfloat16, False),
    # the f32 forward's edges: one row (128 ranges of two 128-column
    # tiles), ties across its 128-column ranges, a wide D (shared memory
    # fixed), the f32 LM loss of batch 4 x 2048 (2 ranges)
    "f32-n1": (1, 768, 32768, torch.float32, False),
    "f32-ties-across-ranges": (512, 64, 4096, torch.float32, True),
    "f32-d1544": (70, 1544, 3000, torch.float32, False),
    "f32-n8192": (8192, 768, 32768, torch.float32, False),
}


@pytest.mark.parametrize("name", sorted(CE_FWD_CASES))
def test_fused_ce_forward_matches_plain_version(cuda, name):
    n, d, v, dtype, ties = CE_FWD_CASES[name]
    h, wt, y = _ce_inputs(cuda, n, d, v, dtype, ties)
    lse, tl, am = ce_forward_cuda(h, wt, y)
    torch.cuda.synchronize()
    r_lse, r_tl, r_am = ce_forward_reference(h, wt, y)
    stat = 1e-4 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(lse, r_lse, rtol=stat, atol=stat)
    torch.testing.assert_close(tl, r_tl, rtol=stat, atol=stat)
    assert torch.equal(am, r_am)
    if ties:
        assert (am < v // 2).all()


@pytest.mark.parametrize("name", ["bf16-n1", "bf16-ties-across-ranges",
                                  "bf16-d1544", "f32-n1",
                                  "f32-ties-across-ranges", "f32-n8192"])
def test_fused_ce_forward_is_bitwise_reproducible(cuda, name):
    """The ranges' partials are combined in a fixed order, no atomics:
    two calls give the same bits."""
    h, wt, y = _ce_inputs(cuda, *CE_FWD_CASES[name])
    first, second = ce_forward_cuda(h, wt, y), ce_forward_cuda(h, wt, y)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("operand", ["h", "wt"])
def test_fused_ce_kernels_refuse_unaligned_operands(cuda, operand):
    """A contiguous view 3 elements into its storage passes every other
    check; the kernels read 16 bytes at a time (and TMA), so each wrapper
    refuses it before a launch instead of faulting on the card."""
    n, d, v = 64, 64, 300
    h, wt, y = _ce_inputs(cuda, n, d, v, torch.bfloat16, False)
    lse = ce_forward_reference(h, wt, y)[0]
    rows = n if operand == "h" else v
    flat = torch.empty(3 + rows * d, dtype=torch.bfloat16, device=cuda)
    view = flat[3:].view(rows, d)
    view.copy_(h if operand == "h" else wt)
    args = (view, wt) if operand == "h" else (h, view)
    before = _cuda.launches()
    for fn, extra in ((ce_forward_cuda, ()), (ce_dh_cuda, (lse,)),
                      (ce_dw_cuda, (lse,))):
        with pytest.raises(ValueError, match="16-byte"):
            fn(*args, y, *extra)
    assert _cuda.launches() == before


def test_fused_lm_loss_launches_each_ce_kernel_once(cuda):
    """The loss hands the kernels aligned h and head (no view the
    alignment check refuses): one ce_fwd, ce_dh and ce_dw per step."""
    torch.manual_seed(0)
    model = TransformerLM(vocab=512, d_model=64, n_heads=4, n_layers=1,
                          d_ff=128, max_len=64, pos_emb="rope",
                          dtype=torch.bfloat16, device=cuda)
    toks = torch.randint(0, 512, (2, 33), device=cuda)
    before = _cuda.launches()
    loss, _ = fused_lm_loss(model, toks[:, :-1], toks[:, 1:])
    loss.backward()
    torch.cuda.synchronize()
    after = _cuda.launches()
    assert [after[k] - before[k] for k in ("ce_fwd", "ce_dh", "ce_dw")] \
        == [1, 1, 1]
    assert torch.isfinite(loss)


def test_fused_lm_loss_on_an_f32_model_launches_each_f32_ce_kernel_once(
        cuda):
    """An f32 TransformerLM (the JAX model's default dtype) runs the f32
    bodies: one ce_fwd, ce_dh and ce_dw launch on f32 inputs a step, none
    on bf16 ones; the gradients of the head (from dW) and of every
    parameter below it (from dh) match the plain path's."""
    torch.manual_seed(0)
    model = TransformerLM(vocab=512, d_model=64, n_heads=4, n_layers=1,
                          d_ff=128, max_len=64, pos_emb="rope",
                          dtype=torch.float32, device=cuda)
    toks = torch.randint(0, 512, (2, 33), device=cuda)
    kinds = ("ce_fwd", "ce_dh", "ce_dw")
    before = (_cuda.launches(torch.float32), _cuda.launches(torch.bfloat16))
    loss, _ = fused_lm_loss(model, toks[:, :-1], toks[:, 1:])
    loss.backward()
    torch.cuda.synchronize()
    after = (_cuda.launches(torch.float32), _cuda.launches(torch.bfloat16))
    assert [after[0][k] - before[0][k] for k in kinds] == [1, 1, 1]
    assert [after[1][k] - before[1][k] for k in kinds] == [0, 0, 0]
    got = {name: p.grad.clone() for name, p in model.named_parameters()}
    assert len(got) > 2
    model.zero_grad()
    hidden = model.forward_hidden(toks[:, :-1])
    logits = hidden @ model.lm_head.weight.t()
    torch.nn.functional.cross_entropy(
        logits.reshape(-1, 512), toks[:, 1:].reshape(-1)).backward()
    for name, p in model.named_parameters():
        torch.testing.assert_close(got[name], p.grad, rtol=1e-4, atol=1e-4,
                                   msg=lambda m, name=name: f"{name}: {m}")


#: the f32 kernels' tiles, which tests/test_torch_fused_ce_f32.py plans
#: with on the CPU: forward (rows, columns, depth, CTAs an SM), dh (rows,
#: vocabulary rows, D chunk, CTAs an SM) and dW, dh's mirror image
#: (vocabulary rows, rows of h, D chunk, CTAs an SM)
F32_FWD_TILE = (128, 128, 64, 1)
F32_DH_TILE = (32, 256, 768, 1)
F32_DW_TILE = (32, 256, 768, 1)


def test_the_f32_tiles_are_the_ones_the_cpu_tests_plan_with(cuda):
    assert _cuda.ce_fwd_tile(torch.float32) == F32_FWD_TILE
    assert _cuda.ce_dh_tile() == F32_DH_TILE
    assert _cuda.ce_dw_tile() == F32_DW_TILE


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


# -- the ViT slice on the card ----------------------------------------------

def test_vit_on_the_card_matches_the_cpu_and_launches_flash(cuda):
    """A small bf16 ViT (``pool="cls"``: 17 tokens) on the card against
    the same model on the CPU: logits within the bf16 rule above (the
    kernels against the plain attention), one ``flash_fwd`` and one
    ``flash_bwd`` per block, and gradients that reach every parameter."""
    from chainermn_torch.models.vit import ViT

    cfg = dict(num_classes=10, image_size=32, patch=8, d_model=64,
               n_layers=2, n_heads=2, d_ff=128, pool="cls",
               dtype=torch.bfloat16)
    torch.manual_seed(0)
    cpu = ViT(**cfg, device="cpu")
    card = ViT(**cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    before = _cuda.launches()
    out = card(x.to(cuda))
    out.float().square().sum().backward()
    after = _cuda.launches()
    assert after["flash_fwd"] - before["flash_fwd"] == 2
    assert after["flash_bwd"] - before["flash_bwd"] == 2
    _assert_bf16_close(out.detach().cpu(), cpu(x).detach())
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in card.parameters())


def test_dropout_keys_on_the_card(cuda):
    """Masks from a generator on the card: the same key gives the same
    mask, another key another; the kept share is 1 - rate; train=False
    returns the input."""
    from chainermn_torch.ops.dropout import dropout, fold_in

    x = torch.ones(256, 1024, device=cuda, dtype=torch.bfloat16)
    a, b = dropout(x, 0.25, 7, True), dropout(x, 0.25, 7, True)
    c = dropout(x, 0.25, fold_in(7, 1), True)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01
    assert torch.equal(a[a != 0], torch.full_like(a[a != 0], 1 / 0.75))
    assert dropout(x, 0.25, 7, False) is x


def test_checkpoint_round_trip_of_card_state(cuda, tmp_path):
    """A state of card tensors (f32 and bf16) saves through page-locked
    host copies and restores bit for bit (on the CPU, in their dtypes);
    ``load_state_dict`` puts them back on the card."""
    from chainermn_torch.extensions import create_multi_node_checkpointer
    from chainermn_torch.models.vit import ViT

    comm = create_communicator("pure_nccl", device="cpu")
    try:
        model = ViT(num_classes=10, image_size=32, patch=8, d_model=32,
                    n_layers=1, n_heads=2, d_ff=64, device=cuda)
        state = {"model": model.state_dict(),
                 "half": torch.randn(5, device=cuda).to(torch.bfloat16)}
        ck = create_multi_node_checkpointer("card", comm, path=str(tmp_path),
                                            async_write=True)
        ck.save(state, 1)
        got, it = ck.maybe_load(None)
        ck.close()
    finally:
        comm.finalize()
    assert it == 1 and got["half"].dtype == torch.bfloat16
    assert torch.equal(got["half"], state["half"].cpu())
    fresh = ViT(num_classes=10, image_size=32, patch=8, d_model=32,
                n_layers=1, n_heads=2, d_ff=64, device=cuda)
    fresh.load_state_dict(got["model"])
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


# -- the gradient reducers on one NCCL rank ----------------------------------

@pytest.mark.parametrize("name", ["flat", "hierarchical", "auto", "bf16",
                                  "int8", "int8-block", "int4-block"])
def test_reducer_on_one_nccl_rank_matches_its_plain_result(cuda, name):
    """Every reducer on a world of one NCCL rank (the sum is the rank's
    own gradient), on leaves of several sizes and magnitudes in 5000-byte
    buckets: flat, hierarchical and auto give the gradient bit for bit;
    bf16 gives its bf16 rounding; the integer formats each element within
    half a quantization step (the block's or bucket's max / qmax), and the
    error-feedback residual is exactly input − output; the bytes handed
    to NCCL equal the plan's wire bytes (the hierarchical reducer's tiers
    are single ranks here, so it calls none)."""
    from chainermn_torch.collectives import make_grad_reducer

    comm = create_communicator("pure_nccl")
    try:
        g = torch.Generator(device=cuda).manual_seed(0)
        leaves = [torch.randn(s, generator=g, device=cuda) * c
                  for s, c in (((37, 19), 1e-2), ((19,), 1.0), ((700,), 3.0),
                               ((5, 3), 0.1))]
        quantized = name not in ("flat", "hierarchical", "auto")
        red = make_grad_reducer("quantized" if quantized else name, comm,
                                bucket_bytes=5000,
                                **({"wire_format": name} if quantized
                                   else {}))
        state = red.init(leaves)
        got = [t.clone() for t in leaves]
        before = comm.collective_bytes
        got, state = red.reduce(got, state)
        torch.cuda.synchronize()
        if name != "hierarchical":  # one rank: no tier has a collective
            assert comm.collective_bytes - before == sum(
                r["wire_bytes"] for r in red.plan(leaves))
        if not quantized:
            assert all(torch.equal(a, b) for a, b in zip(got, leaves))
            return
        flat_in = torch.cat([t.reshape(-1) for t in leaves])
        flat_out = torch.cat([t.reshape(-1) for t in got])
        if name == "bf16":
            assert torch.equal(flat_out, flat_in.bfloat16().float())
        else:
            qmax = 7.0 if name == "int4-block" else 127.0
            k = 256 if name.endswith("-block") else None
            for (_, _, bucket) in red._plan(leaves):
                v = torch.cat([leaves[i].reshape(-1) for i in bucket])
                o = torch.cat([got[i].reshape(-1) for i in bucket])
                pad = (-v.numel()) % (k or v.numel())
                step = torch.nn.functional.pad(v.abs(), (0, pad)).reshape(
                    -1, k or v.numel()).amax(1, keepdim=True) / qmax
                step = step.expand(-1, k or v.numel()).reshape(-1)[
                    :v.numel()]
                assert torch.all((o - v).abs() <= step / 2 * (1 + 1e-6))
        assert torch.equal(torch.cat(list(state)), flat_in - flat_out)
    finally:
        comm.finalize()


# -- ZeRO on the card ---------------------------------------------------------

_ZERO_CPU = r'''
import os, pickle, sys
import torch
from tests.test_torch_cuda import zero_lm_step

with open(sys.argv[1], "wb") as f:
    pickle.dump(zero_lm_step("cpu"), f)
print("RANK0 OK", flush=True)
'''


def zero_lm_step(device):
    """One bucketed ZeRO-1 step (SGD 0.1, momentum 0.9, 16 KiB buckets) of
    a small f32 LM with ``lm_loss_with_aux`` on ``device``, in a world of
    one rank: the loss and the re-assembled parameters (on the CPU)."""
    from chainermn_torch.models.transformer import lm_loss_with_aux
    from chainermn_torch.optimizers import make_zero1_train_step, zero1_params

    comm = create_communicator("pure_nccl", device=device)
    try:
        torch.manual_seed(0)
        model = TransformerLM(vocab=256, d_model=64, n_heads=4, n_layers=2,
                              d_ff=128, max_len=64, device="cpu")
        model.to(device)
        step, state = make_zero1_train_step(
            model, lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
            comm, loss_fn=lm_loss_with_aux, bucket_bytes=16384)
        toks = torch.randint(0, 256, (4, 65),
                             generator=torch.Generator().manual_seed(1))
        before = _cuda.launches()
        m = step(toks[:, :-1].to(device), toks[:, 1:].to(device))
        launched = {k: _cuda.launches()[k] - before[k]
                    for k in ("flash_fwd", "flash_bwd")}
        params = {k: v.cpu() for k, v in
                  zero1_params(state, model, 16384).items()}
        return float(m["main/loss"]), params, launched
    finally:
        comm.finalize()


def test_zero1_step_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The step on one NCCL rank against the same step on a one-rank gloo
    world on the CPU (a subprocess): the loss at rtol 1e-5, every
    parameter at rtol 1e-4 and atol 1e-6 (f32 on both sides, the flash
    kernels against their plain versions), and the card's step launched
    each flash kernel once a layer."""
    from tests.test_torch_mp import assert_ranks_ok, run_world
    import pickle

    out = tmp_path / "cpu.pkl"
    assert_ranks_ok(run_world(_ZERO_CPU, 1, timeout=240, args=[str(out)]))
    want_loss, want, _ = pickle.loads(out.read_bytes())
    loss, got, launched = zero_lm_step("cuda")
    assert launched == {"flash_fwd": 2, "flash_bwd": 2}
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=1e-4, atol=1e-6,
                                   msg=k)


# -- FSDP on the card ---------------------------------------------------------

def _fsdp_runs(form, steps=2):
    """A small f32 LM (2 layers, vocab 256, seq 64, batch 4) on one NCCL
    rank: ``steps`` SGD steps (0.1, momentum 0.9) of the data-parallel
    step with ``fused_lm_loss`` and of the FSDP step (``form`` ``module``:
    the model's parameters sharded, the same loss; ``scan``: the stacked
    tree through ``make_lm_fsdp_scan_loss``). Returns each run's losses
    and final parameters, and the FSDP run's launches and state."""
    from chainermn_torch.models.convert import flax_params, params_from_flax
    from chainermn_torch.models.transformer import (make_lm_fsdp_scan_loss,
                                                    stack_lm_blocks,
                                                    unstack_lm_blocks)
    from chainermn_torch.optimizers import (fsdp_gather_params,
                                            fsdp_shardings,
                                            fsdp_stack_shardings,
                                            make_fsdp_train_step)

    def lm():
        torch.manual_seed(0)
        return TransformerLM(vocab=256, d_model=64, n_heads=4, n_layers=2,
                             d_ff=128, max_len=64, device="cuda")

    def sgd(ps):
        return torch.optim.SGD(ps, lr=0.1, momentum=0.9)

    toks = torch.randint(0, 256, (steps, 4, 65),
                         generator=torch.Generator().manual_seed(1)).cuda()
    comm = create_communicator("pure_nccl")
    try:
        model = lm()
        dp = make_data_parallel_train_step(
            model, create_multi_node_optimizer(sgd(model.parameters()),
                                               comm), comm,
            loss_fn=fused_lm_loss)
        dp_losses = [dp(t[:, :-1], t[:, 1:])["main/loss"].item()
                     for t in toks]
        dp_params = {k: v.detach().cpu() for k, v in
                     model.named_parameters()}
        model = lm()
        if form == "scan":
            packed = stack_lm_blocks(flax_params(model))
            sh = dict(fsdp_shardings(packed, comm),
                      blocks=fsdp_stack_shardings(packed, comm)["blocks"])
            step, state = make_fsdp_train_step(
                None, sgd, comm, packed,
                loss_fn=make_lm_fsdp_scan_loss(model), param_shardings=sh)
        else:
            step, state = make_fsdp_train_step(model, sgd, comm,
                                               loss_fn=fused_lm_loss)
        _cuda.reset_launches()
        losses = [step(t[:, :-1], t[:, 1:])["main/loss"].item()
                  for t in toks]
        launched = _cuda.launches(torch.float32)
        tree = fsdp_gather_params(state)
        if form == "scan":
            tree = unstack_lm_blocks(tree)
        params = params_from_flax(lm(), tree)
        return dp_losses, dp_params, losses, params, launched, state
    finally:
        comm.finalize()


@pytest.mark.parametrize("form", ["module", "scan"])
def test_fsdp_step_on_the_card_launches_the_kernels_and_matches_dp(cuda,
                                                                   form):
    """FSDP on one NCCL rank against the data-parallel step on the same
    rank: losses at rtol 1e-5, parameters at rtol 1e-4 and atol 1e-6
    after 2 steps. The module form reads the gathered ``lm_head`` as a
    transposed view of its flax-layout buffer, which the CE wrapper makes
    contiguous once a call, so the kernels accept it. Launches a step,
    all on f32 inputs: the scan recomputes each block in the backward, so
    flash_fwd twice a layer, flash_bwd once, and each CE kernel once; the
    module form has no remat: flash_fwd once a layer."""
    dp_losses, dp_params, losses, params, launched, state = _fsdp_runs(
        form)
    per_layer = 2 if form == "scan" else 1
    assert launched == {"flash_fwd": 2 * 2 * per_layer, "flash_bwd": 2 * 2,
                        "ce_fwd": 2, "ce_dh": 2, "ce_dw": 2}
    assert losses == pytest.approx(dp_losses, rel=1e-5)
    for k, v in dp_params.items():
        torch.testing.assert_close(params[k], v, rtol=1e-4, atol=1e-6,
                                   msg=k)
    assert state.gathered_bytes == 0 and state.gathered_bytes_peak > 0


def _card_lm(cuda, n_layers, seed):
    torch.manual_seed(seed)
    model = TransformerLM(vocab=512, d_model=128, n_heads=4, n_layers=n_layers,
                          d_ff=256, max_len=256, pos_emb="rope",
                          dtype=torch.float32, device=cuda)
    with torch.no_grad():
        model.lm_head.weight.mul_(8.0)
    return model


def _card_serve(eng, prompts):
    before = _cuda.launches()["flash_fwd"]
    reqs = [eng.submit(p) for p in prompts]
    eng.run_until_drained()
    return [r.tokens for r in reqs], _cuda.launches()["flash_fwd"] - before


def test_speculative_and_int8_engines_serve_on_the_card(cuda):
    """An f32 LM (TF32 off, the LM head scaled 8x so greedy margins stay
    far above the card's chunk-versus-decode difference of a few ulps)
    on the card: the speculative engine (a 1-layer draft, and the target
    as its own draft) gives the plain engine's greedy streams, the
    self-draft pair accepts at least 0.9 of its proposals; an int8-page
    engine serves every request, its decode logits within JAX's
    calibrated bound (10 x half the coarsest resident scale) of an
    f32-page step driven by the same tokens; every engine's prefill
    launches flash_fwd."""
    import numpy as np

    from chainermn_torch.serving.engine import Engine, EngineConfig
    from chainermn_torch.serving.kv_cache import ServingStep
    from chainermn_torch.serving.speculative import SpeculativeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    model, draft = _card_lm(cuda, 2, 0), _card_lm(cuda, 1, 1)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, (n,)) for n in (17, 40, 9, 63, 25, 33)]
    cfg = EngineConfig(n_slots=3, capacity=128, max_new_tokens=21,
                       prefill_cohort=2, buckets=[16, 32, 64, 128])
    want, n = _card_serve(Engine(model, cfg), prompts)
    assert n > 0
    for dm in (draft, model):
        spec = SpeculativeEngine(model, dm, cfg, spec_k=4)
        got, n = _card_serve(spec, prompts)
        assert got == want and n > 0
    assert spec.report.summary()["acceptance_rate"] >= 0.9
    import dataclasses
    q8 = Engine(model, dataclasses.replace(cfg, kv_dtype="int8-block"))
    got, n = _card_serve(q8, prompts)
    assert n > 0 and all(len(t) == 21 for t in got)
    ctl = ServingStep(model, 1, 80)
    q = ServingStep(model, 1, 80, kv_dtype="int8-block")
    p = torch.as_tensor(prompts[3][None], device=cuda)
    rows_c, rows_q = [ctl.prefill(p, [63], [0])], [q.prefill(p, [63], [0])]
    for _ in range(8):
        nxt = rows_c[-1].argmax(-1)
        rows_c.append(ctl.decode(nxt))
        rows_q.append(q.decode(nxt))
    step = max(float(np.abs(page[leaf]).max()) / 2
               for page in q.export_slot(0, int(q.cursors()[0])).values()
               for leaf in ("k_s", "v_s"))
    worst = max(float((a - b).abs().max()) for a, b in zip(rows_c, rows_q))
    assert 0 < worst <= 10 * step, (worst, step)
