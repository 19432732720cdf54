"""The port's ViT against the JAX package's: the forward from the same
parameters (``vit_params_from_flax``) with ``pool="gap"`` and ``"cls"``,
f32 and bf16, with and without ``remat``; the traps of a flax port (flax's
LayerNorm epsilon, the tanh GELU, f32 logits, the NHWC patch projection
with flax's kernel layout, the strided ``qkv`` views the flash wrapper
reads in place); and one ``make_data_parallel_train_step`` SGD step on
one rank and on a 2-rank gloo world against the JAX step on a 1- and a
2-device mesh. The JAX flash kernel runs in interpret mode, as
``test_torch_flash_attention.py`` runs it. The config is the JAX tests'
tiny one (``tests/models_tests/test_vit.py``): patch 8, d_model 32, 2
layers, 4 heads, d_ff 64, 32² images (16 tokens, 17 with the class
token), 10 classes.

Tolerances: f32 logits at 1e-5 of the largest logit (the same f32
arithmetic; the two frameworks sum products in other orders, ~3e-7
measured); bf16 logits at 2e-2 of the largest logit (bf16 keeps 8
mantissa bits and the frameworks round activations at different points:
2e-3 to 4e-3 measured); one SGD step's loss at 1e-5 relative and its
parameters at 1e-5 absolute plus relative (f32 gradients in another
summation order, times lr 0.1).
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import functools
import pickle

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import flax.linen as fnn
from jax.sharding import Mesh

import chainermn_tpu
from chainermn_tpu.models.vit import ViT as JaxViT
from chainermn_tpu.models.vit import ViTEncoderBlock as JaxBlock
from chainermn_tpu.training.step import \
    make_data_parallel_train_step as jax_make_step
from chainermn_torch.comm import create_communicator
from chainermn_torch.models.convert import vit_params_from_flax
from chainermn_torch.models.transformer import _LN_EPS, _layer_norm
from chainermn_torch.models.vit import ViT, ViTEncoderBlock
from chainermn_torch.ops.flash_attention import _aligned
from chainermn_torch.optimizers import create_multi_node_optimizer
from chainermn_torch.training import make_data_parallel_train_step
from tests.test_torch_mp import assert_ranks_ok, run_world

CFG = dict(num_classes=10, patch=8, d_model=32, n_layers=2, n_heads=4,
           d_ff=64)
IMAGE = 32
TOL_F32 = 1e-5
TOL_BF16 = 2e-2
LR = 0.1
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _images(n=2, seed=0):
    return np.random.RandomState(seed).rand(n, IMAGE, IMAGE, 3).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _flax_params(pool="gap", seed=0):
    jm = JaxViT(**CFG, pool=pool)
    return jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), _images(2))["params"])


def _port(pool="gap", dtype="float32", **kw):
    tm = ViT(**CFG, image_size=IMAGE, pool=pool, dtype=_DT[dtype][1],
             device="cpu", **kw)
    tm.load_state_dict(vit_params_from_flax(_flax_params(pool)))
    return tm


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", ["gap", "cls"])
def test_forward_matches_jax(pool, dtype):
    """Logits from the converted parameters equal the JAX ViT's, f32
    logits in both dtypes (flax's head is an f32 Dense)."""
    x = _images()
    want = JaxViT(**CFG, pool=pool, dtype=_DT[dtype][0]).apply(
        {"params": _flax_params(pool)}, x)
    got = _port(pool, dtype)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 10)
    assert _rel(got.detach(), want) <= (TOL_F32 if dtype == "float32"
                                        else TOL_BF16)


def test_remat_gives_the_same_logits_and_gradients():
    """``remat=True`` checkpoints each block: the logits equal the JAX
    ``nn.remat`` model's, and the port's own logits and gradients equal
    its un-rematted model's exactly."""
    x = _images()
    want = JaxViT(**CFG, remat=True).apply({"params": _flax_params()}, x)
    plain, rem = _port(), _port(remat=True)
    outs = []
    for m in (plain, rem):
        out = m(torch.from_numpy(x))
        out.square().sum().backward()
        outs.append((out.detach(), {n: p.grad for n, p in
                                    m.named_parameters()}))
    assert _rel(outs[1][0], want) <= TOL_F32
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)
    for n, g in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][n], g, rtol=0, atol=0, msg=n)


def test_layer_norm_epsilon_is_flaxs():
    """flax's LayerNorm epsilon is 1e-6 (torch's default 1e-5): every
    LayerNorm of the port's ViT uses it, and on activations of variance
    ~1e-6, where the two epsilons give visibly different results, the
    port's normalisation equals flax's."""
    tm = _port()
    eps = {m.eps for m in tm.modules() if isinstance(m, torch.nn.LayerNorm)}
    assert eps == {_LN_EPS} == {1e-6}
    x = 1e-3 * np.random.RandomState(1).randn(4, 32).astype(np.float32)
    want = np.asarray(fnn.LayerNorm().apply(
        {"params": {"scale": np.ones(32, np.float32),
                    "bias": np.zeros(32, np.float32)}}, x))
    got = _layer_norm(tm.ln_f, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    torch_default = F.layer_norm(torch.from_numpy(x), (32,), eps=1e-5)
    assert np.abs(torch_default.numpy() - want).max() > 0.1


def test_block_matches_the_flax_block_with_its_tanh_gelu(monkeypatch):
    """One encoder block against flax's, with activations large enough
    that the same block with the exact GELU (torch's default) misses
    flax's output by more than the tolerance."""
    rs = np.random.RandomState(2)
    x = 3.0 * rs.randn(2, 16, 32).astype(np.float32)
    jb = JaxBlock(d_model=32, n_heads=4, d_ff=64)
    p = jax.tree_util.tree_map(np.asarray, jb.init(
        jax.random.PRNGKey(3), x)["params"])
    want = np.asarray(jb.apply({"params": p}, x))
    sd = vit_params_from_flax({"block_0": p, "patchify": {
        "kernel": np.zeros((8, 8, 3, 32), np.float32),
        "bias": np.zeros(32, np.float32)},
        "LayerNorm_0": p["LayerNorm_0"], "pos_emb": np.zeros((16, 32)),
        "head": {"kernel": np.zeros((32, 10), np.float32),
                 "bias": np.zeros(10, np.float32)}})
    tb = ViTEncoderBlock(32, 4, 64)
    tb.load_state_dict({k[len("blocks.0."):]: v for k, v in sd.items()
                        if k.startswith("blocks.0.")})
    got = tb(torch.from_numpy(x)).detach().numpy()
    assert _rel(got, want) <= TOL_F32
    exact = F.gelu
    monkeypatch.setattr(F, "gelu", lambda t, approximate="none": exact(t))
    assert _rel(tb(torch.from_numpy(x)).detach().numpy(), want) > TOL_F32


def test_patch_projection_is_flaxs_nhwc_conv():
    """The projection takes NHWC images and flax's ``[kh, kw, cin,
    cout]`` kernel (``convert_layer("conv")`` → OIHW): it equals flax's
    stride-8 VALID convolution on an image whose channels and rows all
    differ."""
    x = _images(2, seed=4)
    conv = fnn.Conv(32, (8, 8), strides=(8, 8), padding="VALID")
    p = jax.tree_util.tree_map(np.asarray, conv.init(
        jax.random.PRNGKey(5), x)["params"])
    want = np.asarray(conv.apply({"params": p}, x)).reshape(2, 16, 32)
    tm = _port()
    tm.patchify.load_state_dict(
        {k[len("patchify."):]: v for k, v in vit_params_from_flax(
            dict(_flax_params(), patchify=p)).items()
         if k.startswith("patchify.")})
    got = tm._patches(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d_model,n_heads,dtype", [
    (384, 6, torch.bfloat16), (32, 4, torch.bfloat16),
    (32, 4, torch.float32)])
def test_qkv_views_are_read_in_place_by_the_flash_wrapper(d_model, n_heads,
                                                          dtype):
    """The split of the fused ``qkv`` gives strided views (ViT-S/16's
    widths and the test's): their offsets and strides are multiples of
    16 bytes, so the CUDA wrapper reads them without a copy."""
    h = torch.zeros(2, 197, 3 * d_model, dtype=dtype)
    views = [t.reshape(2, 197, n_heads, d_model // n_heads)
             for t in h.chunk(3, dim=-1)]
    assert not any(v.is_contiguous() for v in views)
    assert all(_aligned(v) for v in views)


def test_model_options_and_refusals():
    """``attention_blocks`` is recorded (the CUDA kernels fix their own
    tiles); a bad pool or an image the patch does not divide raises, as
    in JAX; parameters are f32 in a bf16 model, with flax's names."""
    tm = _port(dtype="bfloat16", attention_blocks=(64, 64))
    assert tm.attention_blocks == (64, 64)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert set(tm.state_dict()) == set(vit_params_from_flax(_flax_params()))
    assert _port("cls").n_tokens == 17 and tm.n_tokens == 16
    with pytest.raises(ValueError, match="pool"):
        ViT(num_classes=10, pool="max", device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        ViT(num_classes=10, image_size=30, patch=8, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tm(torch.zeros(1, 30, 32, 3))


# -- one data-parallel SGD step against the JAX step ------------------------

def _mesh_comm(n):
    return chainermn_tpu.create_communicator(
        "xla", mesh=Mesh(np.array(jax.devices()[:n]), ("data",)))


@functools.lru_cache(maxsize=None)
def _jax_step(n_dev, pool):
    """One SGD step of the JAX ViT on an ``n_dev``-device mesh over 8
    seeded images: (loss, params after)."""
    rs = np.random.RandomState(6)
    x = rs.rand(8, IMAGE, IMAGE, 3).astype(np.float32)
    y = rs.randint(0, 10, size=8).astype(np.int32)
    comm = _mesh_comm(n_dev)
    opt = chainermn_tpu.create_multi_node_optimizer(optax.sgd(LR), comm)
    step = jax_make_step(JaxViT(**CFG, pool=pool), opt, comm, donate=False)
    params = _flax_params(pool)
    (p, _), m = step((params, opt.init(params)), x, y)
    return x, y, float(m["main/loss"]), jax.tree_util.tree_map(np.asarray, p)


@pytest.mark.parametrize("pool", ["gap", "cls"])
def test_one_sgd_step_on_one_rank_matches_the_jax_step(pool):
    x, y, loss_j, p_j = _jax_step(1, pool)
    comm = create_communicator("pure_nccl", device="cpu")
    try:
        tm = _port(pool)
        opt = create_multi_node_optimizer(
            torch.optim.SGD(tm.parameters(), lr=LR), comm)
        step = make_data_parallel_train_step(tm, opt, comm)
        loss = step(torch.from_numpy(x), torch.from_numpy(y))["main/loss"]
    finally:
        comm.finalize()
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    for k, v in vit_params_from_flax(p_j).items():
        torch.testing.assert_close(tm.state_dict()[k], v, rtol=1e-5,
                                   atol=1e-5, msg=k)


_WORKER = r'''
import os, pickle, sys
import numpy as np
import torch
from chainermn_torch.comm import create_communicator
from chainermn_torch.models.vit import ViT
from chainermn_torch.optimizers import create_multi_node_optimizer
from chainermn_torch.training import make_data_parallel_train_step

rank = int(os.environ["RANK"])
with open(sys.argv[1], "rb") as f:
    case = pickle.load(f)
comm = create_communicator("pure_nccl", device="cpu")
tm = ViT(**case["cfg"], image_size=32, device="cpu")
tm.load_state_dict(case["init"])
opt = create_multi_node_optimizer(torch.optim.SGD(tm.parameters(), lr=0.1),
                                  comm)
step = make_data_parallel_train_step(tm, opt, comm)
half = slice(4 * rank, 4 * rank + 4)
loss = step(torch.from_numpy(case["x"][half]),
            torch.from_numpy(case["y"][half]))["main/loss"].item()
np.testing.assert_allclose(loss, case["loss"], rtol=1e-5)
for k, v in case["final"].items():
    torch.testing.assert_close(tm.state_dict()[k], v, rtol=1e-5, atol=1e-5,
                               msg=k)
comm.finalize()
print(f"RANK{rank} OK", flush=True)
'''


def test_one_sgd_step_on_two_ranks_matches_the_jax_step(tmp_path):
    """A 2-rank gloo world, each rank half of the 8 images, against the
    JAX step on a 2-device mesh over all 8: the mean loss and the
    parameters on both ranks."""
    x, y, loss_j, p_j = _jax_step(2, "gap")
    path = tmp_path / "case.pkl"
    with open(path, "wb") as f:
        pickle.dump({"cfg": CFG, "x": x, "y": y, "loss": loss_j,
                     "init": vit_params_from_flax(_flax_params()),
                     "final": vit_params_from_flax(p_j)}, f)
    assert_ranks_ok(run_world(_WORKER, 2, timeout=180, args=[str(path)]))
