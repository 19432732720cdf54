"""The general flax → torch converter (``convert_layer``) against single
flax layers, the MLP converter against the flax MLP, and
``params_from_flax`` against the explicit mapping it had before it was
re-expressed through ``convert_layer``.

Every flax parameter is redrawn at random (init gives zero biases and
unit scales, which would hide a swapped pair). f32 layer outputs are held
at rtol 1e-5, atol 1e-5 (summation order); state dicts exactly."""

import functools

import numpy as np
import pytest
import torch
from torch import nn

import flax.linen as fnn
import jax
import jax.numpy as jnp

from chainermn_tpu.models import MLP as JaxMLP
from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_torch.models import MLP, TransformerLM
from chainermn_torch.models.convert import (convert_layer,
                                            mlp_params_from_flax,
                                            params_from_flax)

TOL = dict(rtol=1e-5, atol=1e-5)


def _random_like(tree, seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (scale * rs.randn(*np.shape(x))).astype(np.float32), tree)


def _flax(module, x, seed, collections=("params",), scale=1.0):
    vs = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    vs = {c: _random_like(jax.tree_util.tree_map(np.asarray, vs[c]),
                          seed + i, scale)
          for i, c in enumerate(collections)}
    if "batch_stats" in vs:   # a variance is positive
        vs["batch_stats"]["var"] = np.abs(vs["batch_stats"]["var"]) + 0.1
    return np.array(module.apply(vs, jnp.asarray(x))), vs


def _load(module, sd):
    module.load_state_dict(sd)   # strict: every key, no extra one
    return module.eval()


@pytest.mark.parametrize("use_bias", [True, False])
def test_dense(use_bias):
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    want, vs = _flax(fnn.Dense(5, use_bias=use_bias), x, 10)
    lin = _load(nn.Linear(4, 5, bias=use_bias),
                convert_layer("dense", vs["params"]))
    torch.testing.assert_close(lin(torch.from_numpy(x)),
                               torch.from_numpy(want), **TOL)


def test_embed():
    ids = np.array([[0, 3, 10], [7, 7, 1]])
    want, vs = _flax(fnn.Embed(11, 6), ids, 20)
    emb = _load(nn.Embedding(11, 6), convert_layer("embed", vs["params"]))
    torch.testing.assert_close(emb(torch.from_numpy(ids)),
                               torch.from_numpy(want), rtol=0, atol=0)


def test_layer_norm():
    x = np.random.RandomState(2).randn(4, 7).astype(np.float32)
    want, vs = _flax(fnn.LayerNorm(), x, 30)     # flax eps 1e-6
    ln = _load(nn.LayerNorm(7, eps=1e-6),
               convert_layer("layer_norm", vs["params"]))
    torch.testing.assert_close(ln(torch.from_numpy(x)),
                               torch.from_numpy(want), **TOL)


@pytest.mark.parametrize("case", ["2d_same", "2d_strided_grouped",
                                  "1d_valid"])
def test_conv(case):
    """HWIO (any spatial rank) → OIHW: flax NHWC against torch NCHW."""
    rs = np.random.RandomState(3)
    if case == "2d_same":
        flax_conv = fnn.Conv(4, (3, 3), padding="SAME")
        torch_conv = nn.Conv2d(6, 4, 3, padding=1)
        x = rs.randn(2, 5, 5, 6)
    elif case == "2d_strided_grouped":
        flax_conv = fnn.Conv(4, (3, 3), strides=(2, 2), padding="VALID",
                             feature_group_count=2, use_bias=False)
        torch_conv = nn.Conv2d(6, 4, 3, stride=2, groups=2, bias=False)
        x = rs.randn(2, 7, 7, 6)
    else:
        flax_conv = fnn.Conv(4, (3,), padding="VALID")
        torch_conv = nn.Conv1d(6, 4, 3)
        x = rs.randn(2, 9, 6)
    x = x.astype(np.float32)
    want, vs = _flax(flax_conv, x, 40)
    conv = _load(torch_conv, convert_layer("conv", vs["params"]))
    got = conv(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    torch.testing.assert_close(got, torch.from_numpy(
        np.moveaxis(want, -1, 1).copy()), **TOL)


def test_batch_norm_in_inference():
    """Running statistics and affine parameters (flax and torch eps 1e-5);
    ``batch_stats`` is required."""
    x = np.random.RandomState(4).randn(3, 4, 4, 5).astype(np.float32)
    want, vs = _flax(fnn.BatchNorm(use_running_average=True), x, 50,
                     collections=("params", "batch_stats"))
    bn = _load(nn.BatchNorm2d(5),
               convert_layer("batch_norm", vs["params"], vs["batch_stats"]))
    got = bn(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    torch.testing.assert_close(got, torch.from_numpy(
        np.moveaxis(want, -1, 1).copy()), **TOL)
    with pytest.raises(ValueError, match="batch_stats"):
        convert_layer("batch_norm", vs["params"])
    with pytest.raises(ValueError, match="unknown layer kind"):
        convert_layer("dropout", {})


def test_mlp_params_from_flax():
    x = np.random.RandomState(5).rand(6, 28, 28).astype(np.float32)
    # weights of about the init's scale keep the logits O(1)
    want, vs = _flax(JaxMLP(n_units=32, n_out=10), x, 60, scale=0.05)
    mlp = _load(MLP(n_units=32, device="cpu"),
                mlp_params_from_flax(vs["params"]))
    torch.testing.assert_close(mlp(torch.from_numpy(x)),
                               torch.from_numpy(want), **TOL)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _explicit_mapping(model, tree):
    """``params_from_flax``'s mapping as it was written out by hand
    (blhd trees; the bhld pivot is ``_bhld_block``'s, shared)."""
    from chainermn_torch.models.convert import _bhld_block

    sd = {"tok_emb.weight": _t(tree["tok_emb"]["embedding"]),
          "ln_f.weight": _t(tree["LayerNorm_0"]["scale"]),
          "ln_f.bias": _t(tree["LayerNorm_0"]["bias"]),
          "lm_head.weight": _t(tree["lm_head"]["kernel"]).T.contiguous()}
    if model.pos_emb == "learned":
        sd["pos_embedding"] = _t(tree["pos_emb"])
    for i in range(model.n_layers):
        bp = _bhld_block(tree[f"block_{i}"], model.d_model)
        pre = f"blocks.{i}."
        dense = ["attn_out", "ffn_in", "ffn_out"] + (
            ["qkv"] if "qkv" in bp else ["q_proj", "kv_proj"])
        for name in dense:
            sd[pre + name + ".weight"] = _t(bp[name]["kernel"]).T.contiguous()
            if "bias" in bp[name]:
                sd[pre + name + ".bias"] = _t(bp[name]["bias"])
        for src, dst in (("LayerNorm_0", "ln_attn"),
                         ("LayerNorm_1", "ln_ffn")):
            sd[pre + dst + ".weight"] = _t(bp[src]["scale"])
            sd[pre + dst + ".bias"] = _t(bp[src]["bias"])
    return sd


@functools.lru_cache(maxsize=None)
def _lm_tree(**cfg):
    # a bhld model runs only on the flash path
    attention = "flash" if cfg.get("qkv_layout") == "bhld" else "reference"
    jm = JaxLM(vocab=16, d_model=16, n_heads=4, n_layers=2, d_ff=32,
               max_len=8, attention=attention, **cfg)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    return _random_like(tree, 70)


@pytest.mark.parametrize("cfg", [
    dict(pos_emb="learned"), dict(pos_emb="rope"),
    dict(pos_emb="rope", n_kv_heads=2),
    dict(pos_emb="rope", qkv_layout="bhld"),
    dict(pos_emb="learned", n_kv_heads=1, qkv_layout="bhld")],
    ids=["learned", "rope", "gqa", "bhld", "mqa_bhld"])
def test_params_from_flax_unchanged(cfg):
    """The same tensors, bit for bit, as the explicit mapping, and a
    strict load into the port's model."""
    tree = _lm_tree(**cfg)
    model = TransformerLM(vocab=16, d_model=16, n_heads=4, n_layers=2,
                          d_ff=32, max_len=8, device="cpu",
                          pos_emb=cfg["pos_emb"],
                          n_kv_heads=cfg.get("n_kv_heads"))
    got, want = params_from_flax(model, tree), _explicit_mapping(model,
                                                                 tree)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    model.load_state_dict(got)


def test_mlp_init_follows_flax_dense():
    """The port's MLP starts as flax's Dense layers do: kernels of the
    same standard deviation (within 2%: 784k and 1M draws), truncated at
    two of flax's standard deviations, zero biases; one torch seed gives
    one set of parameters."""
    init = JaxMLP(n_units=1000).init(jax.random.PRNGKey(1),
                                     jnp.zeros((1, 28, 28)))["params"]
    torch.manual_seed(3)
    mlp = MLP(device="cpu")
    for i, layer in enumerate((mlp.l1, mlp.l2)):
        want = np.asarray(init[f"Dense_{i}"]["kernel"])
        w = layer.weight.detach().numpy()
        assert abs(w.std() / want.std() - 1) < 0.02, (i, w.std(),
                                                      want.std())
        bound = 2 * np.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
        assert np.abs(w).max() <= bound + 1e-6
        assert not layer.bias.detach().any()
    torch.manual_seed(3)
    again = MLP(device="cpu")
    for a, b in zip(mlp.parameters(), again.parameters()):
        assert torch.equal(a, b)
