"""The port's ResNet family against the JAX package's
(``chainermn_tpu/models/resnet.py``), from the same flax parameters
converted with ``resnet_params_from_flax``, on the same seeded NHWC
batch: ResNet-18 (7x7 stem), ResNet-50 with both ImageNet stems at 64²,
and the CIFAR ResNet of depth 8 with and without cross-replica batch
norm; flax's SAME padding; ResNet-50's parameter and statistic counts;
flax's initialisation.

Every flax parameter and statistic is redrawn at random around its
init's scale (zero biases and unit scales would hide a swapped pair).
Tolerances: f32 logits with running statistics within 1e-4 of
max|logit| (f32 sums in another order over up to 53 layers; a shifted
padding moves them by O(1)). With batch statistics within 2e-3 of
max|logit|: both sides compute flax's variance E[x²] − E[x]², whose f32
rounding error scales with mean²/var; the [0, 1) images give the stem's
outputs a mean far above their spread, so the two libraries' sums (each
right to ~1e-7) put the first variance ~1e-5 apart, and the deep blocks,
which normalise 16 values per channel at 64², carry that to ~5e-4 of the
logits (an unbiased variance there would move them by ~3%). Running
statistics at rtol/atol 1e-4; bf16 logits within 5e-2 relative L2 (bf16
rounding of every activation, in other places by the two convolution
libraries).
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import chainermn_tpu
from chainermn_tpu.models import resnet as jax_resnet
from chainermn_torch.comm import create_communicator
from chainermn_torch.links import batch_norm_layers
from chainermn_torch.models import resnet
from chainermn_torch.models.convert import resnet_params_from_flax

CASES = {
    "resnet18": ("ResNet18", {}, 32),
    "resnet50-s2d": ("ResNet50", {"space_to_depth": True}, 64),
    "resnet50": ("ResNet50", {}, 64),
    "cifar8": ("CifarResNet", {"depth": 8}, 32),
}


@pytest.fixture(scope="module")
def comms():
    """A size-1 gloo communicator of this process and a one-device JAX
    mesh: cross-replica batch norm over one rank."""
    c = create_communicator("pure_nccl", device="cpu")
    yield c, chainermn_tpu.create_communicator(
        "xla", mesh=Mesh(np.array(jax.devices()[:1]), ("data",)))
    c.finalize()


def _randomised(tree, seed):
    """Each leaf of an abstract tree drawn: kernels at LeCun-normal scale
    (1/sqrt(fan in)), scales around 1, biases and means around 0,
    variances around 1 (positive)."""
    rs = np.random.RandomState(seed)

    def draw(path, a):
        key = jax.tree_util.keystr(path)
        noise = rs.randn(*a.shape).astype(np.float32)
        if key.endswith("['kernel']"):
            return noise / np.sqrt(np.prod(a.shape[:-1]))
        if key.endswith("['scale']"):
            return 1 + 0.2 * noise
        if key.endswith("['var']"):
            return 1 + 0.3 * np.abs(noise)
        return 0.2 * noise

    return jax.tree_util.tree_map_with_path(draw, tree)


@functools.lru_cache(maxsize=None)
def _flax_case(case, dtype="float32", cross_replica=False):
    name, kw, hw = CASES[case]
    x = np.random.RandomState(0).rand(4, hw, hw, 3).astype(np.float32)
    comm = None
    if cross_replica:
        comm = chainermn_tpu.create_communicator(
            "xla", mesh=Mesh(np.array(jax.devices()[:1]), ("data",)))
    jm = getattr(jax_resnet, name)(num_classes=10, comm=comm,
                                   dtype=getattr(jnp, dtype), **kw)
    # shapes only: flax's init of a ResNet-50 takes seconds on the CPU
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x[:1])
    return jm, x, _randomised(v["params"], 1), _randomised(
        v["batch_stats"], 2)


def _jax_forward(jm, x, params, stats, train):
    def f(x):
        if train:
            y, new = jm.apply({"params": params, "batch_stats": stats}, x,
                              train=True, mutable=["batch_stats"])
            return y, new["batch_stats"]
        return jm.apply({"params": params, "batch_stats": stats}, x,
                        train=False), stats

    if jm.comm is not None:
        f = jax.jit(shard_map(f, mesh=jm.comm.mesh, in_specs=P("data"),
                              out_specs=(P("data"), P())))
    y, new = f(x)
    return np.asarray(y, np.float32), jax.tree_util.tree_map(np.asarray, new)


def _port(case, params, stats, dtype="float32", comm=None):
    name, kw, _ = CASES[case]
    model = getattr(resnet, name)(num_classes=10, comm=comm,
                                  dtype=getattr(torch, dtype), device="cpu",
                                  **kw)
    model.load_state_dict(resnet_params_from_flax(model, params, stats))
    return model


def _assert_logits(got, want, train):
    share = 2e-3 if train else 1e-4
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=share * np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax_in_both_modes(case):
    """Eval mode (running statistics) and train mode (batch statistics)
    logits against the JAX model; train mode's updated running statistics
    against flax's ``batch_stats`` after the call."""
    jm, x, params, stats = _flax_case(case)
    model = _port(case, params, stats)
    want, _ = _jax_forward(jm, x, params, stats, train=False)
    _assert_logits(model(torch.from_numpy(x), train=False), want, False)
    want, new = _jax_forward(jm, x, params, stats, train=True)
    got = model(torch.from_numpy(x), train=True)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    _assert_logits(got, want, True)
    ref = resnet_params_from_flax(model, params, new)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, ref[k], rtol=1e-4, atol=1e-4, msg=k)


def test_cifar_resnet_with_cross_replica_batch_norm(comms):
    """``CifarResNet(depth=8, comm=...)``: the flax tree nests each
    ``BatchNorm`` in a ``MultiNodeBatchNormalization``; converted, the
    port's model gives the JAX model's logits under shard_map on one
    device in both modes, and the same running statistics."""
    comm_t, _ = comms
    jm, x, params, stats = _flax_case("cifar8", cross_replica=True)
    assert "MultiNodeBatchNormalization_0" in params["ResNetBlock_0"]
    model = _port("cifar8", params, stats, comm=comm_t)
    assert all(m.comm is comm_t for m in batch_norm_layers(model))
    for train in (False, True):
        want, new = _jax_forward(jm, x, params, stats, train=train)
        _assert_logits(model(torch.from_numpy(x), train=train), want, train)
    ref = resnet_params_from_flax(model, params, new)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, ref[k], rtol=1e-4, atol=1e-4, msg=k)


@pytest.mark.parametrize("case,train", [("resnet18", False),
                                        ("resnet50-s2d", False),
                                        ("cifar8", True)])
def test_bf16_forward_matches_jax(case, train):
    """``dtype=bf16`` (bf16 convolutions and activations, f32 statistics
    and head): logits within 5e-2 relative L2 of the JAX model's. Deep
    models are compared with running statistics only: with random
    weights, batch statistics over the few values per channel of the last
    stages amplify any difference geometrically with depth (batch norm's
    gradient explosion at init), so two libraries' bf16 roundings, 1e-3
    apart at the first layer, drift 15-40% apart by the logits of
    ResNet-18/50 in train mode, while the depth-8 CIFAR ResNet stays near
    4e-3."""
    jm, x, params, stats = _flax_case(case, dtype="bfloat16")
    model = _port(case, params, stats, dtype="bfloat16")
    want, _ = _jax_forward(jm, x, params, stats, train=train)
    got = model(torch.from_numpy(x), train=train)
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    rel = np.linalg.norm(got.detach().numpy() - want) / np.linalg.norm(want)
    assert rel < 5e-2, rel


@pytest.mark.parametrize("size,kernel,stride", [
    (8, 3, 2), (7, 3, 2), (8, 1, 2), (7, 1, 2), (6, 3, 1), (112, 3, 2),
    (224, 7, 2), (5, 4, 1)])
def test_same_padding_is_flax_s(size, kernel, stride):
    """``same_padding`` equals lax's SAME padding: (0, 1) for a stride-2
    3x3 window on an even size, nothing for a stride-2 1x1."""
    want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert resnet.same_padding(size, kernel, stride) == tuple(want[0])


def test_stride_two_conv_and_max_pool_pad_like_flax():
    """A stride-2 3x3 convolution and the stem's 3x3 stride-2 max pool on
    an even input equal flax's SAME versions, and torch's symmetric
    padding=1 gives other values (so a (1, 1) pad cannot pass the
    forward tests)."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    conv = fnn.Conv(5, (3, 3), (2, 2), use_bias=False)
    v = conv.init(jax.random.PRNGKey(0), x)
    want = np.moveaxis(np.asarray(conv.apply(v, x)), -1, 1)
    port = resnet.Conv(4, 5, 3, 2)
    port.weight.data = torch.from_numpy(np.ascontiguousarray(np.transpose(
        np.asarray(v["params"]["kernel"]), (3, 2, 0, 1))))
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    np.testing.assert_allclose(port(xt).detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    sym = F.conv2d(xt, port.weight, stride=2, padding=1).detach().numpy()
    assert sym.shape == want.shape and np.abs(sym - want).max() > 0.1

    pooled = np.moveaxis(np.asarray(fnn.max_pool(
        jnp.asarray(-np.abs(x)), (3, 3), strides=(2, 2), padding="SAME")),
        -1, 1)
    (t, b), (l, r) = (resnet.same_padding(n, 3, 2) for n in (8, 8))
    assert (t, b, l, r) == (0, 1, 0, 1)
    got = F.max_pool2d(F.pad(-xt.abs(), (l, r, t, b), value=float("-inf")),
                       3, 2)
    np.testing.assert_array_equal(got.numpy(), pooled)
    sym = F.max_pool2d(-xt.abs(), 3, 2, padding=1).numpy()
    assert not np.array_equal(sym, pooled)


def test_resnet50_counts_equal_the_jax_collections():
    """ResNet-50 has as many parameter tensors and elements as the flax
    ``params`` collection (161, 25,557,032) and as many running-statistic
    tensors and elements as ``batch_stats`` (106, 53,120)."""
    _, _, params, stats = _flax_case("resnet50")
    v = jax.eval_shape(jax_resnet.ResNet50(num_classes=1000).init,
                       jax.random.PRNGKey(0),
                       np.zeros((1, 64, 64, 3), np.float32))
    model = resnet.ResNet50(num_classes=1000, device="cpu")
    leaves = jax.tree_util.tree_leaves(v["params"])
    assert len(list(model.parameters())) == len(leaves) == 161
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.prod(x.shape) for x in leaves) == 25_557_032
    stat_leaves = jax.tree_util.tree_leaves(v["batch_stats"])
    bufs = [b for m in batch_norm_layers(model)
            for b in (m.running_mean, m.running_var)]
    assert len(bufs) == len(stat_leaves) == 106
    assert sum(b.numel() for b in bufs) == sum(
        np.prod(x.shape) for x in stat_leaves) == 53_120
    # the 10-class tree names the same layers
    assert set(model.state_dict()) == set(resnet_params_from_flax(
        model, params, stats))


def test_init_follows_flax():
    """One seed gives one model; each block's last batch norm starts at
    scale 0, the others at 1; convolution kernels have LeCun-normal
    spread (std sqrt(1/fan_in) within 2%, truncated at 2 std);
    parameters and statistics are f32, 4-D weights channels_last."""
    models = []
    for _ in range(2):
        torch.manual_seed(0)
        models.append(resnet.CifarResNet(depth=8, device="cpu"))
    for (n, p), q in zip(models[0].state_dict().items(),
                         models[1].state_dict().values()):
        assert torch.equal(p, q), n
    torch.manual_seed(0)
    a = resnet.ResNet50(num_classes=10, dtype=torch.bfloat16,
                        space_to_depth=True, device="cpu")
    for name, m in a.named_modules():
        if name.endswith("BatchNorm_2"):
            assert torch.equal(m.weight, torch.zeros_like(m.weight)), name
        elif hasattr(m, "running_var"):
            assert torch.equal(m.weight, torch.ones_like(m.weight)), name
    w = a.BottleneckResNetBlock_15.Conv_1.weight     # 512x512x3x3
    std = (1 / (512 * 9)) ** 0.5
    assert abs(w.std().item() / std - 1) < 0.02
    assert w.abs().max().item() <= 2 * std / 0.8796 + 1e-6
    assert all(t.dtype == torch.float32 for t in a.state_dict().values())
    assert w.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="6n\\+2"):
        resnet.CifarResNet(depth=9, device="cpu")
    with pytest.raises(ValueError, match="even H and W"):
        a(torch.zeros(1, 63, 64, 3))
