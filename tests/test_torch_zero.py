"""The port's ZeRO-1/2 (``chainermn_torch/optimizers/zero.py``) against
the JAX package's (``chainermn_tpu/optimizers/zero.py``).

* The layout: ``_padded_size``, the bucket plan and
  ``zero_layout_manifest`` equal JAX's for the MLP and a 2-layer LM at
  n = 1, 2 and 4, flat and bucketed (the port packs its parameters in the
  flax tree's leaf order). Exact.
* The steps: a 2-rank gloo world (``run_world``) trains the MLP (784-16-
  16-10) for 3 steps through ZeRO-1 and ZeRO-2 (``n_microbatches=2``),
  flat and bucketed, with SGD with momentum and with Adam, and with
  int8-block error feedback, from the flax parameters converted; the JAX
  steps run on a 2-device CPU mesh from the same parameters on the same
  global batches. Losses at rtol 1e-5 (f32 products of two libraries in
  other orders); ``zero1_params`` at rtol 1e-5 and atol 2e-6: SGD moves
  a weight by lr times a gradient that agrees to ~1e-7 relative, and
  Adam's first steps move each weight by about lr (1e-3) times
  g / (|g| + eps), which last-bit gradient differences move by ~1e-7
  relative where |g| is far above eps. The int8-block codes are JAX's
  (the same blocks, scales and rounding, as the flat vectors hold JAX's
  numbers in JAX's layout), except where a value that the two libraries'
  gradients put within last-bit noise of a rounding boundary rounds the
  other way: then that element's reduced gradient moves by one
  quantization step, and its update by up to lr a step. So the quantized
  cases hold every element to the bounds above but one in a thousand,
  and that one within STEPS x lr (on the CPU one element of the MLP's
  13,002 rounds so in the flat int8-block case). Each rank's optimizer
  state holds padded / N elements a state tensor (Adam's two moments,
  SGD's momentum).
* The hooks' peak of live gradient bytes equals a simulation of the
  bucket plan over the backward's leaf order (leaves in flight plus one
  packed bucket) and stays under half the flat form's, which holds the
  whole model's gradients and its packed vector at once.
* The refusals: the probe refuses the port's LARS and LAMB and admits
  SGD, momentum, Adam and AdamW (JAX's ``test_zero.py:675,696``);
  ``zero1_params`` refuses a layout other than the state's (``:221``);
  mixed dtypes, a multi-axis communicator, a batch that the micro-batches
  do not divide and a stateful reducer without ``reduce_scatter_flat_ef``
  raise; the FSDP step refuses a stateful reducer, an unknown
  ``param_wire`` and a model with batch statistics with JAX's texts.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import functools
import pickle
import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import chainermn_tpu
from chainermn_tpu.models.mlp import MLP as JMLP
from chainermn_tpu.models.transformer import TransformerLM as JLM
from chainermn_tpu.optimizers import zero as jz
from chainermn_torch.collectives import GradReducer
from chainermn_torch.comm import create_communicator
from chainermn_torch.models import MLP
from chainermn_torch.models.convert import (flax_param_order,
                                            mlp_params_from_flax,
                                            params_from_flax)
from chainermn_torch.models.transformer import (TransformerLM,
                                                lm_loss_with_aux)
from chainermn_torch.optimizers import LAMB, LARS
from chainermn_torch.optimizers import zero as tz
from tests.test_torch_mp import assert_ranks_ok, run_world

N, UNITS, STEPS, BATCH, LR_SGD, LR_ADAM = 2, 16, 3, 8, 0.1, 1e-3
BUCKET = 4096
LM = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=128, max_len=16)

# (stage, optimizer, bucket bytes, wire format of an error-feedback reducer)
CASES = [(stage, opt, bb, None) for stage in ("zero1", "zero2")
         for opt in ("sgd", "adam") for bb in (None, BUCKET)] + [
    ("zero1", "adam", None, "int8-block"),
    ("zero1", "adam", BUCKET, "int8-block"),
    ("zero2", "sgd", BUCKET, "int8-block")]


def case_id(case):
    stage, opt, bb, wf = case
    return f"{stage}-{opt}-{'bucketed' if bb else 'flat'}" + (
        f"-{wf}" if wf else "")


def batches():
    """The global batches (the workers run this function's source)."""
    rs = np.random.RandomState(3)
    return [(rs.rand(BATCH, 784).astype(np.float32),
             rs.randint(0, 10, size=BATCH).astype(np.int32))
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def jax_mlp():
    model = JMLP(n_units=UNITS)
    params = model.init(jax.random.PRNGKey(0),
                        np.zeros((1, 784), np.float32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


# -- the layout -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params(name):
    if name == "mlp":
        return JMLP(n_units=UNITS).init(
            jax.random.PRNGKey(0), np.zeros((1, 784), np.float32))["params"]
    return JLM(**LM, attention="reference").init(
        jax.random.PRNGKey(1), np.zeros((1, 8), np.int32))["params"]


def _models(name):
    """The JAX parameters and the port's model with them."""
    params = _jax_params(name)
    if name == "mlp":
        port = MLP(n_units=UNITS, device="cpu")
        port.load_state_dict(mlp_params_from_flax(
            jax.tree_util.tree_map(np.asarray, params)))
        return params, port
    port = TransformerLM(**LM, device="cpu")
    port.load_state_dict(params_from_flax(
        port, jax.tree_util.tree_map(np.asarray, params)))
    return params, port


@pytest.mark.parametrize("bb", [None, 1024, BUCKET], ids=["flat", "1k",
                                                           "4k"])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("name", ["mlp", "lm"])
def test_layout_and_manifest_equal_jax(name, n, bb):
    params, port = _models(name)
    comm = types.SimpleNamespace(size=n)
    assert tz.zero_layout_manifest(port, comm, bb) == \
        jz.zero_layout_manifest(params, comm, bb)
    leaves = jax.tree_util.tree_leaves(params)
    order = flax_param_order(port)
    # the same leaves in the same order (sizes; torch keeps its layout)
    assert [p.numel() for _, p in order] == [int(np.size(x))
                                             for x in leaves]
    total = sum(p.numel() for _, p in order)
    assert tz._padded_size(total, n) == jz._padded_size(total, n)
    if bb is not None:
        leaves, perms = tz._leaves(port)
        mine = tz._BucketLayout(leaves, n, bb, perms)
        want = jz._BucketLayout(params, n, bb)
        assert (mine.buckets, mine.totals, mine.padded, mine.shard_lens) \
            == (want.buckets, want.totals, want.padded, want.shard_lens)


def test_padded_size_is_device_count_independent():
    for total in (1, 255, 256, 13002, 1 << 20):
        sizes = {tz._padded_size(total, n) for n in (1, 2, 4, 8, 256)}
        assert len(sizes) == 1
        assert sizes == {jz._padded_size(total, 8)}
    assert tz._padded_size(10, 3) == jz._padded_size(10, 3) == 12


# -- the steps across two ranks --------------------------------------------

def _factory(opt):
    if opt == "sgd":
        return lambda ps: torch.optim.SGD(ps, lr=LR_SGD, momentum=0.9,
                                          foreach=False)
    # optax.adam: eps 1e-8 after the square root
    return lambda ps: torch.optim.Adam(ps, lr=LR_ADAM, eps=1e-8,
                                       foreach=False)


def run_case(case, sd, comm):
    """This rank's run of one case: losses, the re-assembled parameters,
    the optimizer state's element count and the layout's padded
    lengths."""
    from chainermn_torch.collectives import QuantizedReducer
    from chainermn_torch.optimizers import (make_zero1_train_step,
                                            make_zero2_train_step,
                                            zero1_params)

    stage, opt, bb, wf = case
    model = MLP(n_units=UNITS, device="cpu")
    model.load_state_dict(sd)
    red = None if wf is None else QuantizedReducer(comm, wire_format=wf)
    kw = dict(bucket_bytes=bb, grad_reducer=red)
    if stage == "zero1":
        step, state = make_zero1_train_step(model, _factory(opt), comm, **kw)
    else:
        step, state = make_zero2_train_step(model, _factory(opt), comm,
                                            n_microbatches=2, **kw)
    per = BATCH // comm.size
    losses = []
    for x, y in batches():
        lo = comm.rank * per
        m = step(x[lo:lo + per], y[lo:lo + per])
        losses.append(float(m["main/loss"]))
    params = {k: v.numpy() for k, v in zero1_params(state, model, bb).items()}
    return {"losses": losses, "params": params,
            "state_numel": state.optimizer_state_numel(),
            "padded": list(state.layout.padded)}


_WORKER = r'''
import os, pickle, sys
import numpy as np
import torch
from chainermn_torch.collectives import GradReducer
from chainermn_torch.comm import create_communicator
from chainermn_torch.models import MLP
from tests.test_torch_zero import CASES, run_case

out = sys.argv[1]
with open(os.path.join(out, "params.pkl"), "rb") as f:
    sd = pickle.load(f)
comm = create_communicator("pure_nccl", device="cpu")
res = {case: run_case(case, sd, comm) for case in CASES}
with open(os.path.join(out, f"rank{comm.rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
comm.finalize()
print(f"RANK{int(os.environ['RANK'])} OK", flush=True)
'''


@pytest.fixture(scope="module")
def world(jax_mlp, tmp_path_factory):
    _, params = jax_mlp
    d = tmp_path_factory.mktemp("zero")
    with open(d / "params.pkl", "wb") as f:
        pickle.dump(mlp_params_from_flax(params), f)
    assert_ranks_ok(run_world(_WORKER, N, timeout=240, args=[str(d)]))
    return [pickle.loads((d / f"rank{r}.pkl").read_bytes())
            for r in range(N)]


def _jax_run(case, model, params):
    stage, opt, bb, wf = case
    comm = chainermn_tpu.create_communicator(
        "xla", mesh=Mesh(np.array(jax.devices()[:N]), ("r",)))
    tx = (optax.sgd(LR_SGD, momentum=0.9) if opt == "sgd"
          else optax.adam(LR_ADAM))
    red = None
    if wf is not None:
        from chainermn_tpu.collectives import QuantizedReducer

        red = QuantizedReducer(comm, mode=wf)
    kw = dict(bucket_bytes=bb, grad_reducer=red, donate=False)
    if stage == "zero1":
        step, state = jz.make_zero1_train_step(model, tx, comm, params, **kw)
    else:
        step, state = jz.make_zero2_train_step(model, tx, comm, params,
                                               n_microbatches=2, **kw)
    losses = []
    for x, y in batches():
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(m["main/loss"]))
    full = jax.tree_util.tree_map(np.asarray,
                                  jz.zero1_params(state, params, bb))
    return losses, {k: v.numpy() for k, v in
                    mlp_params_from_flax(full).items()}


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_zero_steps_match_jax_on_two_ranks(world, jax_mlp, case):
    model, params = jax_mlp
    want_losses, want_params = _jax_run(case, model, params)
    r0, r1 = world[0][case], world[1][case]
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], want_losses, rtol=1e-5)
    for k, v in want_params.items():
        got = r0["params"][k]
        np.testing.assert_array_equal(got, r1["params"][k])
        if case[3] is None:
            np.testing.assert_allclose(got, v, rtol=1e-5, atol=2e-6,
                                       err_msg=k)
            continue
        # a code whose input sits within last-bit noise of a rounding
        # boundary may round the other way in one library
        off = np.abs(got - v) > 1e-5 * np.abs(v) + 2e-6
        assert off.sum() <= max(1, v.size // 1000), (k, off.sum())
        assert np.abs(got - v).max() <= STEPS * LR_ADAM, k
    # each rank's state: padded / N elements per optimizer tensor
    n_state = 1 if case[1] == "sgd" else 2
    assert r0["state_numel"] == r1["state_numel"] == \
        n_state * sum(r0["padded"]) // N


# -- live gradient bytes ----------------------------------------------------

def _lm():
    return _models("lm")[1]


def _tokens():
    rs = np.random.RandomState(5)
    x = rs.randint(0, LM["vocab"], size=(2, 16))
    return x, np.roll(x, -1, axis=1)


@pytest.fixture(scope="module")
def comm():
    c = create_communicator("pure_nccl", device="cpu")
    yield c
    c.finalize()


def test_hook_peak_is_one_bucket_plus_leaves_in_flight(comm):
    """The counted peak equals the plan simulated over the backward's
    leaf order, and the bucketed peak is under half the flat one."""
    x, y = _tokens()
    probe = _lm()
    order = []
    named = flax_param_order(probe)
    for i, (_, p) in enumerate(named):
        p.register_post_accumulate_grad_hook(
            lambda t, i=i: order.append(i))
    lm_loss_with_aux(probe, torch.as_tensor(x),
                     torch.as_tensor(y))[0].backward()
    sizes = [p.numel() * 4 for _, p in named]
    layout = tz._BucketLayout([p for _, p in named], 1, 16384)
    bucket_of = {i: b for b, bl in enumerate(layout.buckets) for i in bl}
    live = peak = 0
    ready = [0] * len(layout.buckets)
    for i in order:
        live += sizes[i]
        peak = max(peak, live)
        b = bucket_of[i]
        ready[b] += 1
        if ready[b] == len(layout.buckets[b]):
            peak = max(peak, live + layout.padded[b] * 4)
            live -= sum(sizes[j] for j in layout.buckets[b])
    fac = _factory("adam")
    peaks = {}
    for bb in (None, 16384):
        model = _lm()
        step, state = tz.make_zero1_train_step(model, fac, comm,
                                               loss_fn=lm_loss_with_aux,
                                               bucket_bytes=bb)
        assert np.isfinite(float(step(x, y)["main/loss"]))
        peaks[bb] = state.grad_bytes_peak
    model_bytes = sum(sizes)
    assert peaks[16384] == peak
    # every leaf's gradient and the packed padded vector at once
    assert peaks[None] == model_bytes + tz._padded_size(
        model_bytes // 4, 1) * 4
    assert peaks[16384] < peaks[None] / 2


# -- refusals ---------------------------------------------------------------

@pytest.mark.parametrize("name,make,admitted", [
    ("sgd", lambda ps: torch.optim.SGD(ps, lr=0.1), True),
    ("momentum", lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9), True),
    ("adam", lambda ps: torch.optim.Adam(ps, lr=1e-3), True),
    ("adamw", lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-4),
     True),
    ("lars", lambda ps: LARS(ps, 0.1, weight_decay=1e-4, momentum=0.9),
     False),
    ("lamb", lambda ps: LAMB(ps, 1e-3, weight_decay=1e-4), False)])
def test_probe_refuses_lars_and_lamb_and_admits_elementwise(name, make,
                                                            admitted):
    """As JAX's probe refuses ``optax.lars``/``optax.lamb`` and admits the
    element-wise transforms, on the MLP's parameter ranks."""
    leaves = [p for _, p in flax_param_order(MLP(n_units=4,
                                                 device="cpu"))]
    if admitted:
        tz._require_elementwise(make, leaves)
    else:
        with pytest.raises(ValueError, match="not element-wise"):
            tz._require_elementwise(make, leaves)


def test_jax_probe_refuses_optax_lars_and_lamb_too(jax_mlp):
    _, params = jax_mlp
    for tx in (optax.lars(0.1, weight_decay=1e-4, momentum=0.9),
               optax.lamb(1e-3, weight_decay=1e-4)):
        with pytest.raises(ValueError, match="not element-wise"):
            jz._require_elementwise(tx, params)


def test_zero1_params_refuses_another_layout(comm):
    fac = _factory("sgd")
    model = MLP(n_units=UNITS, device="cpu")
    _, flat = tz.make_zero1_train_step(model, fac, comm)
    with pytest.raises(ValueError, match="WITHOUT bucket_bytes"):
        tz.zero1_params(flat, model, BUCKET)
    model = MLP(n_units=UNITS, device="cpu")
    _, bucketed = tz.make_zero1_train_step(model, fac, comm,
                                           bucket_bytes=BUCKET)
    with pytest.raises(ValueError, match="TUPLE of bucket shards"):
        tz.zero1_params(bucketed, model)
    with pytest.raises(ValueError, match="plans"):
        tz.zero1_params(bucketed, model, 1 << 30)
    got = tz.zero1_params(bucketed, model, BUCKET)
    for k, v in model.named_parameters():
        torch.testing.assert_close(got[k], v.detach(), rtol=0, atol=0)


def test_refusals_keep_jaxs_messages(comm):
    fac = _factory("sgd")
    model = MLP(n_units=4, device="cpu")
    model.l3.bias.data = model.l3.bias.data.double()
    with pytest.raises(ValueError, match="single param dtype"):
        tz.make_zero1_train_step(model, fac, comm)
    step, _ = tz.make_zero2_train_step(MLP(n_units=4, device="cpu"), fac,
                                       comm, n_microbatches=3)
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        step(np.zeros((4, 784), np.float32), np.zeros(4, np.int64))

    class Stateful(GradReducer):
        name, stateful = "stateful", True

    with pytest.raises(ValueError, match="implements no "
                                         "reduce_scatter_flat_ef"):
        tz.make_zero1_train_step(MLP(n_units=4, device="cpu"), fac, comm,
                                 grad_reducer=Stateful(comm))
    class TwoAxes:
        size, rank, axis_names = 1, 0, ("dcn", "ici")

        @property
        def axis_name(self):
            raise ValueError("communicator spans axes ('dcn', 'ici')")

    with pytest.raises(ValueError, match="spans axes"):
        tz.make_zero1_train_step(MLP(n_units=4, device="cpu"), fac,
                                 TwoAxes())
    from chainermn_torch.collectives import QuantizedReducer
    from chainermn_torch.models.resnet import CifarResNet

    with pytest.raises(ValueError, match="is stateful .error-feedback "
                                         "residuals.; the FSDP step"):
        tz.make_fsdp_train_step(MLP(n_units=4, device="cpu"), fac, comm,
                                grad_reducer=QuantizedReducer(comm))
    with pytest.raises(ValueError, match="unknown param_wire 'fp8'"):
        tz.make_fsdp_train_step(MLP(n_units=4, device="cpu"), fac, comm,
                                param_wire="fp8")
    with pytest.raises(ValueError, match="batch statistics"):
        tz.make_fsdp_train_step(CifarResNet(depth=8, device="cpu"), fac,
                                comm)


def test_dropping_step_and_state_frees_the_flat_vectors(comm):
    """The parameters keep their hooks; the hooks hold the step weakly,
    so the step, its state and the flat vectors die with their last
    reference, as the model does (a cycle through the hooks kept a
    135M model's 2 GB of vectors and state alive on the card)."""
    import weakref

    model = MLP(n_units=UNITS, device="cpu")
    step, state = tz.make_zero1_train_step(model, _factory("adam"), comm,
                                           bucket_bytes=BUCKET)
    step(np.zeros((2, 784), np.float32), np.zeros(2, np.int64))
    alive = [weakref.ref(t) for t in state.fulls + state.shards] + [
        weakref.ref(step), weakref.ref(state.optimizer)]
    del step, state, model
    assert all(r() is None for r in alive)
