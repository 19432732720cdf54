"""The port's FSDP (``chainermn_torch/optimizers/zero.py``, the FSDP
half) and the LM's scanned-stack loss against the JAX package's.

* The steps: a 2-rank gloo world (``run_world``) trains the MLP (784-16-
  16-10) for 3 steps through ``make_fsdp_train_step`` with Adam, SGD
  with momentum, ``remat``, ``param_wire`` bf16/int8-block/int4-block,
  a stateless ``QuantizedReducer`` (int8-block, int8) and LAMB, from the
  flax parameters converted; JAX's FSDP step runs on a 2-device CPU mesh
  from the same parameters on the same global batches. JAX's tolerances
  (``tests/optimizers_tests/test_zero.py:590-601``): losses rtol 2e-5,
  gathered parameters rtol 2e-4 and atol 5e-5. The quantized wires
  round the same values with the same scales (JAX's compiled scale is
  the block maximum times qmax's f32 reciprocal), so the codes are
  JAX's except where the two libraries' last bits put a value on the
  other side of a rounding boundary: those cases hold every element but
  one in a thousand to the bounds above, and that one within one
  quantization step's effect (STEPS x lr x the step).
* The LM (2 layers, d 64, vocab 256, L 16) through ``stack_lm_blocks``
  + ``make_lm_fsdp_scan_loss`` on the same 2 ranks, held to JAX's scan
  step and to the port's data-parallel step with ``fused_lm_loss``;
  ``train_lm --zero 3`` and ``--fsdp-scan`` on 2 ranks, their first
  losses within 1e-5 of ``train_lm``'s data-parallel run.
* The layout: ``fsdp_layout_manifest`` equals JAX's for the MLP and the
  stacked LM at n = 2, 4 and 8; ``fsdp_stack_shardings`` never splits
  dim 0 and agrees with JAX's; the stacked-tree warning; the stack /
  unstack round trip against JAX's.
* Memory: the live gathered bytes under the scan peak at one layer plus
  the unstacked leaves; the plain module step without ``remat`` holds
  every block's gathered matrices at once.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import functools
import pickle
import types
import warnings

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import chainermn_tpu
from chainermn_tpu.models.mlp import MLP as JMLP
from chainermn_tpu.models import transformer as jt
from chainermn_tpu.optimizers import zero as jz
from chainermn_torch.comm import create_communicator
from chainermn_torch.models import MLP
from chainermn_torch.models.convert import (flax_params,
                                            mlp_params_from_flax,
                                            params_from_flax,
                                            stacked_params_from_flax)
from chainermn_torch.models.transformer import (TransformerLM,
                                                lm_loss_with_aux,
                                                make_lm_fsdp_scan_loss,
                                                stack_lm_blocks,
                                                unstack_lm_blocks)
from chainermn_torch.optimizers import zero as tz
from tests.test_torch_mp import assert_ranks_ok, run_world

N, UNITS, STEPS, BATCH = 2, 16, 3, 8
LR_SGD, LR_ADAM, LR_LAMB, WD_LAMB, LR_LM = 0.1, 1e-3, 1e-3, 1e-4, 1e-3
LM = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=256,
          max_len=16)
LM_TOKENS = 4            # sequences a step (2 a rank)
RTOL_LOSS, RTOL_P, ATOL_P = 2e-5, 2e-4, 5e-5

# name: (optimizer, remat, param_wire, QuantizedReducer wire format)
MLP_CASES = {
    "adam": ("adam", False, None, None),
    "sgd": ("sgd", False, None, None),
    "remat": ("adam", True, None, None),
    "wire-bf16": ("sgd", False, "bf16", None),
    "wire-int8-block": ("sgd", False, "int8-block", None),
    "wire-int4-block": ("sgd", False, "int4-block", None),
    "reducer-int8-block": ("sgd", False, None, "int8-block"),
    "reducer-int8": ("sgd", False, None, "int8"),
    "lamb": ("lamb", False, None, None),
}
QUANTIZED = {"wire-int8-block": 1 / 127, "wire-int4-block": 1 / 7,
             "reducer-int8-block": 1 / 127, "reducer-int8": 1 / 127}

TRAIN_LM = ["--device", "cpu", "--d-model", "32", "--n-heads", "4",
            "--n-layers", "2", "--vocab", "128", "--seq-len", "16",
            "--n-train", "64", "--batchsize", "4", "--iterations", "2",
            "--lr", "3e-3"]
TRAIN_LM_MODES = {"dp": [], "zero3": ["--zero", "3"],
                  "fsdp-scan": ["--fsdp-scan"]}


def batches():
    """The MLP's global batches (the worker runs this function's
    source)."""
    rs = np.random.RandomState(3)
    return [(rs.rand(BATCH, 784).astype(np.float32),
             rs.randint(0, 10, size=BATCH).astype(np.int32))
            for _ in range(STEPS)]


def lm_tokens():
    rs = np.random.RandomState(4)
    toks = rs.randint(0, LM["vocab"], size=(STEPS, LM_TOKENS, 17))
    return toks.astype(np.int32)


_WORKER = r'''
import os, pickle, sys
import numpy as np
import torch
from chainermn_torch.collectives import QuantizedReducer
from chainermn_torch.comm import create_communicator
from chainermn_torch.models import MLP
from chainermn_torch.models.convert import (flax_params, params_from_flax,
                                            stacked_params_from_flax)
from chainermn_torch.models.transformer import (TransformerLM,
    make_lm_fsdp_scan_loss, stack_lm_blocks, unstack_lm_blocks)
from chainermn_torch.ops.fused_ce import fused_lm_loss
from chainermn_torch.optimizers import (LAMB, create_multi_node_optimizer,
    fsdp_gather_params, fsdp_shardings, fsdp_stack_shardings,
    make_fsdp_train_step)
from chainermn_torch.training.step import make_data_parallel_train_step

out = sys.argv[1]
with open(os.path.join(out, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
exec(inp["defs"])
comm = create_communicator("pure_nccl", device="cpu")
r, n = comm.rank, comm.size
FACTORY = {
    "sgd": lambda ps: torch.optim.SGD(ps, lr=LR_SGD, momentum=0.9),
    "adam": lambda ps: torch.optim.Adam(ps, lr=LR_ADAM, eps=1e-8),
    "lamb": lambda ps: LAMB(ps, LR_LAMB, weight_decay=WD_LAMB)}
res = {}
per = BATCH // n
for name, (opt, remat, wire, red) in MLP_CASES.items():
    model = MLP(n_units=UNITS, device="cpu")
    model.load_state_dict(inp["mlp"])
    reducer = (None if red is None else
               QuantizedReducer(comm, wire_format=red, ef=False))
    step, state = make_fsdp_train_step(model, FACTORY[opt], comm,
                                       remat=remat, grad_reducer=reducer,
                                       param_wire=wire)
    losses = [float(step(x[r * per:(r + 1) * per],
                         y[r * per:(r + 1) * per])["main/loss"])
              for x, y in batches()]
    res[name] = {"losses": losses, "params": fsdp_gather_params(state),
                 "state_numel": state.optimizer_state_numel()}

# the LM: the scan step, and the data-parallel step on the same ranks
toks = lm_tokens()
lper = toks.shape[1] // n
mine = slice(r * lper, (r + 1) * lper)
adam = lambda ps: torch.optim.Adam(ps, lr=LR_LM, eps=1e-8)
model = TransformerLM(**LM, device="cpu")
packed = stack_lm_blocks(stacked_params_from_flax(inp["lm"]))
sh = dict(fsdp_shardings(packed, comm),
          blocks=fsdp_stack_shardings(packed, comm)["blocks"])
step, state = make_fsdp_train_step(None, adam, comm, packed,
                                   loss_fn=make_lm_fsdp_scan_loss(model),
                                   param_shardings=sh)
losses = []
for t in toks:
    m = step(t[mine, :-1], t[mine, 1:])
    losses.append([float(m["main/loss"]), float(m["main/accuracy"])])
res["lm-scan"] = {"losses": losses, "params": fsdp_gather_params(state)}
model.load_state_dict(params_from_flax(model, inp["lm"]))
step = make_data_parallel_train_step(
    model, create_multi_node_optimizer(adam(list(model.parameters())),
                                       comm), comm, loss_fn=fused_lm_loss)
losses = []
for t in toks:
    m = step(t[mine, :-1], t[mine, 1:])
    losses.append([float(m["main/loss"]), float(m["main/accuracy"])])
res["lm-dp"] = {"losses": losses, "params": {
    k: v.detach().numpy().copy() for k, v in model.state_dict().items()}}

# the examples, on this world's communicator (a second world in one
# process is not made)
from chainermn_torch.examples import train_lm
train_lm.create_communicator = lambda *args, **kwargs: comm
for mode, flags in TRAIN_LM_MODES.items():
    trainer, _ = train_lm.build_trainer(train_lm.parse_args(
        TRAIN_LM + flags + ["--out", os.path.join(out, mode)]))
    up, seen = trainer.updater, []
    step = up.step_fn
    def rec(x, y, step=step, seen=seen):
        m = step(x, y)
        seen.append(float(m["main/loss"]))
        return m
    up.step_fn = rec
    trainer.run()
    res["train_lm-" + mode] = seen
comm.finalize()
with open(os.path.join(out, f"rank{r}.pkl"), "wb") as f:
    pickle.dump(res, f)
print(f"RANK{int(os.environ['RANK'])} OK", flush=True)
'''


def _worker_defs() -> str:
    import inspect

    consts = (f"N, UNITS, STEPS, BATCH = {N}, {UNITS}, {STEPS}, {BATCH}\n"
              f"LR_SGD, LR_ADAM, LR_LAMB, WD_LAMB, LR_LM = {LR_SGD}, "
              f"{LR_ADAM}, {LR_LAMB}, {WD_LAMB}, {LR_LM}\n"
              f"LM = {LM!r}\nLM_TOKENS = {LM_TOKENS}\n"
              f"MLP_CASES = {MLP_CASES!r}\nTRAIN_LM = {TRAIN_LM!r}\n"
              f"TRAIN_LM_MODES = {TRAIN_LM_MODES!r}\n")
    return consts + inspect.getsource(batches) + inspect.getsource(
        lm_tokens)


@functools.lru_cache(maxsize=None)
def _jax_mlp():
    model = JMLP(n_units=UNITS)
    params = model.init(jax.random.PRNGKey(0),
                        np.zeros((1, 784), np.float32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _jax_lm():
    model = jt.TransformerLM(**LM)
    params = model.init(jax.random.PRNGKey(1),
                        np.zeros((1, 16), np.int32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp")
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump({"mlp": mlp_params_from_flax(_jax_mlp()[1]),
                     "lm": _jax_lm()[1], "defs": _worker_defs()}, f)
    assert_ranks_ok(run_world(_WORKER, N, timeout=300, args=[str(d)]))
    return [pickle.loads((d / f"rank{r}.pkl").read_bytes())
            for r in range(N)]


def _comm(n):
    return chainermn_tpu.create_communicator(
        "xla", mesh=Mesh(np.array(jax.devices()[:n]), ("r",)))


def _flat(tree):
    return {"/".join(map(str, kp)): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_fsdp_mlp(name):
    opt, remat, wire, red = MLP_CASES[name]
    model, params = _jax_mlp()
    comm = _comm(N)
    tx = {"sgd": optax.sgd(LR_SGD, momentum=0.9),
          "adam": optax.adam(LR_ADAM),
          "lamb": optax.lamb(LR_LAMB, weight_decay=WD_LAMB)}[opt]
    reducer = None
    if red is not None:
        from chainermn_tpu.collectives import QuantizedReducer

        reducer = QuantizedReducer(comm, mode=red, ef=False)
    step, state = jz.make_fsdp_train_step(
        model, tx, comm, params, donate=False, remat=remat,
        grad_reducer=reducer, param_wire=wire)
    losses = []
    for x, y in batches():
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(m["main/loss"]))
    return losses, jz.fsdp_gather_params(state)


def _hold(got, want, allow_off=0.0, bound=None):
    """Every leaf of ``got`` within rtol 2e-4 / atol 5e-5 of ``want``;
    with ``allow_off``, that share of a leaf's elements (at least one)
    may instead lie within ``bound``."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k, v in want.items():
        g = got[k]
        assert g.shape == v.shape, k
        if not allow_off:
            np.testing.assert_allclose(g, v, rtol=RTOL_P, atol=ATOL_P,
                                       err_msg=k)
            continue
        off = np.abs(g - v) > ATOL_P + RTOL_P * np.abs(v)
        assert off.sum() <= max(1, int(v.size * allow_off)), (k, off.sum())
        assert np.abs(g - v).max() <= bound, k


@pytest.mark.parametrize("name", list(MLP_CASES))
def test_fsdp_steps_match_jax_on_two_ranks(world, name):
    want_losses, want = _jax_fsdp_mlp(name)
    r0, r1 = world[0][name], world[1][name]
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], want_losses, rtol=RTOL_LOSS)
    for k, v in _flat(r0["params"]).items():
        np.testing.assert_array_equal(v, _flat(r1["params"])[k])
    if name in QUANTIZED:
        # one code on the other side of a rounding boundary moves its
        # weight's update by one quantization step of its block
        lr = LR_SGD
        _hold(r0["params"], want, allow_off=1e-3,
              bound=STEPS * lr * 2 * QUANTIZED[name])
    else:
        _hold(r0["params"], want)


def test_fsdp_shards_the_optimizer_state(world):
    """Each rank's optimizer state holds half of every split leaf (every
    MLP leaf splits over 2: 784, 16, 16 and 10 rows are even)."""
    _, params = _jax_mlp()
    total = sum(int(np.size(v)) for v in jax.tree_util.tree_leaves(params))
    assert world[0]["adam"]["state_numel"] == 2 * total // N
    assert world[0]["sgd"]["state_numel"] == total // N
    assert world[0]["lamb"]["state_numel"] == 2 * total // N


def _jax_lm_scan():
    import sys

    sys.path.insert(0, "tests")
    from lm_scan_helpers import lm_scan_setup

    model, params = _jax_lm()
    step, state = lm_scan_setup(_comm(N), model, params, optax.adam(LR_LM))
    losses = []
    for t in lm_tokens():
        state, m = step(state, jnp.asarray(t[:, :-1]),
                        jnp.asarray(t[:, 1:]))
        losses.append([float(m["main/loss"]), float(m["main/accuracy"])])
    return losses, jz.fsdp_gather_params(state)


def test_lm_scan_matches_jax_and_the_data_parallel_step(world):
    want_losses, want = _jax_lm_scan()
    scan, dp = world[0]["lm-scan"], world[0]["lm-dp"]
    assert world[1]["lm-scan"]["losses"] == scan["losses"]
    np.testing.assert_allclose(scan["losses"], want_losses, rtol=RTOL_LOSS)
    _hold(scan["params"], want)
    np.testing.assert_allclose(scan["losses"], dp["losses"], rtol=RTOL_LOSS)
    model = TransformerLM(**LM, device="cpu")
    got = params_from_flax(model, unstack_lm_blocks(scan["params"]))
    for k, v in dp["params"].items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=RTOL_P,
                                   atol=ATOL_P, err_msg=k)


def test_train_lm_zero3_and_fsdp_scan_match_the_dp_run(world):
    dp = world[0]["train_lm-dp"]
    assert len(dp) == 2
    for mode in ("zero3", "fsdp-scan"):
        got = world[0]["train_lm-" + mode]
        assert got == world[1]["train_lm-" + mode]
        np.testing.assert_allclose(got[0], dp[0], rtol=1e-5)
        np.testing.assert_allclose(got, dp, rtol=1e-4)


# -- the layout ---------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_layout_manifest_equals_jax(n):
    comm = types.SimpleNamespace(size=n, axis_name="r")
    jcomm = _comm(n)
    _, mparams = _jax_mlp()
    port = MLP(n_units=UNITS, device="cpu")
    assert tz.fsdp_layout_manifest(port, comm) == \
        jz.fsdp_layout_manifest(mparams, jcomm)
    _, lparams = _jax_lm()
    jpacked = jt.stack_lm_blocks(lparams)
    jsh = dict(jz.fsdp_shardings(jpacked, jcomm),
               blocks=jz.fsdp_stack_shardings(jpacked, jcomm)["blocks"])
    packed = stack_lm_blocks(stacked_params_from_flax(lparams))
    sh = dict(tz.fsdp_shardings(packed, comm),
              blocks=tz.fsdp_stack_shardings(packed, comm)["blocks"])
    assert tz.fsdp_layout_manifest(packed, comm, sh) == \
        jz.fsdp_layout_manifest(jpacked, jcomm, jsh)
    # the module form of the LM: the unstacked flax tree's manifest
    lm = TransformerLM(**LM, device="cpu")
    assert tz.fsdp_layout_manifest(lm, comm) == \
        jz.fsdp_layout_manifest(lparams, jcomm)


def test_module_shardings_are_flax_dims_in_torch_layout():
    """A Dense kernel [in, out] splits ``in`` in flax's layout, which is
    dim 1 of the torch weight [out, in]."""
    comm = types.SimpleNamespace(size=2, axis_name="r")
    specs = tz.fsdp_shardings(MLP(n_units=UNITS, device="cpu"), comm)
    assert specs == {"l1.bias": 0, "l1.weight": 1, "l2.bias": 0,
                     "l2.weight": 1, "l3.bias": 0, "l3.weight": 1}
    comm = types.SimpleNamespace(size=16, axis_name="r")
    specs = tz.fsdp_shardings(MLP(n_units=UNITS, device="cpu"), comm)
    # the 10-wide bias has fewer rows than ranks: whole (the min-shard
    # rule)
    assert specs["l1.weight"] == specs["l3.weight"] == 1
    assert specs["l3.bias"] is None


@pytest.mark.parametrize("n", [2, 4])
def test_stack_shardings_never_split_the_layer_dim(n):
    comm = types.SimpleNamespace(size=n, axis_name="r")
    jcomm = _comm(n)
    _, lparams = _jax_lm()
    packed = stack_lm_blocks(stacked_params_from_flax(lparams))
    naive = tz.fsdp_shardings(packed, comm)["blocks"]
    stack = tz.fsdp_stack_shardings(packed, comm)["blocks"]
    want = jz.fsdp_stack_shardings(jt.stack_lm_blocks(lparams), jcomm)
    flat_n, flat_s = dict(tz._tree_items(naive)), dict(
        tz._tree_items(stack))
    jflat = {tuple(str(getattr(k, "key", k)) for k in kp): sh.spec
             for kp, sh in jax.tree_util.tree_flatten_with_path(
                 want["blocks"])[0]}
    # the plain rule takes the layer dim where n divides L = 2
    assert any(v == 0 for v in flat_n.values()) == (n == 2)
    for path, k in flat_s.items():
        assert k != 0, path
        spec = jflat[tuple(map(str, path))]
        assert ([] if k is None else [None] * k + ["r"]) == list(spec)


def test_stacked_tree_warns_without_stack_shardings():
    comm = create_communicator("pure_nccl", device="cpu")
    try:
        _, lparams = _jax_lm()
        packed = stack_lm_blocks(stacked_params_from_flax(lparams))
        loss = make_lm_fsdp_scan_loss(TransformerLM(**LM, device="cpu"))
        fac = lambda ps: torch.optim.SGD(ps, lr=0.1)  # noqa: E731
        with pytest.warns(UserWarning, match="looks like a scanned layer "
                                             "stack"):
            tz.make_fsdp_train_step(None, fac, comm, packed, loss_fn=loss)
        sh = dict(tz.fsdp_shardings(packed, comm),
                  blocks=tz.fsdp_stack_shardings(packed, comm)["blocks"])
        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)
            tz.make_fsdp_train_step(None, fac, comm, packed, loss_fn=loss,
                                    param_shardings=sh)
        found = tz._find_stacked_subtree(packed, 1)
        assert found.startswith("blocks/")
        assert jz._find_stacked_subtree(jt.stack_lm_blocks(lparams), 1) \
            == found
    finally:
        comm.finalize()


def test_stack_unstack_round_trip_equals_jax():
    _, lparams = _jax_lm()
    want = _flat(jt.stack_lm_blocks(lparams))
    tree = stacked_params_from_flax(lparams)
    packed = stack_lm_blocks(tree)
    got = {k: np.asarray(v) for k, v in _flat(
        jax.tree_util.tree_map(lambda t: t.numpy(), packed)).items()}
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    back = unstack_lm_blocks(packed)
    for k, v in _flat(lparams).items():
        np.testing.assert_array_equal(
            _flat(jax.tree_util.tree_map(lambda t: t.numpy(), back))[k], v)
    # the port's own model → its flax tree → stacked → unstacked → back
    lm = TransformerLM(**LM, device="cpu")
    sd = params_from_flax(lm, jax.tree_util.tree_map(
        lambda t: t.numpy(), unstack_lm_blocks(stack_lm_blocks(
            flax_params(lm)))))
    for k, v in lm.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_scan_loss_refusals_keep_jaxs_messages():
    with pytest.raises(ValueError, match="no 128-multiple tile divisor"):
        make_lm_fsdp_scan_loss(TransformerLM(**dict(LM, vocab=100),
                                             device="cpu"))
    moe = TransformerLM(**LM, device="cpu")
    moe.moe_experts_per_device = 2
    with pytest.raises(ValueError, match="MoE models"):
        make_lm_fsdp_scan_loss(moe)
    tp = TransformerLM(**LM, device="cpu")
    tp.tp_axis = "model"
    with pytest.raises(ValueError, match="tp_axis/seq_axis"):
        make_lm_fsdp_scan_loss(tp)
    dec = TransformerLM(**LM, device="cpu")
    dec.decode = True
    with pytest.raises(ValueError, match="decode/lm_head_tp"):
        make_lm_fsdp_scan_loss(dec)


def test_fsdp_refuses_an_optimizer_that_is_not_elementwise():
    class LeafNormalized(torch.optim.SGD):
        """SGD on each leaf's gradient over its norm: not element-wise."""

        @torch.no_grad()
        def step(self, closure=None):
            for group in self.param_groups:
                for p in group["params"]:
                    p.add_(p.grad / (p.grad.norm() + 1e-12),
                           alpha=-group["lr"])

    comm = create_communicator("pure_nccl", device="cpu")
    try:
        with pytest.raises(ValueError, match="not element-wise"):
            tz.make_fsdp_train_step(MLP(n_units=4, device="cpu"),
                                    lambda ps: LeafNormalized(ps, lr=0.1),
                                    comm)
    finally:
        comm.finalize()


# -- gathered bytes -----------------------------------------------------------

def test_scan_peaks_at_one_layer_and_the_plain_step_holds_them_all():
    comm = create_communicator("pure_nccl", device="cpu")
    try:
        _, lparams = _jax_lm()
        toks = lm_tokens()[0]
        x, y = toks[:, :-1], toks[:, 1:]
        fac = lambda ps: torch.optim.SGD(ps, lr=0.1)  # noqa: E731
        model = TransformerLM(**LM, device="cpu")
        packed = stack_lm_blocks(stacked_params_from_flax(lparams))
        sh = dict(tz.fsdp_shardings(packed, comm),
                  blocks=tz.fsdp_stack_shardings(packed, comm)["blocks"])
        step, state = tz.make_fsdp_train_step(
            None, fac, comm, packed, loss_fn=make_lm_fsdp_scan_loss(model),
            param_shardings=sh)
        step(x, y)
        layer = sum(v[0].numel() * 4 for _, v in
                    tz._tree_items(packed["blocks"]))
        rest = sum(v.numel() * 4 for path, v in tz._tree_items(packed)
                   if path[0] != "blocks")
        assert layer <= state.gathered_bytes_peak <= layer + rest
        assert state.layer_bytes_peak == layer
        assert state.gathered_bytes == state.layer_bytes == 0

        model = TransformerLM(**LM, device="cpu")
        model.load_state_dict(params_from_flax(model, lparams))
        step, state = tz.make_fsdp_train_step(model, fac, comm,
                                              loss_fn=lm_loss_with_aux)
        step(x, y)
        matrices = sum(p.numel() * 4 for n_, p in
                       TransformerLM(**LM, device="cpu").named_parameters()
                       if n_.startswith("blocks.") and p.ndim == 2)
        # every block's matrices at once: past the scan's bound
        assert state.gathered_bytes_peak >= matrices > layer + rest
        assert state.gathered_bytes == 0
    finally:
        comm.finalize()
