"""The MNIST slice against the JAX package: the port's ``Trainer`` /
``StandardUpdater`` / ``Evaluator`` / ``LogReport`` train the MLP as the
JAX ones do from the same converted parameters and batches; triggers,
closing extensions, preemption and the chaos/watchdog switches;
and the port's MNIST example in a 2-rank gloo world against one rank fed
both ranks' batches.

Tolerances: per-step losses and validation metrics at rtol 1e-4 against
JAX (f32 sums in another order over eight Adam steps); parameters at rtol
1e-4 per tensor and 1e-4 per element (see ``_assert_params``); one Adam
update at 1e-6; the 2-rank run against the 1-rank run at 1e-5 (one framework,
the two half-batch means averaged instead of one mean). The first step
is also checked piece by piece (see its test)."""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import os
import pickle
import signal

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import chainermn_tpu
from chainermn_tpu.datasets.toy import synthetic_mnist as jax_synthetic_mnist
from chainermn_tpu.iterators import SerialIterator as JaxSerialIterator
from chainermn_tpu.models import MLP as JaxMLP
from chainermn_tpu.training import StandardUpdater as JaxUpdater
from chainermn_tpu.training import Trainer as JaxTrainer
from chainermn_tpu.training.evaluator import Evaluator as JaxEvaluator
from chainermn_tpu.training.reports import LogReport as JaxLogReport
from chainermn_tpu.training.step import classifier_loss as jax_loss
from chainermn_tpu.training.step import make_data_parallel_train_step as \
    jax_make_step
from chainermn_tpu.training.step import make_eval_step as jax_make_eval
from chainermn_torch import (create_communicator,
                             create_multi_node_evaluator,
                             create_multi_node_optimizer, scatter_dataset)
from chainermn_torch.datasets import (SubDataset, load_mnist, split_indices,
                                      synthetic_mnist)
from chainermn_torch.iterators import SerialIterator
from chainermn_torch.models import MLP
from chainermn_torch.models.convert import mlp_params_from_flax
from chainermn_torch.resilience import PREEMPTED_EXIT_CODE, main_exit_code
from chainermn_torch.training import (Evaluator, LogReport, PrintReport,
                                      StandardUpdater, Trainer,
                                      classifier_loss,
                                      make_data_parallel_train_step,
                                      make_eval_step)
from tests.test_torch_mp import assert_ranks_ok, run_world

UNITS = 64


@pytest.fixture()
def comm():
    c = create_communicator("naive", device="cpu")
    yield c
    c.finalize()


def _flax_mlp_params():
    jm = JaxMLP(n_units=UNITS, n_out=10)
    return jm, jm.init(jax.random.PRNGKey(0),
                       np.zeros((2, 28, 28), np.float32))["params"]


def _port_mlp(params):
    model = MLP(n_units=UNITS, device="cpu")
    model.load_state_dict(mlp_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return model


def _port_step(model, comm, lr=1e-3):
    opt = create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8), comm)
    return make_data_parallel_train_step(model, opt, comm)


def _assert_params(model, params):
    """Each tensor within rtol 1e-4 in L2 norm, and every element within
    1e-4 absolute: a tenth of one Adam step's lr, room for a weight whose
    gradient cancels to ~1e-7 in some step, where Adam's lr * g / (|g| +
    eps) turns last-bit differences into a visible part of a step (1.3e-5
    in one of 50,176 first-layer weights)."""
    want = mlp_params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    got = model.state_dict()
    for k in want:
        rel = (got[k] - want[k]).norm() / want[k].norm()
        assert rel < 1e-4, (k, rel.item())
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-4, msg=k)


def test_one_adam_step_matches_optax(comm):
    """The port's first step against JAX's: the loss and accuracy it
    reports (1e-5), each gradient (relative L2 1e-5), and
    ``torch.optim.Adam(lr=1e-3, eps=1e-8)`` behind the multi-node
    optimizer fed JAX's gradients against ``optax.adam(1e-3)``'s update
    (1e-6). The update is compared on the same gradients because Adam's
    first step is lr * g / (|g| + eps): a weight whose gradient cancels
    to ~1e-7 moves by a visible part of lr when its last bits differ."""
    jm, params = _flax_mlp_params()
    ds = jax_synthetic_mnist(64, seed=3)
    x, y = ds.xs, ds.ys
    (loss, (acc, _)), g = jax.value_and_grad(
        lambda p: jax_loss(jm, p, x, y), has_aux=True)(params)
    jgrads = mlp_params_from_flax(jax.tree_util.tree_map(np.asarray, g))

    model = _port_mlp(params)
    tloss, (tacc, _) = classifier_loss(model, torch.from_numpy(x),
                                       torch.from_numpy(y))
    tloss.backward()
    torch.testing.assert_close(tloss.detach(), torch.tensor(float(loss)),
                               rtol=1e-5, atol=1e-6)
    assert float(tacc) == float(acc)
    for k, p in model.named_parameters():
        rel = (p.grad - jgrads[k]).norm() / jgrads[k].norm()
        assert rel < 1e-5, (k, rel.item())
        p.grad = jgrads[k].clone()
    create_multi_node_optimizer(torch.optim.Adam(
        model.parameters(), lr=1e-3, eps=1e-8), comm).step()
    tx = optax.adam(1e-3)
    upd, _ = tx.update(g, tx.init(params), params)
    want = mlp_params_from_flax(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, upd)))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=1e-6, msg=k)


def test_trainer_matches_the_jax_trainer(comm):
    """MLP(64), one epoch of 512 samples at batch 64 (8 steps), each side
    through its own scatter_dataset → SerialIterator(seed 0) →
    StandardUpdater → Trainer with an Evaluator at the epoch and a
    LogReport at every iteration, from the same converted parameters: the
    per-step losses and accuracies, the validation metrics and the final
    parameters agree."""
    jm, params = _flax_mlp_params()
    model = _port_mlp(params)   # before the JAX step donates them
    # JAX: one process, the 8-device CPU mesh; the batch is split over it
    jcomm = chainermn_tpu.create_communicator("xla")
    jtrain = chainermn_tpu.scatter_dataset(jax_synthetic_mnist(512, seed=0),
                                           jcomm, shuffle=True, seed=0)
    jtest = jax_synthetic_mnist(128, seed=1)
    jopt = chainermn_tpu.create_multi_node_optimizer(optax.adam(1e-3), jcomm)
    jp = jcomm.bcast_data(params)
    jupd = JaxUpdater(JaxSerialIterator(jtrain, 64, shuffle=True, seed=0),
                      jax_make_step(jm, jopt, jcomm), (jp, jopt.init(jp)),
                      jcomm)
    jtr = JaxTrainer(jupd, stop_trigger=(1, "epoch"))
    jev = JaxEvaluator(lambda: JaxSerialIterator(jtest, 64, repeat=False,
                                                 shuffle=False),
                       jax_make_eval(jm, jcomm), jupd)
    jtr.extend(lambda t: jev(t), trigger=(1, "epoch"))
    jlog = JaxLogReport()
    jtr.extend(jlog, trigger=(1, "iteration"))
    jtr.run()

    # the port: one rank
    train = scatter_dataset(synthetic_mnist(512, seed=0), comm,
                            shuffle=True, seed=0)
    test = comm.bcast_obj(synthetic_mnist(128, seed=1))
    comm.bcast_data(model)
    upd = StandardUpdater(SerialIterator(train, 64, shuffle=True, seed=0),
                          _port_step(model, comm), comm)
    tr = Trainer(upd, stop_trigger=(1, "epoch"))
    ev = create_multi_node_evaluator(Evaluator(
        lambda: SerialIterator(test, 64, repeat=False, shuffle=False),
        make_eval_step(model, comm), upd), comm)
    tr.extend(ev, trigger=(1, "epoch"))
    log = LogReport()
    tr.extend(log, trigger=(1, "iteration"))
    tr.run()

    assert len(log.log) == len(jlog.log) == 8
    for key in ("main/loss", "main/accuracy"):
        np.testing.assert_allclose([e[key] for e in log.log],
                                   [e[key] for e in jlog.log], rtol=1e-4,
                                   err_msg=key)
    assert [e["iteration"] for e in log.log] == list(range(1, 9))
    assert log.log[-1]["epoch"] == 1 and upd.epoch == 1
    for key in ("validation/main/loss", "validation/main/accuracy"):
        np.testing.assert_allclose(tr.observation[key],
                                   jtr.observation[key], rtol=1e-4,
                                   err_msg=key)
    assert log.log[-1]["main/loss"] < log.log[0]["main/loss"]
    _assert_params(model, jupd.state[0])


def _tiny_trainer(comm, stop, n=256):
    model = MLP(n_units=16, device="cpu")
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), comm)
    it = SerialIterator(synthetic_mnist(n, seed=0), 64, shuffle=False)
    return Trainer(StandardUpdater(
        it, make_data_parallel_train_step(model, opt, comm), comm,
        model=model, optimizer=opt), stop_trigger=stop)


def test_trainer_iteration_trigger_counts(comm):
    """Counterpart of the JAX ``test_trainer_iteration_trigger_counts``;
    epoch triggers fire at the epoch ends (4 iterations an epoch)."""
    trainer = _tiny_trainer(comm, (8, "iteration"))
    fires, epochs = [], []
    trainer.extend(lambda t: fires.append(t.updater.iteration),
                   trigger=(2, "iteration"))
    trainer.extend(lambda t: epochs.append(t.observation["iteration"]),
                   trigger=(1, "epoch"))
    trainer.run()
    assert fires == [2, 4, 6, 8] and epochs == [4, 8]
    assert isinstance(trainer.observation["main/loss"], float)


def test_trainer_closes_extensions_on_exit(comm):
    """Counterpart of the JAX ``test_trainer_closes_extensions_on_exit``,
    also when the step raises; a finished Trainer refuses to run again."""
    closed = []

    class Ext:
        def __call__(self, t):
            pass

        def close(self):
            closed.append(True)

    trainer = _tiny_trainer(comm, (2, "iteration"))
    trainer.extend(Ext(), trigger=(1, "iteration"))
    trainer.run()
    assert closed == [True]
    with pytest.raises(RuntimeError, match="already ran"):
        trainer.run()

    trainer = _tiny_trainer(comm, (2, "iteration"))
    trainer.extend(Ext(), trigger=(1, "iteration"))

    def boom(*arrays):
        raise KeyError("step failed")

    trainer.updater.step_fn = boom
    with pytest.raises(KeyError, match="step failed"):
        trainer.run()
    assert closed == [True, True]


@pytest.mark.parametrize("var,value", [
    ("CHAINERMN_TPU_CHAOS", "kill@step=1,signal=SIGTERM"),
    ("CHAINERMN_TPU_WATCHDOG", "1"),
    ("CHAINERMN_TPU_WATCHDOG", "0")])
def test_chaos_and_watchdog_switches_drive_the_run(comm, monkeypatch, var,
                                                   value):
    """The run honours the JAX package's switches: a chaos kill at step 1
    (a SIGTERM, which the run's own handler takes: a preemption at
    iteration 1); ``$CHAINERMN_TPU_WATCHDOG=1`` starts no watchdog in a
    world of one (the two-rank case is in ``test_torch_resilience.py``),
    and ``0`` none at all."""
    from chainermn_torch.resilience import guard, watchdog

    monkeypatch.setenv(var, value)
    trainer = _tiny_trainer(comm, (3, "iteration"))
    seen = []
    trainer.extend(lambda t: seen.append(watchdog.current_watchdog()),
                   trigger=(1, "iteration"))
    try:
        trainer.run()
    finally:
        guard().reset()     # the process-wide flag outlives the run
    if var == "CHAINERMN_TPU_CHAOS":
        assert trainer.preempted and trainer.updater.iteration in (1, 2)
        assert trainer.exit_code() == PREEMPTED_EXIT_CODE
    else:
        assert not trainer.preempted and trainer.updater.iteration == 3
        assert seen == [None] * 3


def test_host_state_round_trip_draws_the_same_next_batch(comm):
    trainer = _tiny_trainer(comm, (3, "iteration"), n=200)
    trainer.run()
    host = pickle.loads(pickle.dumps(trainer.updater.host_state_dict()))
    ahead = [b[1] for b in next(trainer.updater.iterator)]
    resumed = _tiny_trainer(comm, (3, "iteration"), n=200)
    resumed.updater.load_host_state(host)
    assert resumed.updater.iteration == 3
    assert [b[1] for b in next(resumed.updater.iterator)] == ahead


def test_log_and_print_reports(comm, tmp_path, capsys):
    trainer = _tiny_trainer(comm, (2, "iteration"))
    path = tmp_path / "sub" / "log.jsonl"
    log = LogReport(str(path))
    trainer.extend(log, trigger=(1, "iteration"))
    trainer.extend(PrintReport(["iteration", "main/loss", "missing"]),
                   trigger=(1, "iteration"))
    trainer.run()
    lines = path.read_text().splitlines()
    assert len(lines) == 2 and '"iteration": 2' in lines[1]
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["iteration", "main/loss", "missing"]
    assert out[2].split()[0] == "2" and out[2].split()[2] == "nan"


_PREEMPT = r'''
import os, signal, sys
from chainermn_torch.comm import create_communicator
from chainermn_torch.datasets import synthetic_mnist
from chainermn_torch.iterators import SerialIterator
from chainermn_torch.models import MLP
from chainermn_torch.optimizers import create_multi_node_optimizer
from chainermn_torch.resilience import PREEMPTED_EXIT_CODE, main_exit_code
from chainermn_torch.training import (StandardUpdater, Trainer,
                                      make_data_parallel_train_step)
import torch

comm = create_communicator("naive", device="cpu")
model = MLP(n_units=8, device="cpu")
opt = create_multi_node_optimizer(torch.optim.SGD(model.parameters(),
                                                  lr=0.1), comm)
trainer = Trainer(StandardUpdater(
    SerialIterator(synthetic_mnist(128, seed=0), 16),
    make_data_parallel_train_step(model, opt, comm), comm),
    stop_trigger=(100, "iteration"))
trainer.extend(lambda t: os.kill(os.getpid(), signal.SIGTERM)
               if t.updater.iteration == 2 else None,
               trigger=(1, "iteration"))

def main():
    trainer.run()
    return trainer

rc = main_exit_code(main)
comm.finalize()
print(f"RANK0 preempted={trainer.preempted} "
      f"iteration={trainer.updater.iteration} "
      f"exit_code={trainer.exit_code()} "
      f"handler_restored={signal.getsignal(signal.SIGTERM) is signal.SIG_DFL}",
      flush=True)
sys.exit(rc)
'''


def test_sigterm_preempts_the_run_with_exit_code_143():
    """A SIGTERM during iteration 2 ends the loop before iteration 3:
    ``trainer.preempted``, ``exit_code() == 143``, ``main_exit_code``
    gives 143, and the previous SIGTERM handler is back."""
    [(rc, out)] = run_world(_PREEMPT, 1, timeout=60)
    assert rc == 143, out[-3000:]
    assert ("RANK0 preempted=True iteration=2 exit_code=143 "
            "handler_restored=True") in out, out[-3000:]


def test_main_exit_code_is_zero_without_preemption():
    class Done:
        preempted = False

    assert main_exit_code(lambda: Done()) == 0
    assert main_exit_code(lambda: None) == 0


_EXAMPLE_WORKER = r'''
import os, pickle, sys
from chainermn_torch.examples import train_mnist
from chainermn_torch.training import LogReport

out = sys.argv[1]
args = train_mnist.parse_args(
    ["--device", "cpu", "--communicator", "naive", "--epoch", "1",
     "--unit", "32", "--n-train", "256", "--batchsize", "16", "--out", out])
trainer, model = train_mnist.build_trainer(args)
comm = trainer.updater.comm
log = LogReport()
trainer.extend(log, trigger=(1, "iteration"))
trainer.run()
with open(os.path.join(out, f"rank{comm.rank}.pkl"), "wb") as f:
    pickle.dump({"losses": [e["main/loss"] for e in log.log],
                 "params": model.state_dict()}, f)
print(f"RANK{comm.rank} OK", flush=True)
comm.finalize()
'''


def test_example_two_ranks_match_one_rank_on_both_batches(tmp_path):
    """``chainermn_torch.examples.train_mnist`` in a 2-rank gloo world
    (256 synthetic IDX samples scattered as payloads, per-rank batch 16,
    MLP(32), one epoch = 8 steps): each step's loss equals a 1-rank Adam
    run on the two ranks' batches concatenated (1e-5), the parameters
    are identical on both ranks and equal the 1-rank run's (1e-5), and
    the validation accuracy is reported on rank 0."""
    results = run_world(_EXAMPLE_WORKER, 2, timeout=120,
                        args=[str(tmp_path)])
    assert_ranks_ok(results)
    assert "validation/main/accuracy" in results[0][1]
    got = [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())
           for r in range(2)]
    assert got[0]["losses"] == got[1]["losses"]
    for k, v in got[0]["params"].items():
        assert torch.equal(v, got[1]["params"][k]), k

    train = load_mnist(str(tmp_path / "mnist-data"), train=True)
    plans = split_indices(len(train), 2, shuffle=True, seed=0)
    its = [SerialIterator(SubDataset(train, p), 16, shuffle=True, seed=0)
           for p in plans]
    torch.manual_seed(0)
    model = MLP(n_units=32, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
    losses = []
    for _ in range(len(got[0]["losses"])):
        batch = next(its[0]) + next(its[1])
        x = torch.from_numpy(np.stack([b[0] for b in batch]))
        y = torch.from_numpy(np.stack([b[1] for b in batch]))
        opt.zero_grad()
        loss, _ = classifier_loss(model, x, y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert len(losses) == 8 and its[0].epoch == 1
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5,
                               atol=1e-5)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(got[0]["params"][k], v, rtol=1e-5,
                                   atol=1e-5, msg=k)


# -- the emergency checkpoint ------------------------------------------------

def test_an_exception_in_the_run_fires_emergency_save_then_reraises(
        comm, tmp_path):
    """A step that raises at iteration 3: every extension offering
    ``emergency_save`` (the checkpointer) publishes the state at
    iteration 2 before the exception leaves ``run``; a fresh updater
    resumes from it with the model's values at the failure. A failing
    ``emergency_save`` is printed and does not mask the exception."""
    from chainermn_torch.extensions import create_multi_node_checkpointer

    trainer = _tiny_trainer(comm, (10, "iteration"))
    ck = create_multi_node_checkpointer("crash", comm, path=str(tmp_path),
                                        async_write=True)
    trainer.extend(ck, trigger=(5, "iteration"))

    class Broken:
        def __call__(self, t):
            pass

        def emergency_save(self, t):
            raise OSError("disk full")

    trainer.extend(Broken(), trigger=(1, "iteration"))
    up = trainer.updater
    step = up.step_fn

    def fails_at_3(*arrays):
        if up.iteration == 2:
            raise KeyError("step failed")
        return step(*arrays)

    up.step_fn = fails_at_3
    with pytest.raises(KeyError, match="step failed"):
        trainer.run()
    assert up.iteration == 2
    assert sorted(os.listdir(ck.path)) == ["snapshot_iter_2.0",
                                           "snapshot_iter_2.0.json"]
    fresh = _tiny_trainer(comm, (10, "iteration")).updater
    ck2 = create_multi_node_checkpointer("crash", comm, path=str(tmp_path))
    assert ck2.resume(fresh) == 2 and fresh.iteration == 2
    for k, v in up.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k


_PREEMPT_SAVE = r'''
import os, signal, sys
from chainermn_torch.comm import create_communicator
from chainermn_torch.datasets import synthetic_mnist
from chainermn_torch.extensions import create_multi_node_checkpointer
from chainermn_torch.iterators import SerialIterator
from chainermn_torch.models import MLP
from chainermn_torch.optimizers import create_multi_node_optimizer
from chainermn_torch.training import (StandardUpdater, Trainer,
                                      make_data_parallel_train_step)
import torch

comm = create_communicator("naive", device="cpu")
model = MLP(n_units=8, device="cpu")
opt = create_multi_node_optimizer(torch.optim.SGD(model.parameters(),
                                                  lr=0.1), comm)
trainer = Trainer(StandardUpdater(
    SerialIterator(synthetic_mnist(128, seed=0), 16),
    make_data_parallel_train_step(model, opt, comm), comm, model=model,
    optimizer=opt), stop_trigger=(100, "iteration"))
ck = create_multi_node_checkpointer("pre", comm, path=sys.argv[1])
trainer.extend(ck, trigger=(50, "iteration"))
trainer.extend(lambda t: os.kill(os.getpid(), signal.SIGTERM)
               if t.updater.iteration == 3 else None,
               trigger=(1, "iteration"))
trainer.run()
files = sorted(os.listdir(ck.path))
comm.finalize()
print(f"RANK0 preempted={trainer.preempted} files={files}", flush=True)
sys.exit(trainer.exit_code())
'''


def test_preemption_fires_emergency_save(tmp_path):
    """A SIGTERM during iteration 3 (in a subprocess): the loop's poll
    fires the checkpointer's ``emergency_save`` at iteration 3, then
    stops with exit code 143."""
    [(rc, out)] = run_world(_PREEMPT_SAVE, 1, timeout=60,
                            args=[str(tmp_path)])
    assert rc == 143, out[-3000:]
    assert ("RANK0 preempted=True files=['snapshot_iter_3.0', "
            "'snapshot_iter_3.0.json']") in out, out[-3000:]
