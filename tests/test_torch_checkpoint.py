"""The port's ``MultiNodeCheckpointer`` against the JAX package's.

Every case of ``tests/extensions_tests/test_checkpoint.py``,
``test_checkpoint_gc.py`` and ``test_checkpoint_hardening.py`` that needs
neither orbax nor the chaos harness is one sequence of saves,
corruptions, GCs, elections and loads, run against both checkpointers
(the JAX one on the 8-device CPU mesh, one process; the port's in a
world of one): after every operation both must leave the same files on
disk and give the same result (elected or restored iteration, restored
values, the error raised, the warning given). Then the port's own: the
JAX checkpointer electing the port's files, the consensus election in a
2-rank gloo world where one rank lost its newest file, a restore onto
fewer ranks, the resumed run of ``tests/training_tests/test_resume.py``
(bitwise on the CPU, with an LR schedule and the double buffer in the
state), the trainer round trip, the in-place restore, the global except
hook in a subprocess, the error-feedback residuals of a quantized
reducer through a snapshot and back, and the parts that wait for later
slices.
Restored values are compared exactly: a snapshot is a copy.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import hashlib
import json
import os
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chainermn_tpu
from chainermn_torch.comm import create_communicator
from chainermn_torch.extensions import (MultiNodeCheckpointer,
                                        create_multi_node_checkpointer,
                                        install_global_except_hook)
from chainermn_torch.iterators import SerialIterator
from chainermn_torch.models import MLP
from chainermn_torch.optimizers import create_multi_node_optimizer
from chainermn_torch.training import (StandardUpdater, Trainer,
                                      make_data_parallel_train_step)
from tests.test_torch_mp import REPO, assert_ranks_ok, run_world


@pytest.fixture(scope="module")
def comm():
    c = create_communicator("pure_nccl", device="cpu")
    yield c
    c.finalize()


@pytest.fixture(scope="module")
def jcomm():
    return chainermn_tpu.create_communicator("xla")


# -- one sequence, both packages ------------------------------------------

class _Port:
    name = "port"

    def __init__(self, comm):
        self.comm = comm

    def ck(self, path, **kw):
        return create_multi_node_checkpointer("job", self.comm,
                                              path=path, **kw)

    @staticmethod
    def state(v):
        return {"params": {"w": torch.full((3, 2), float(v))},
                "step": torch.tensor(v)}


class _Jax(_Port):
    name = "jax"

    def ck(self, path, **kw):
        return chainermn_tpu.create_multi_node_checkpointer(
            "job", self.comm, path=path, **kw)

    @staticmethod
    def state(v):
        return {"params": {"w": jnp.full((3, 2), float(v))},
                "step": jnp.asarray(v)}


def _flip(fn, offset=0, n=64):
    """Damage a published file in place, leaving its manifest."""
    with open(fn, "rb+") as fh:
        fh.seek(offset)
        chunk = fh.read(n)
        fh.seek(offset)
        fh.write(bytes(b ^ 0xFF for b in chunk))


def _values(state):
    return (float(np.asarray(state["params"]["w"]).reshape(-1)[0]),
            int(np.asarray(state["step"])))


def _apply(pkg, ck, op):
    """One operation → its result (errors and warnings included)."""
    kind, *arg = op
    snap = lambda it: os.path.join(ck.path, f"snapshot_iter_{it}.0")
    if kind == "save":
        it, v = arg
        return os.path.basename(ck.save(pkg.state(v), it))
    if kind == "elect":
        return ck.latest_common_iteration()
    if kind == "load":
        state, it = ck.maybe_load(pkg.state(-1), *arg)
        return it, _values(state)
    if kind == "corrupt":
        _flip(snap(arg[0]), *arg[1:])
    elif kind == "truncate":
        with open(snap(arg[0]), "rb+") as fh:
            fh.truncate(os.path.getsize(snap(arg[0])) // 2)
    elif kind == "rm_manifest":
        os.remove(snap(arg[0]) + ".json")
    elif kind == "tear_manifest":
        with open(snap(arg[0]) + ".json", "w") as fh:
            fh.write('{"format": 1, "sha')
    elif kind == "verify":
        return ck._verify_snapshot_file(snap(arg[0]))
    elif kind == "protect":
        ck.protect(arg[0])
    elif kind == "gc":
        ck.cp_interval = arg[0]
        ck._gc()
    elif kind == "on_disk":
        return ck._iters_on_disk()
    elif kind == "rmtree":
        shutil.rmtree(ck.path)
    elif kind == "to_replica":
        # the primary is lost; a ring neighbour pushed a copy back
        os.makedirs(ck.replica_path, exist_ok=True)
        for ext in ("", ".json"):
            os.replace(snap(arg[0]) + ext, os.path.join(
                ck.replica_path, f"snapshot_iter_{arg[0]}.0{ext}"))
    elif kind in ("flush", "close"):
        getattr(ck, kind)()
    elif kind == "host":
        it, host = arg
        ck.save(pkg.state(it), it, host_state=host)
    elif kind == "load_host":
        return ck.load_host_state(arg[0])
    else:
        raise ValueError(kind)
    return None


def _trace(pkg, path, ops, **kw):
    ck = pkg.ck(str(path), **kw)
    out = []
    for op in ops:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                res = _apply(pkg, ck, op)
            except Exception as e:  # noqa: BLE001 — the error is the result
                res = ("raises", type(e).__name__,
                       "SHA-256" in str(e), "async checkpoint" in str(e))
        warned = any("async checkpoint write failed" in str(w.message)
                     for w in caught)
        # an async save's files are still being written: compare the
        # directory only where the sequence has waited for the writer
        files = (sorted(f for f in os.listdir(ck.path))
                 if os.path.isdir(ck.path) and not (
                     kw.get("async_write") and op[0] == "save") else None)
        out.append((op, res, warned, files))
    try:
        ck.close()
    except RuntimeError:
        pass
    return out


def _stress():
    ops = []
    for i in range(40):
        ops.append(("save", i, i))
        if i % 7 == 3:
            ops.append(("elect",))
    return ops + [("load",), ("on_disk",), ("close",), ("close",)]


SEQUENCES = {
    # tests/extensions_tests/test_checkpoint.py
    "save_load_roundtrip": ([("save", 100, 7), ("load",)], {}),
    "gc_window": ([("save", i * 10, i) for i in range(6)]
                  + [("on_disk",)], dict(cp_interval=3)),
    "resume_elects_latest": ([("save", 10, 1), ("save", 20, 2), ("load",)],
                             {}),
    "no_snapshot_returns_none": ([("load",), ("elect",)], {}),
    "explicit_iteration_load": ([("save", 10, 1), ("save", 20, 2),
                                 ("load", 10)], {}),
    "async_roundtrip": ([("save", 100, 7), ("load",), ("close",)],
                        dict(async_write=True)),
    "async_stress_interleaved": (_stress(),
                                 dict(cp_interval=3, async_write=True)),
    "async_write_error_surfaces": ([("save", 1, 1), ("flush",), ("rmtree",),
                                    ("save", 2, 2), ("flush",)],
                                   dict(async_write=True)),
    "async_write_error_does_not_break_election": (
        [("save", 1, 1), ("flush",), ("rmtree",), ("save", 2, 2),
         ("elect",)], dict(async_write=True)),
    # tests/extensions_tests/test_checkpoint_gc.py
    "gc_keeps_elected_winner_outside_window": (
        [("save", 10, 1), ("save", 20, 2), ("elect",), ("save", 30, 3),
         ("save", 40, 4), ("save", 50, 5), ("on_disk",)],
        dict(cp_interval=2)),
    "gc_elected_pin_is_replaced_not_accumulated": (
        [op for i in range(1, 7) for op in (("save", i * 10, i),
                                            ("elect",))] + [("on_disk",)],
        dict(cp_interval=2)),
    "gc_protect_pins_permanently": (
        [("save", 10, 1), ("protect", 10), ("save", 20, 2),
         ("save", 30, 3), ("on_disk",)], dict(cp_interval=1)),
    "gc_keeps_newest_valid_when_newer_is_corrupt": (
        [("save", 10, 1), ("save", 20, 2), ("corrupt", 20), ("gc", 1),
         ("on_disk",), ("load",)], dict(cp_interval=5)),
    "gc_still_prunes_normally": ([("save", i * 10, i) for i in range(6)]
                                 + [("on_disk",)], dict(cp_interval=3)),
    # tests/extensions_tests/test_checkpoint_hardening.py
    "corrupt_snapshot_excluded_from_election": (
        [("save", 10, 10), ("save", 20, 20), ("corrupt", 20, 30, 16),
         ("verify", 20), ("elect",), ("load",)], {}),
    "truncated_snapshot_fails_size_fast_path": (
        [("save", 10, 10), ("truncate", 10), ("verify", 10), ("elect",)],
        {}),
    "explicit_load_of_corrupt_snapshot_raises": (
        [("save", 10, 10), ("corrupt", 10, 0, 8), ("load", 10)], {}),
    "legacy_snapshot_without_manifest_still_elects": (
        [("save", 10, 10), ("rm_manifest", 10), ("verify", 10),
         ("elect",)], {}),
    "torn_manifest_marks_snapshot_suspect": (
        [("save", 10, 10), ("tear_manifest", 10), ("verify", 10),
         ("elect",)], {}),
    "gc_removes_manifest_with_snapshot": (
        [("save", it, it) for it in (10, 20, 30)], dict(cp_interval=2)),
    # the read side of the ring replicas (replicas/ under the path)
    "replica_stands_in_for_a_lost_primary": (
        [("save", 10, 1), ("save", 20, 2), ("to_replica", 20), ("elect",),
         ("load",), ("on_disk",), ("save", 30, 3), ("corrupt", 30),
         ("elect",)], {}),
    "host_state_rides_snapshot_and_sha": (
        [("host", 10, {"iteration": 10, "note": "host side"}),
         ("load_host", 10), ("save", 20, 20), ("load_host", 20)], {}),
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_same_files_and_elections_as_the_jax_checkpointer(case, tmp_path,
                                                          comm, jcomm):
    ops, kw = SEQUENCES[case]
    jax_trace = _trace(_Jax(jcomm), tmp_path / "jax", ops, **kw)
    port_trace = _trace(_Port(comm), tmp_path / "port", ops, **kw)
    for want, got in zip(jax_trace, port_trace):
        assert got == want, (case, got, want)
    assert len(port_trace) == len(ops)


def test_manifest_keys_and_published_sha(comm, tmp_path):
    """The manifest holds ``format`` 1, the file's byte count and
    SHA-256, and the coverage map (iteration, world, each leaf's shape);
    the tmp name is gone after the publish."""
    ck = create_multi_node_checkpointer("hard", comm, path=str(tmp_path))
    fn = ck.save(_Port.state(10), 10)
    manifest = json.load(open(fn + ".json"))
    assert manifest["format"] == 1
    assert manifest["bytes"] == os.path.getsize(fn)
    assert manifest["sha256"] == hashlib.sha256(
        open(fn, "rb").read()).hexdigest()
    assert manifest["iteration"] == 10 and manifest["world"] == 1
    assert manifest["leaves"] == {"0": {"gshape": [3, 2], "nshards": 0},
                                  "1": {"gshape": [], "nshards": 0}}
    assert not os.path.exists(fn + ".npz")
    with np.load(fn) as z:
        assert set(z.files) == {"leaf_0", "leaf_1", "__world__",
                                "__tree__"}
        assert int(z["__world__"]) == 1


# -- across the packages ----------------------------------------------------

def test_the_jax_checkpointer_elects_the_ports_snapshots(comm, jcomm,
                                                         tmp_path):
    """The port's files (with a corrupt newest one) are verified and
    elected by the JAX checkpointer exactly as by the port's; the JAX
    checkpointer even loads their plain leaves by position."""
    ck = create_multi_node_checkpointer("job", comm, path=str(tmp_path),
                                        cp_interval=5)
    for it in (10, 20, 30):
        ck.save(_Port.state(it), it)
    _flip(os.path.join(ck.path, "snapshot_iter_30.0"))
    jck = chainermn_tpu.create_multi_node_checkpointer(
        "job", jcomm, path=str(tmp_path), cp_interval=5)
    assert jck.latest_common_iteration() == ck.latest_common_iteration() \
        == 20
    assert jck._complete_iters_on_disk() == [10, 20]
    state, it = jck.maybe_load(_Jax.state(0))
    assert it == 20 and _values(state) == (20.0, 20)


# -- the resumed run (tests/training_tests/test_resume.py) -----------------

def _mlp_data(n=40):
    # per-sample targets make the loss sequence a fingerprint of the
    # exact batch order
    rs = np.random.RandomState(0)
    return [(rs.rand(28, 28).astype(np.float32), np.int32(i % 4))
            for i in range(n)]


def _mlp_updater(comm, seed=3, schedule=True, double_buffering=True):
    """An MLP trained with Nesterov SGD under a LambdaLR warm-up and the
    double-buffered multi-node optimizer, from ``torch.manual_seed(0)``;
    the iterator shuffles with ``seed``."""
    torch.manual_seed(0)
    model = MLP(n_units=8, n_out=4, device="cpu")
    sgd = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9,
                          nesterov=True)
    opt = create_multi_node_optimizer(sgd, comm,
                                      double_buffering=double_buffering)
    if schedule:
        opt.add_schedule(torch.optim.lr_scheduler.LambdaLR(
            sgd, lambda count: min(1.0, (count + 1) / 10)))
    step = make_data_parallel_train_step(model, opt, comm)
    it = SerialIterator(_mlp_data(), 8, shuffle=True, seed=seed)
    return StandardUpdater(it, step, comm, model=model, optimizer=opt)


def _run(trainer, losses):
    trainer.extend(lambda t: losses.append(
        float(t.updater.last_metrics["main/loss"])),
        trigger=(1, "iteration"))
    trainer.run()


@pytest.mark.parametrize("total,cut", [(15, 7), (12, 5)],
                         ids=["mid-epoch", "epoch-boundary"])
def test_resumed_run_matches_the_uninterrupted_losses(comm, tmp_path, total,
                                                      cut):
    """An uninterrupted run against one that snapshots at ``cut`` and a
    fresh updater (wrong shuffle seed) resumed from it: the losses after
    the cut are the same bit for bit, so are the final parameters, and
    the learning-rate schedule and the double buffer carried over."""
    ref = []
    ref_up = _mlp_updater(comm)
    _run(Trainer(ref_up, stop_trigger=(total, "iteration"),
                 handle_preemption=False), ref)
    ck = create_multi_node_checkpointer("resume", comm, path=str(tmp_path))
    first = []
    t1 = Trainer(_mlp_updater(comm), stop_trigger=(cut, "iteration"),
                 handle_preemption=False)
    t1.extend(ck, trigger=(cut, "iteration"))
    _run(t1, first)
    assert first == ref[:cut]

    u2 = _mlp_updater(comm, seed=999)
    ck2 = create_multi_node_checkpointer("resume", comm, path=str(tmp_path))
    assert ck2.resume(u2) == cut and u2.iteration == cut
    sched = u2.optimizer.schedules[0]
    assert sched.last_epoch == cut
    assert u2.optimizer._prev is not None
    second = []
    _run(Trainer(u2, stop_trigger=(total, "iteration"),
                 handle_preemption=False), second)
    assert second == ref[cut:]
    for k, v in ref_up.model.state_dict().items():
        assert torch.equal(u2.model.state_dict()[k], v), k


def _ef_updater(comm, seed=0):
    """The MLP(16) under Adam 1e-2 behind the int8 error-feedback
    reducer, on 256 synthetic MNIST samples scaled by 1e-2 (the regime of
    ``tests/collectives_tests/test_ef_checkpoint_resume.py``, where the
    int8 floor makes the residuals large), batch 32."""
    from chainermn_torch.collectives import QuantizedReducer
    from chainermn_torch.datasets import synthetic_mnist

    torch.manual_seed(0)
    model = MLP(n_units=16, device="cpu")
    opt = create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=1e-2, eps=1e-8), comm,
        grad_reducer=QuantizedReducer(comm, mode="int8", ef=True))
    ds = synthetic_mnist(256, seed=0)
    data = [(ds[i][0] * np.float32(1e-2), ds[i][1]) for i in range(256)]
    step = make_data_parallel_train_step(model, opt, comm)
    it = SerialIterator(data, 32, shuffle=True, seed=seed)
    return StandardUpdater(it, step, comm, model=model, optimizer=opt)


def _ef_resumed(comm, tmp_path, name):
    """The uninterrupted 8-step losses, and an updater (wrong shuffle
    seed) resumed from a snapshot at step 4 with the residuals it saved."""
    ref = []
    _run(Trainer(_ef_updater(comm), stop_trigger=(8, "iteration"),
                 handle_preemption=False), ref)
    ck = create_multi_node_checkpointer(name, comm, path=str(tmp_path))
    t1 = Trainer(_ef_updater(comm), stop_trigger=(4, "iteration"),
                 handle_preemption=False)
    t1.extend(ck, trigger=(4, "iteration"))
    first = []
    _run(t1, first)
    assert first == ref[:4]
    saved = [r.clone() for r in t1.updater.optimizer.reducer_state]
    assert sum(float(r.abs().sum()) for r in saved) > 0, \
        "no residual at the snapshot: the round trip would prove nothing"
    u2 = _ef_updater(comm, seed=999)
    ck2 = create_multi_node_checkpointer(name, comm, path=str(tmp_path))
    assert ck2.resume(u2) == 4
    return ref, saved, u2


def test_ef_residuals_round_trip_and_the_run_continues_bitwise(comm,
                                                                tmp_path):
    """``tests/collectives_tests/test_ef_checkpoint_resume.py`` on the
    port: the error-feedback residuals ride the optimizer's state into the
    snapshot and back (bitwise), and the resumed run's losses equal the
    uninterrupted run's bit for bit."""
    ref, saved, u2 = _ef_resumed(comm, tmp_path, "ef")
    for a, b in zip(saved, u2.optimizer.reducer_state):
        assert torch.equal(a, b)
    tail = []
    _run(Trainer(u2, stop_trigger=(8, "iteration"),
                 handle_preemption=False), tail)
    assert tail == ref[4:]


def test_zeroed_residuals_diverge(comm, tmp_path):
    """The negative control: the same resume with the residuals zeroed
    leaves the reference trajectory, so the equality above flows through
    the residuals."""
    ref, _, u2 = _ef_resumed(comm, tmp_path, "ef0")
    u2.optimizer.reducer_state = tuple(
        torch.zeros_like(r) for r in u2.optimizer.reducer_state)
    tail = []
    _run(Trainer(u2, stop_trigger=(8, "iteration"),
                 handle_preemption=False), tail)
    assert max(abs(a - b) for a, b in zip(tail, ref[4:])) > 1e-6, (
        tail, ref[4:])


def test_restore_loads_in_place_into_the_steps_objects(comm, tmp_path):
    """``resume`` loads into the model and optimizer the step closure
    holds: their parameter tensors stay the same objects and take the
    saved values, and the next step trains them."""
    up = _mlp_updater(comm)
    for _ in range(3):
        up.update()
    ck = create_multi_node_checkpointer("inplace", comm, path=str(tmp_path))
    ck.save(up.state, up.iteration)
    saved = {k: v.clone() for k, v in up.model.state_dict().items()}
    u2 = _mlp_updater(comm)
    params = [p for p in u2.model.parameters()]
    assert ck.resume(u2) == 3
    assert all(a is b for a, b in zip(u2.model.parameters(), params))
    for k, v in u2.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    before = params[0].detach().clone()
    u2.update()
    assert not torch.equal(params[0], before)


def test_resume_without_host_state_fast_forwards_the_epoch(comm, tmp_path):
    """A snapshot without host state (a JAX-era or hand-made save): the
    iteration and the iterator's epoch counter are restored, the position
    restarts (the reference's restart semantics)."""
    u1 = _mlp_updater(comm)
    for _ in range(10):
        u1.update()
    ck = create_multi_node_checkpointer("legacy", comm, path=str(tmp_path))
    ck.save(u1.state, u1.iteration)
    u2 = _mlp_updater(comm)
    assert ck.resume(u2) == 10
    assert u2.iteration == 10 and u2.iterator.epoch == 2


def test_emergency_save_publishes_synchronously(comm, tmp_path):
    """``emergency_save`` skips the async queue and publishes a verified
    file with the host state before it returns; an expired deadline
    writes nothing."""
    import time

    ck = create_multi_node_checkpointer("hard", comm, path=str(tmp_path),
                                        async_write=True)

    class FakeTrainer:
        updater = _mlp_updater(comm)

    fn = ck.emergency_save(FakeTrainer())
    assert os.path.exists(fn) and os.path.exists(fn + ".json")
    assert ck._verify_snapshot_file(fn)
    assert ck.load_host_state(0)["iteration"] == 0
    ck.close()
    fn7 = os.path.join(ck.path, "snapshot_iter_7.0")
    FakeTrainer.updater.iteration = 7
    assert ck.emergency_save(FakeTrainer(),
                             deadline_s=time.monotonic() - 1) is None
    assert not os.path.exists(fn7)


def test_later_slices_raise(comm, tmp_path):
    """The orbax backend (JAX's library, not ported: ROADMAP.md queue 3)
    raises."""
    with pytest.raises(NotImplementedError, match="queue 3"):
        create_multi_node_checkpointer("o", comm, path=str(tmp_path),
                                       backend="orbax")


@pytest.mark.parametrize("spec", [
    "corrupt@match=snapshot_iter_2", "truncate@match=snapshot_iter_2,keep=9",
    "enospc@match=snapshot_iter_2"])
def test_chaos_hooks_damage_or_refuse_a_publish(comm, tmp_path, monkeypatch,
                                                spec):
    """The checkpointer's chaos points (``$CHAINERMN_TPU_CHAOS``):
    ``corrupt`` and ``truncate`` damage the published file after its
    manifest (verification catches it and the election falls back),
    ``enospc`` refuses the publish with nothing written."""
    ck = create_multi_node_checkpointer("c", comm, path=str(tmp_path))
    ck.save(_Port.state(1), 1)
    monkeypatch.setenv("CHAINERMN_TPU_CHAOS", spec)
    fn = os.path.join(ck.path, "snapshot_iter_2.0")
    if spec.startswith("enospc"):
        with pytest.raises(OSError, match="No space left"):
            ck.save(_Port.state(2), 2)
        assert not os.path.exists(fn)
    else:
        ck.save(_Port.state(2), 2)
        assert os.path.exists(fn) and not ck._verify_snapshot_file(fn)
    assert ck.latest_common_iteration() == 1


# -- several ranks ------------------------------------------------------------

_ELECTION_WORKER = r'''
import os, sys
import numpy as np
import torch
from chainermn_torch.comm import create_communicator
from chainermn_torch.extensions import create_multi_node_checkpointer

rank = int(os.environ["RANK"])
path, phase = sys.argv[1], sys.argv[2]
comm = create_communicator("pure_nccl", device="cpu")
state = lambda v: {"w": torch.full((4,), float(v) + rank), "n": v}
ck = create_multi_node_checkpointer("job", comm, path=path)
if phase == "save":
    for it in (10, 20, 30):
        ck.save(state(it), it)
    comm.barrier()
    if rank == 1:   # rank 1 lost its newest file
        os.remove(os.path.join(ck.path, "snapshot_iter_30.1"))
    comm.barrier()
    assert ck.latest_common_iteration() == 20
    got, it = ck.maybe_load(state(0))
    assert it == 20 and got["n"] == 20
    assert torch.equal(got["w"], torch.full((4,), 20.0 + rank))
else:   # one rank restores from the two-rank snapshot set
    assert comm.size == 1
    assert ck._complete_iters_on_disk() == [10, 20]
    # its own valid files vote, as in the JAX election: 30 is rank 0's
    assert ck.latest_common_iteration() == 30
    got, it = ck.maybe_load(state(0), iteration=20)
    assert it == 20 and torch.equal(got["w"], torch.full((4,), 20.0))
comm.finalize()
print(f"RANK{rank} OK", flush=True)
'''


def test_two_rank_election_skips_an_iteration_a_rank_lost(tmp_path):
    """A 2-rank gloo world saves 10, 20 and 30; rank 1 loses its file of
    30: the allgather election agrees on 20 and each rank loads its own
    file. Then a world of one restores from that 2-rank set: its
    ``__world__`` says 2, so 30 is incomplete and 20 complete, while the
    one rank's own valid file of 30 still votes, as in the JAX
    election."""
    assert_ranks_ok(run_world(_ELECTION_WORKER, 2, timeout=120,
                              args=[str(tmp_path), "save"]))
    assert_ranks_ok(run_world(_ELECTION_WORKER, 1, timeout=120,
                              args=[str(tmp_path), "restore"]))


def test_a_new_rank_restores_from_its_peers_files(comm, tmp_path):
    """A rank with no file of its own (a world larger than the saving
    one) loads every leaf from the complete set its peers wrote; an
    incomplete set is refused."""
    ck = create_multi_node_checkpointer("grow", comm, path=str(tmp_path))
    ck.save(_Port.state(5), 5)
    os.rename(os.path.join(ck.path, "snapshot_iter_5.0"),
              os.path.join(ck.path, "snapshot_iter_5.1"))
    os.rename(os.path.join(ck.path, "snapshot_iter_5.0.json"),
              os.path.join(ck.path, "snapshot_iter_5.1.json"))
    # the file of rank 1 of a world of 1 does not complete the set
    with pytest.raises(FileNotFoundError, match="complete"):
        ck.maybe_load(_Port.state(0), iteration=5)
    state, it = ck.maybe_load(_Port.state(0), iteration=5,
                              allow_incomplete=True)
    assert it == 5 and _values(state) == (5.0, 5)


def test_global_except_hook_exits_13():
    """An uncaught exception under ``install_global_except_hook`` prints
    the traceback and hard-exits with 13."""
    code = ("from chainermn_torch.extensions import "
            "install_global_except_hook\n"
            "install_global_except_hook()\n"
            "raise RuntimeError('boom')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 13
    assert "aborting job" in proc.stderr and "boom" in proc.stderr
    prev = install_global_except_hook()
    try:
        assert sys.excepthook is not prev
    finally:
        sys.excepthook = prev
    assert isinstance(MultiNodeCheckpointer, type)
