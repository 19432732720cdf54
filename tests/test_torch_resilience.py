"""The port's ``resilience/`` against the JAX package's.

Where both compute the same thing, the same inputs go through both:
chaos specs parse into the same faults with the same ``describe()``
strings and seeded schedules, the RPC policy gives the same ladders, exits
classify and budgets spend alike, supervisors record the same histories,
``reserve_grace`` splits a window alike, and ``plan_elastic_resume``
plans the same way on the same file sets.

Then the port's own behaviour, as the JAX package's multi-process chaos
and elastic tests check it (``tests/extensions_tests/
test_multiprocess_chaos.py`` and ``test_multiprocess_elastic.py``), in
gloo worlds of two ranks through ``run_world``: a killed rank and the
consensus resume, a corrupt newest snapshot, SIGTERM's emergency
checkpoint, the watchdog bounding a survivor blocked in an array
all-reduce, a supervised kill and restart, shrink-to-fit onto one rank,
and ring replicas electing the newest iteration. The training job is
host-only, as JAX's is: identically seeded iterators make the loss
sequences exactly comparable.

Tolerances: none; every comparison is exact (the losses are sums of
small integers in f32).
"""

import os
import signal
import time

import numpy as np
import pytest
import torch

from chainermn_tpu.resilience import chaos as jchaos
from chainermn_tpu.resilience import elastic as jelastic
from chainermn_tpu.resilience import preemption as jpreemption
from chainermn_tpu.resilience import supervisor as jsupervisor
from chainermn_tpu.resilience.policy import RpcPolicy as JaxRpcPolicy
from chainermn_torch.comm.object_plane import JobAbortedError
from chainermn_torch.extensions import create_multi_node_checkpointer
from chainermn_torch.resilience import (ABORTED_EXIT_CODE,
                                        BUDGET_EXHAUSTED_EXIT_CODE,
                                        PREEMPTED_EXIT_CODE, RestartBudget,
                                        RpcPolicy, Supervisor, Watchdog,
                                        chaos, classify_exit, main_exit_code,
                                        plan_elastic_resume)
from chainermn_torch.resilience import preemption
from tests.test_torch_mp import run_world

# -- chaos specs --------------------------------------------------------------

# every spec of tests/resilience_tests/test_chaos_spec.py, and one clause of
# each fault kind
SPECS = [
    "kill@step=3,rank=1,signal=SIGTERM",
    "kill@step=2,rank=*;delay_rpc@ms=5,op=kv_get,prob=0.5,seed=7",
    ";;",
    "kill@step=3,rank=1",
    "kill@step=2,signal=SIGTERM",
    "delay_rpc@ms=250,op=kv_get",
    "blackhole_rpc@op=kv_get,after=2",
    "delay_rpc@ms=1,prob=0.5,seed=11",
    "corrupt@match=snapshot_iter_6",
    "corrupt@match=snapshot_iter_6,offset=10",
    "truncate@match=snapshot_iter_6.1",
    "slow_offload@ms=100,match=snapshot_iter_3",
    "stall_writer@ms=1,match=snap",
    "stall_writer@ms=250,match=snapshot_iter",
    "enospc@match=snapshot_iter_9,after=1,prob=0.5,seed=3",
    "slow_disk@ms=20,match=snapshot,rank=0",
    "kill_replica@step=4,replica=1",
    "corrupt_handoff@offset=8,times=2;drop_handoff@times=1,after=1",
    "delay_handoff@ms=5;dup_handoff@prob=0.25,seed=2;kill_dest@times=1",
    "reset_conn@times=1;partial_write@after=2;stall_accept@ms=10",
    "corrupt_rollout_chunk@keep=16,run=1;kill_mid_swap@replica=*",
    "canary_mismatch@times=1,run=0",
]

MALFORMED = ["explode@step=1", "kill@rank=1", "corrupt@rank=0", "truncate@",
             "delay_rpc@op=kv_get", "delay_rpc@ms=5,prob=1.5", "kill@step",
             "kill@step=1,bogus=2", "corrupt_handoff@times=0"]


def _fields(f):
    return {k: v for k, v in vars(f).items() if not k.startswith("_")}


def test_every_fault_kind_is_jaxs():
    assert chaos.FAULT_KINDS == jchaos.FAULT_KINDS
    assert chaos.ENV_VAR == jchaos.ENV_VAR == "CHAINERMN_TPU_CHAOS"


@pytest.mark.parametrize("spec", SPECS)
def test_specs_parse_to_jaxs_faults(spec):
    port, jax = chaos.parse_spec(spec), jchaos.parse_spec(spec)
    assert [_fields(f) for f in port] == [_fields(f) for f in jax]
    assert [f.describe() for f in port] == [f.describe() for f in jax]


@pytest.mark.parametrize("spec", MALFORMED)
def test_malformed_specs_raise_as_in_jax(spec):
    with pytest.raises(ValueError) as port:
        chaos.parse_spec(spec)
    with pytest.raises(ValueError) as jax:
        jchaos.parse_spec(spec)
    assert str(port.value) == str(jax.value)


def test_seeded_schedules_replay_jaxs():
    """The seeded probabilistic faults draw the same schedule: delays,
    wire verdicts and the publish faults, call by call."""
    spec = ("delay_rpc@ms=1,prob=0.5,seed=11;dup_handoff@prob=0.3,seed=5;"
            "slow_disk@ms=2,match=snap,prob=0.5,seed=9")

    def run(mod):
        slept = []
        plan = mod.ChaosPlan(mod.parse_spec(spec), sleep_fn=slept.append)
        wire = []
        for i in range(48):
            plan.on_rpc("kv_get", rank=0)
            wire.append(plan.on_wire(b"x", rank=0)[0])
            plan.on_publish(f"snapshot_iter_{i}.0", rank=0)
        return slept, wire, plan.log

    assert run(chaos) == run(jchaos)
    slept, wire, _ = run(chaos)
    assert 0 < len(slept) < 96 and 0 < wire.count("dup") < 48


@pytest.mark.parametrize("spec", [
    "corrupt@match=snapshot_iter_6", "corrupt@match=snapshot_iter_6,offset=10",
    "truncate@match=snapshot_iter_6", "truncate@match=snapshot_iter_6,keep=7"])
def test_the_checkpoint_hook_damages_a_file_as_jaxs_does(spec, tmp_path):
    data = bytes(range(256)) * 4
    out = []
    for mod in (chaos, jchaos):
        fn = tmp_path / f"{mod.__name__}" / "snapshot_iter_6.0"
        fn.parent.mkdir()
        fn.write_bytes(data)
        mod.ChaosPlan(mod.parse_spec(spec)).on_checkpoint(str(fn), rank=0)
        out.append(fn.read_bytes())
    assert out[0] == out[1] != data


def test_kill_fires_at_its_step_on_its_rank_and_run():
    killed = []
    plan = chaos.ChaosPlan(chaos.parse_spec(
        "kill@step=3,rank=1,signal=SIGTERM;kill@step=4,run=1"),
        kill_fn=killed.append)
    for it in range(6):
        plan.on_step(it, rank=1)
        plan.on_step(it, rank=0)
    assert killed == [int(signal.SIGTERM)]     # run 0: the second skips


def test_replica_and_fleet_hooks_answer_as_jaxs():
    """The hooks whose callers (the fleet's router, transport, rollout)
    come with later items give JAX's answers call by call."""
    spec = ("kill_replica@step=2,replica=1;kill_dest@times=1,after=1;"
            "kill_mid_swap@replica=0,times=1;canary_mismatch@times=1;"
            "reset_conn@times=1;stall_accept@ms=3,times=1")

    def run(mod):
        plan = mod.ChaosPlan(mod.parse_spec(spec), sleep_fn=lambda s: None)
        return ([plan.on_replica_step(r, it, rank=0) for it in range(4)
                 for r in range(2)],
                [plan.on_migration(i, rank=0) for i in range(3)],
                [plan.on_swap(r, rank=0) for r in (1, 0, 0)],
                [plan.on_canary(rank=0) for _ in range(2)],
                [plan.on_socket(op, rank=0) for op in ("send", "send",
                                                       "accept")],
                plan.on_handoff(b"abc", rank=0), plan.log)

    assert run(chaos) == run(jchaos)


@pytest.mark.parametrize("env,rank", [
    ({"CHAINERMN_TPU_CHAOS_RANK": "2", "RANK": "5"}, 2),
    ({"RANK": "5"}, 5), ({}, None)])
def test_own_rank_reads_chaos_rank_then_rank(monkeypatch, env, rank):
    for var in ("CHAINERMN_TPU_CHAOS_RANK", "RANK"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    import torch.distributed as dist

    if rank is None and dist.is_initialized():
        rank = dist.get_rank()          # a group this process still holds
    assert chaos._own_rank() == rank


def test_chaos_cli_validates_and_lists(capsys):
    from chainermn_torch.tools import chaos as cli

    assert cli.main(["--dry-run", "--spec", "kill@step=3,rank=1"]) == 0
    assert "kill@rank=1 step=3 signal=SIGKILL" in capsys.readouterr().out
    assert cli.main(["--spec", "explode@step=1"]) == 2
    assert cli.main(["--list-faults"]) == 0
    assert "stall_writer" in capsys.readouterr().out


# -- policy, exits, budgets, supervisors, the grace window ------------------

def test_rpc_policy_is_jaxs():
    for kw in ({}, {"timeout_ms": 2000, "probe_ms": 500, "seed": 7},
               {"probe_ms": 3, "backoff_base_ms": 50, "seed": 1}):
        port, jax = RpcPolicy(**kw), JaxRpcPolicy(**kw)
        assert port == RpcPolicy(**kw)
        assert list(port.backoffs_ms(12)) == list(jax.backoffs_ms(12)) \
            or "seed" not in kw
        assert port.liveness_ladder_ms() == jax.liveness_ladder_ms()
        assert port.barrier_ms() == jax.barrier_ms()
        assert port.handoff_ack_ms() == jax.handoff_ack_ms()
        assert port.put_budget_ms(7) == jax.put_budget_ms(7)


def test_rpc_policy_reads_jaxs_variables(monkeypatch):
    monkeypatch.setenv("CHAINERMN_TPU_RPC_TIMEOUT_MS", "1234")
    monkeypatch.setenv("CHAINERMN_TPU_RPC_PROBE_MS", "56")
    assert RpcPolicy.from_env() == RpcPolicy(timeout_ms=1234, probe_ms=56)
    monkeypatch.setenv("CHAINERMN_TPU_RPC_PROBE_MS", "-1")
    with pytest.raises(ValueError):
        RpcPolicy.from_env()


def test_exits_classify_as_in_jax():
    codes = [0, 1, 2, 13, 75, 112, 143, -signal.SIGKILL, -signal.SIGTERM,
             -signal.SIGUSR1, -signal.SIGSEGV]
    assert [classify_exit(c) for c in codes] == [
        jsupervisor.classify_exit(c) for c in codes]
    assert (ABORTED_EXIT_CODE, BUDGET_EXHAUSTED_EXIT_CODE,
            PREEMPTED_EXIT_CODE) == (jsupervisor.ABORTED_EXIT_CODE,
                                     jsupervisor.BUDGET_EXHAUSTED_EXIT_CODE,
                                     jsupervisor.PREEMPTED_EXIT_CODE)


def test_restart_budgets_spend_as_in_jax():
    times = [0.0, 1.0, 2.0, 3.0, 50.0, 61.5, 62.0, 200.0, 200.1, 200.2]
    port, jax = RestartBudget(3, 60.0), jsupervisor.RestartBudget(3, 60.0)
    assert [(port.try_spend(t), port.remaining(t)) for t in times] == [
        (jax.try_spend(t), jax.remaining(t)) for t in times]
    for mod in (RestartBudget, jsupervisor.RestartBudget):
        with pytest.raises(ValueError):
            mod(-1)


class _Proc:
    def __init__(self, rc):
        self.rc = rc

    def wait(self):
        return self.rc


@pytest.mark.parametrize("rcs,want", [
    ([-9, 143, 75, 0], 0),            # crash, preemption, abort, clean
    ([1, 1, 1, 1], BUDGET_EXHAUSTED_EXIT_CODE),
    ([143], PREEMPTED_EXIT_CODE)])
def test_supervisors_record_jaxs_histories(rcs, want):
    """The same child exits give the same decisions, histories and
    incarnation counters (the child's ``$CHAINERMN_TPU_RESTART_COUNT``)."""
    def run(cls):
        it, envs = iter(rcs), []

        def spawn(cmd, env):
            envs.append(env["CHAINERMN_TPU_RESTART_COUNT"])
            return _Proc(next(it))

        sup = cls(["train"], max_restarts=2, window_s=60.0, sleep=lambda s:
                  None, spawn=spawn, restart_on_preempt=len(rcs) > 1)
        code = sup.run()
        return code, [(r.incarnation, r.returncode, r.kind)
                      for r in sup.history], envs

    port = run(Supervisor)
    assert port == run(jsupervisor.Supervisor)
    assert port[0] == want


def test_supervise_cli_runs_a_command_to_its_end():
    import sys

    from chainermn_torch.tools import supervise

    assert supervise.main(["--", sys.executable, "-c", "pass"]) == 0
    assert supervise.main([]) == 2


def test_main_exit_code_maps_an_abort_to_75():
    def aborted():
        raise JobAbortedError("peer 1 died")

    assert main_exit_code(aborted) == ABORTED_EXIT_CODE
    with pytest.raises(KeyError):
        main_exit_code(lambda: {}["x"])


def test_reserve_grace_splits_a_window_as_jaxs(monkeypatch):
    now = time.monotonic()
    for dl, frac, floor in ((now + 10, 0.5, 0.0), (now + 10, 0.25, 4.0),
                            (now - 1, 0.5, 0.0), (None, 0.5, 0.0)):
        a = preemption.reserve_grace(dl, frac, floor)
        b = jpreemption.reserve_grace(dl, frac, floor)
        assert (a is None and b is None) or abs(a - b) < 1e-3
    for raw in ("", "7.5", "-2", "x"):
        monkeypatch.setenv("CHAINERMN_TPU_PREEMPTION_GRACE_S", raw)
        assert preemption.grace_seconds() == jpreemption.grace_seconds()


# -- elastic plans on the same file sets -------------------------------------

class _Comm:
    """A stand-in for the ranks that wrote a file set, or for the world
    that plans on it (objects only, no collective)."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size
        self.inter_rank, self.inter_size = rank, size

    def barrier(self):
        pass

    def allgather_obj(self, obj):
        return [obj]


def _write_set(path, saved_world, iters, lost=(), sharded=False):
    """Every rank of ``saved_world`` saves ``iters``; files of the ranks
    in ``lost`` are deleted afterwards (a host gone with its disk)."""
    for r in range(saved_world):
        ck = create_multi_node_checkpointer("job", _Comm(r, saved_world),
                                            path=path, cp_interval=10)
        for it in iters:
            leaf = torch.full((2,), float(it))
            if sharded:
                from chainermn_torch.extensions import ShardedLeaf

                leaf = ShardedLeaf(leaf, (2 * saved_world,),
                                   [(2 * r, 2 * r + 2)])
            ck.save({"w": leaf, "step": torch.tensor(it)}, it)
    job = os.path.join(path, "job")
    for f in os.listdir(job):
        if any(f.startswith(f"snapshot_iter_") and f.split(".")[1] == str(r)
               for r in lost):
            os.remove(os.path.join(job, f))


@pytest.mark.parametrize("saved,iters,lost,sharded,action,it", [
    (2, (3, 6), (1,), False, "shrink", 6),
    (1, (3, 6), (), False, "resume", 6),
    (2, (3, 6), (), True, "shrink", 6),
    (4, (2, 4), (3,), False, "shrink", 4),
    (2, (), (), False, "give_up", None)])
def test_elastic_plans_are_jaxs(jcomm, tmp_path, saved, iters, lost, sharded,
                                action, it):
    """On one world, over the same files: the same action, iteration,
    saved world and averaging rescale."""
    import chainermn_tpu

    _write_set(str(tmp_path), saved, iters, lost, sharded)
    port = plan_elastic_resume(create_multi_node_checkpointer(
        "job", _Comm(0, 1), path=str(tmp_path), cp_interval=10))
    jax = jelastic.plan_elastic_resume(
        chainermn_tpu.create_multi_node_checkpointer(
            "job", jcomm, path=str(tmp_path), cp_interval=10))
    keys = ("action", "iteration", "saved_world", "new_world",
            "averaging_rescale")
    assert ({k: getattr(port, k) for k in keys}
            == {k: getattr(jax, k) for k in keys})
    assert (port.action, port.iteration) == (action, it)


def test_elastic_plan_skips_an_incomplete_sharded_iteration(jcomm, tmp_path):
    """A fault of the reference's plan: the survivors of a killed rank
    wrote a sharded snapshot the dead rank never wrote (their emergency
    save); JAX's inventory elects it, and its load fails. The port's
    elects the newest iteration it can restore."""
    import chainermn_tpu

    _write_set(str(tmp_path), 2, (3, 6), sharded=True)
    ck1 = create_multi_node_checkpointer("job", _Comm(0, 2),
                                         path=str(tmp_path), cp_interval=10)
    from chainermn_torch.extensions import ShardedLeaf

    ck1.save({"w": ShardedLeaf(torch.zeros(2), (4,), [(0, 2)]),
              "step": torch.tensor(7)}, 7)
    port = plan_elastic_resume(create_multi_node_checkpointer(
        "job", _Comm(0, 1), path=str(tmp_path), cp_interval=10))
    jax = jelastic.plan_elastic_resume(
        chainermn_tpu.create_multi_node_checkpointer(
            "job", jcomm, path=str(tmp_path), cp_interval=10))
    assert (jax.action, jax.iteration) == ("shrink", 7)
    assert (port.action, port.iteration) == ("shrink", 6)


@pytest.fixture(scope="module")
def jcomm():
    import chainermn_tpu

    return chainermn_tpu.create_communicator("xla")


# -- the watchdog on a fake store --------------------------------------------

class _FakeStore:
    def __init__(self):
        self.kv, self.broken = {}, False

    def _ok(self):
        if self.broken:
            raise RuntimeError("connection closed")

    def set(self, k, v):
        self._ok()
        self.kv[k] = v.encode() if isinstance(v, str) else bytes(v)

    def get(self, k):
        self._ok()
        return self.kv[k]

    def check(self, keys):
        self._ok()
        return all(k in self.kv for k in keys)

    def wait(self, keys, timeout=None):
        self._ok()
        if not self.check(keys):
            raise RuntimeError("wait timeout")


def test_watchdog_declares_a_stalled_peer_and_bounds_the_step_loop():
    """A peer whose beat stops is declared dead after the timeout: the
    abort key is posted, ``on_dead`` runs once, ``check`` raises, and a
    step loop that never acknowledges is ended with exit 75 after the
    grace."""
    store, dead, exits = _FakeStore(), [], []
    wd = Watchdog(0, 2, store=store, interval_ms=20, timeout_ms=150,
                  on_dead=lambda p, why: dead.append(p), exit_grace_ms=100,
                  exit_fn=exits.append)
    store.set("og/hb/1", "1")
    wd.start()
    wd.check()                          # peer alive for now
    t0 = time.monotonic()
    assert wd.confirm(2000)
    took = time.monotonic() - t0
    assert 0.1 < took < 1.5 and dead == [1]
    assert b"peer 1" in store.kv["og/abort/flag"]
    deadline = time.monotonic() + 2
    while not exits and time.monotonic() < deadline:
        time.sleep(0.01)
    assert exits == [ABORTED_EXIT_CODE]
    with pytest.raises(JobAbortedError, match="peer 1"):
        wd.check()
    wd.stop()


def test_watchdog_confirms_a_peers_abort_key_and_a_lost_store():
    store = _FakeStore()
    wd = Watchdog(1, 2, store=store, interval_ms=20, timeout_ms=5000)
    assert not wd.confirm(60)
    store.set("og/abort/flag", "rank 0 crashed")
    assert wd.confirm(60) and "rank 0 crashed" in wd.dead_reason
    store2 = _FakeStore()
    wd2 = Watchdog(1, 2, store=store2, interval_ms=20, timeout_ms=100)
    store2.set("og/hb/0", "1")
    wd2.start()
    time.sleep(0.05)
    store2.broken = True
    assert wd2.confirm(2000) and wd2.dead_peer == 0
    assert "unreachable" in wd2.dead_reason
    wd2.stop()


def test_start_watchdog_needs_a_peer(monkeypatch):
    from chainermn_torch.resilience import watchdog

    monkeypatch.setenv("CHAINERMN_TPU_WATCHDOG", "1")
    assert watchdog.maybe_start_watchdog() is None   # no world at all
    monkeypatch.setenv("CHAINERMN_TPU_WATCHDOG", "0")
    assert watchdog.maybe_start_watchdog() is None


# -- multi-process behaviour (gloo worlds) ------------------------------------

_WORKER = r'''
import os, sys, time
import numpy as np
import torch
from chainermn_torch import create_communicator
from chainermn_torch.extensions import create_multi_node_checkpointer
from chainermn_torch.iterators import SerialIterator
from chainermn_torch.resilience import (PeerReplicator, Supervisor,
                                        main_exit_code)
from chainermn_torch.training import StandardUpdater, Trainer

mode = sys.argv[1]
if mode == "supervise":
    # the per-host parent: wraps THIS script in inner mode
    sup = Supervisor([sys.executable, sys.argv[0], "inner"],
                     max_restarts=3, window_s=120.0)
    sys.exit(sup.run())
if mode == "inner":
    # each incarnation's world has a store of its own
    inc = int(os.environ.get("CHAINERMN_TPU_RESTART_COUNT", "0"))
    os.environ["MASTER_PORT"] = str(int(os.environ["MASTER_PORT"]) + inc)
TOTAL = 12
comm = create_communicator("naive", device="cpu")
rank = comm.rank


def dataset():
    return [(np.full((2,), float(i), np.float32), np.asarray(i, np.int32))
            for i in range(40)]


class Acc(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("s", torch.zeros(()))


class NoOpt:
    def state_dict(self):
        return {}

    def load_state_dict(self, state):
        del state


def make_updater(collective=False):
    acc = Acc()

    def step(x, y):
        if collective:
            # an array all-reduce over gloo: a dead peer blocks it
            x = comm.allreduce(x, "sum") / comm.size
        acc.s += x.float().mean()
        return {"loss": acc.s.clone()}

    it = SerialIterator(dataset(), 8, shuffle=True, seed=3)
    return StandardUpdater(it, step, comm, model=acc, optimizer=NoOpt())


def make_ck():
    return create_multi_node_checkpointer(
        "chaos", comm, path=os.environ["CKPT_DIR"], cp_interval=5)


exp, s, _it = [], np.float32(0.0), SerialIterator(dataset(), 8, shuffle=True,
                                                  seed=3)
for _ in range(TOTAL):
    s = s + np.float32(np.stack([b[0] for b in next(_it)]).mean())
    exp.append(float(s))


def run(trainer):
    losses = []
    trainer.extend(lambda t: losses.append(
        float(t.updater.last_metrics["loss"])), trigger=(1, "iteration"))
    trainer.run()
    return losses


if mode == "kill":
    # rank 1 is SIGKILLed at step 7 (chaos); rank 0 finishes alone
    u = make_updater()
    t = Trainer(u, stop_trigger=(TOTAL, "iteration"))
    t.extend(make_ck(), trigger=(3, "iteration"))
    losses = run(t)
    assert rank == 0 and losses == exp, losses
    print(f"RANK{rank} OK", flush=True)
    os._exit(0)    # the peer is dead: skip the group's teardown
elif mode == "resume":
    ck, u = make_ck(), make_updater()
    elected = ck.resume(u)
    assert elected == 6 and u.iteration == 6, elected
    assert float(u.model.s) == exp[5], float(u.model.s)
    losses = run(Trainer(u, stop_trigger=(TOTAL, "iteration")))
    assert losses == exp[6:], (losses, exp[6:])
elif mode == "corrupt":
    ck, u = make_ck(), make_updater()
    t = Trainer(u, stop_trigger=(6, "iteration"))
    t.extend(ck, trigger=(3, "iteration"))
    t.run()
    assert ck.latest_common_iteration() == 3
    state, it = ck.maybe_load(u.state)
    assert it == 3 and float(state["model"]["s"]) == exp[2]
elif mode == "sigterm":
    ck, u = make_ck(), make_updater()
    t = Trainer(u, stop_trigger=(TOTAL, "iteration"))
    t.extend(ck, trigger=(3, "iteration"))
    code = main_exit_code(lambda: (t.run(), t)[1])
    assert code == 143 and t.preempted and u.iteration == 5, code
    fn = os.path.join(ck.path, f"snapshot_iter_5.{rank}")
    assert ck._verify_snapshot_file(fn), fn
elif mode in ("watchdog-killed", "watchdog-wedged"):
    from chainermn_torch.comm import object_plane
    from chainermn_torch.resilience import watchdog
    u = make_updater(collective=True)
    if mode == "watchdog-wedged" and rank == 1:
        step = u.step_fn

        def wedged(*arrays):
            if u.iteration == 3:
                # alive but silent: no heartbeat, no collective, until
                # the survivor (the store's host) is gone
                watchdog.current_watchdog().stop()
                t0 = time.monotonic()
                while True:
                    try:
                        object_plane._client().check(["og/abort/flag"])
                    except Exception:
                        break
                    time.sleep(0.05)
                print(f"RANK1 saw rank 0 exit {time.monotonic() - t0:.2f} s "
                      "after it went silent", flush=True)
                os._exit(ABORTED)
            return step(*arrays)

        u.step_fn = wedged
    ABORTED = 75
    marks = []
    t = Trainer(u, stop_trigger=(TOTAL, "iteration"))
    t.extend(lambda tr: marks.append(time.monotonic()),
             trigger=(1, "iteration"))
    code = main_exit_code(lambda: (t.run(), t)[1])
    took = time.monotonic() - marks[-1]
    print(f"RANK{rank} exit {code} {took:.2f} s after its last step",
          flush=True)
    os._exit(code)
elif mode in ("supervise", "inner"):
    ck, u = make_ck(), make_updater()
    if inc > 0:
        elected = ck.resume(u)
        assert elected == 6 and float(u.model.s) == exp[5], elected
    t = Trainer(u, stop_trigger=(TOTAL, "iteration"))
    t.extend(ck, trigger=(3, "iteration"))
    code = main_exit_code(lambda: (t.run(), t)[1])
    comm.allgather_obj(("done", rank))
    print(f"RANK{rank} OK incarnation {inc}", flush=True)
    sys.stdout.flush()
    os._exit(code)
elif mode == "replicate":
    ck, u = make_ck(), make_updater()
    t = Trainer(u, stop_trigger=(TOTAL, "iteration"))
    t.extend(ck, trigger=(3, "iteration"))
    t.extend(PeerReplicator(ck), trigger=(3, "iteration"))  # after the save
    t.run()
elif mode == "replica-resume":
    ck, u = make_ck(), make_updater()
    elected = ck.resume(u)
    assert elected == TOTAL and float(u.model.s) == exp[-1], elected
elif mode == "snapshots":
    t = Trainer(make_updater(), stop_trigger=(TOTAL, "iteration"))
    t.extend(make_ck(), trigger=(3, "iteration"))
    t.run()
comm.host_barrier()
print(f"RANK{rank} OK", flush=True)
os._exit(0)
'''


def _world(mode, tmp_path, timeout=40, **env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env, CKPT_DIR=str(tmp_path / "snaps"))
    try:
        return run_world(_WORKER, 2, timeout, args=[mode])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _ok(results):
    for rank, (rc, out) in enumerate(results):
        assert rc == 0 and f"RANK{rank} OK" in out, (
            f"rank {rank} exited {rc}:\n{out[-3000:]}")


def test_kill_one_rank_then_resume_matches_uninterrupted(tmp_path):
    (rc0, out0), (rc1, out1) = _world(
        "kill", tmp_path, CHAINERMN_TPU_CHAOS="kill@step=7,rank=1")
    assert rc0 == 0 and "RANK0 OK" in out0, out0[-3000:]
    assert rc1 == -signal.SIGKILL, (rc1, out1[-3000:])
    job = tmp_path / "snaps" / "chaos"
    assert (job / "snapshot_iter_6.1").exists()
    assert not (job / "snapshot_iter_9.1").exists()
    _ok(_world("resume", tmp_path))


def test_corrupt_newest_snapshot_falls_back_to_previous(tmp_path):
    _ok(_world("corrupt", tmp_path,
               CHAINERMN_TPU_CHAOS="corrupt@match=snapshot_iter_6,rank=1"))


def test_sigterm_both_ranks_emergency_checkpoint_clean_exit(tmp_path):
    _ok(_world("sigterm", tmp_path,
               CHAINERMN_TPU_CHAOS="kill@step=5,signal=SIGTERM"))


@pytest.mark.parametrize("how", ["killed", "wedged"])
def test_watchdog_converts_dead_peer_into_bounded_abort(tmp_path, how):
    """Rank 1 dies (SIGKILL) or goes silent at step 3 while rank 0 sits
    in an array all-reduce over gloo. Killed: gloo raises as the peer's
    connection closes, the watchdog confirms the death, and the run ends
    with JobAbortedError, exit 75. Silent: gloo ignores the groups'
    abort, and the watchdog ends rank 0 with exit 75 after its grace.
    Both within the heartbeat timeout (1 s) plus the grace (1 s) plus
    slack for this host's load."""
    env = dict(CHAINERMN_TPU_WATCHDOG="1", CHAINERMN_TPU_HEARTBEAT_MS="200",
               CHAINERMN_TPU_HEARTBEAT_TIMEOUT_MS="1000",
               CHAINERMN_TPU_RPC_PROBE_MS="500")
    if how == "killed":
        env["CHAINERMN_TPU_CHAOS"] = "kill@step=3,rank=1"
    (rc0, out0), (rc1, out1) = _world(f"watchdog-{how}", tmp_path, **env)
    assert rc0 == ABORTED_EXIT_CODE, (rc0, out0[-3000:])
    if how == "killed":
        assert rc1 == -signal.SIGKILL, (rc1, out1[-3000:])
        assert "JobAbortedError" in out0 and "peer 1" in out0, out0[-3000:]
        took = float(out0.split("RANK0 exit 75 ")[1].split(" s")[0])
    else:
        assert rc1 == ABORTED_EXIT_CODE, (rc1, out1[-3000:])
        assert "did not leave its collective" in out0, out0[-3000:]
        took = float(out1.split("RANK1 saw rank 0 exit ")[1].split(" s")[0])
    assert took < 8.0, took


def test_supervised_kill_restart_resumes_and_finishes(tmp_path):
    results = _world("supervise", tmp_path, timeout=80,
                     CHAINERMN_TPU_CHAOS="kill@step=7,run=0")
    for rank, (rc, out) in enumerate(results):
        assert rc == 0 and f"RANK{rank} OK incarnation 1" in out, out[-3000:]
        assert "(crash)" in out and "(clean)" in out, out[-3000:]


def test_shrink_to_fit_resumes_at_world_one(tmp_path):
    from chainermn_torch.iterators import SerialIterator
    from chainermn_torch.resilience import elastic_resume

    _ok(_world("snapshots", tmp_path))
    job = tmp_path / "snaps" / "chaos"
    gone = [f for f in os.listdir(job) if f.startswith("snapshot_iter_")
            and f.split(".")[1] == "1"]
    assert gone
    for f in gone:
        os.remove(job / f)

    data = [(np.full((2,), float(i), np.float32), np.asarray(i, np.int32))
            for i in range(40)]
    exp, s, it = [], np.float32(0.0), SerialIterator(data, 8, seed=3)
    for _ in range(12):
        s = s + np.float32(np.stack([b[0] for b in next(it)]).mean())
        exp.append(float(s))

    comm = _Comm(0, 1)
    acc = torch.nn.Module()
    acc.register_buffer("s", torch.zeros(()))

    class NoOpt:
        def state_dict(self):
            return {}

        def load_state_dict(self, state):
            del state

    def step(x, y):
        acc.s += x.float().mean()
        return {"loss": acc.s.clone()}

    from chainermn_torch.training import StandardUpdater

    comm.device = torch.device("cpu")
    u = StandardUpdater(SerialIterator(data, 8, seed=3), step, comm,
                        model=acc, optimizer=NoOpt())
    ck = create_multi_node_checkpointer("chaos", comm,
                                        path=str(tmp_path / "snaps"))
    plan = elastic_resume(ck, u, global_dataset=data)
    assert (plan.action, plan.saved_world, plan.new_world) == ("shrink", 2, 1)
    assert u.iteration == 12 and float(acc.s) == exp[-1]
    assert len(u.iterator.dataset) == 40      # re-scattered onto one rank
    for _ in range(4):
        u.update()
        assert np.isfinite(float(u.last_metrics["loss"]))
    assert u.iteration == 16


def test_replica_recovery_elects_newest_iteration(tmp_path):
    _ok(_world("replicate", tmp_path))
    job = tmp_path / "snaps" / "chaos"
    # the ring left each rank's newest shard on its neighbour
    assert (job / "replicas" / "snapshot_iter_12.1").exists()
    assert (job / "replicas" / "snapshot_iter_12.0").exists()
    for f in os.listdir(job):
        if f.startswith("snapshot_iter_") and f.split(".")[1] == "1":
            os.remove(job / f)
    _ok(_world("replica-resume", tmp_path))


def test_watchdog_starts_in_a_two_rank_world(tmp_path):
    """``$CHAINERMN_TPU_WATCHDOG=1`` starts the Trainer's watchdog in a
    world of two (and the run stops it at its end)."""
    script = r'''
import os
from chainermn_torch import create_communicator
from chainermn_torch.resilience import watchdog
comm = create_communicator("naive", device="cpu")
wd = watchdog.maybe_start_watchdog()
assert wd is not None and wd.world == 2 and wd.rank == comm.rank
wd.check()
comm.host_barrier()
watchdog.stop_watchdog()
assert watchdog.current_watchdog() is None
print(f"RANK{comm.rank} OK", flush=True)
os._exit(0)
'''
    os.environ["CHAINERMN_TPU_WATCHDOG"] = "1"
    try:
        _ok(run_world(script, 2, 30))
    finally:
        del os.environ["CHAINERMN_TPU_WATCHDOG"]
