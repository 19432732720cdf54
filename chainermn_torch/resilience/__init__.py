"""Fault injection and survival for distributed training.

Counterpart of ``chainermn_tpu/resilience/``, with the same environment
variables (``CHAINERMN_TPU_CHAOS``, ``_WATCHDOG``, ``_HEARTBEAT_MS``,
``_RESTART_COUNT``, ``_PREEMPTION_GRACE_S``, ``_RPC_TIMEOUT_MS``,
``_RPC_PROBE_MS``), so one setting drives both packages:

* :mod:`.chaos` — deterministic, seed-driven fault injection (kill a
  rank at step N, delay/blackhole store RPCs, corrupt/truncate a
  checkpoint file, stall the snapshot plane), from
  ``$CHAINERMN_TPU_CHAOS``;
* :mod:`.preemption` — SIGTERM/SIGINT → flag → emergency checkpoint
  within the grace window → clean exit (the Trainer polls it every step);
* :mod:`.watchdog` — per-process heartbeat thread over the world's
  store that turns a dead peer into a bounded ``JobAbortedError``;
* :mod:`.policy` — the one RPC timeout/backoff policy of the host plane
  (``comm/object_plane.py``);
* :mod:`.supervisor` — per-host restart loop with a bounded crash
  budget (``python -m chainermn_torch.tools.supervise``);
* :mod:`.replica` — ring replication of each rank's newest verified
  snapshot to its neighbor, so a dead host's shard survives;
* :mod:`.elastic` — shrink-to-fit resume on a smaller world.
"""

from chainermn_torch.resilience.chaos import (
    ChaosPlan,
    Fault,
    FAULT_KINDS,
    chaos_from_env,
    parse_spec,
)
from chainermn_torch.resilience.elastic import (
    ElasticPlan,
    ElasticResumeError,
    ElasticTopologyError,
    elastic_resume,
    plan_elastic_resume,
)
from chainermn_torch.resilience.policy import RpcPolicy, policy, set_policy
from chainermn_torch.resilience.replica import PeerReplicator
from chainermn_torch.resilience.supervisor import (
    ABORTED_EXIT_CODE,
    BUDGET_EXHAUSTED_EXIT_CODE,
    RESTART_COUNT_ENV,
    RestartBudget,
    Supervisor,
    classify_exit,
    main_exit_code,
)
from chainermn_torch.resilience.preemption import (
    PREEMPTED_EXIT_CODE,
    PreemptionGuard,
    guard,
    install_preemption_handler,
    preemption_requested,
)
from chainermn_torch.resilience.watchdog import (
    Watchdog,
    current_watchdog,
    maybe_start_watchdog,
    start_watchdog,
    stop_watchdog,
)

__all__ = [
    "ChaosPlan",
    "Fault",
    "FAULT_KINDS",
    "chaos_from_env",
    "parse_spec",
    "ElasticPlan",
    "ElasticResumeError",
    "ElasticTopologyError",
    "elastic_resume",
    "plan_elastic_resume",
    "RpcPolicy",
    "policy",
    "set_policy",
    "PeerReplicator",
    "ABORTED_EXIT_CODE",
    "BUDGET_EXHAUSTED_EXIT_CODE",
    "RESTART_COUNT_ENV",
    "RestartBudget",
    "Supervisor",
    "classify_exit",
    "main_exit_code",
    "PREEMPTED_EXIT_CODE",
    "PreemptionGuard",
    "guard",
    "install_preemption_handler",
    "preemption_requested",
    "Watchdog",
    "current_watchdog",
    "maybe_start_watchdog",
    "start_watchdog",
    "stop_watchdog",
]
