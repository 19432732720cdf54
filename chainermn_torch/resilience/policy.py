"""One RPC timeout/backoff policy for the whole host plane.

Counterpart of ``chainermn_tpu/resilience/policy.py``, a copy: the port's
object plane (``chainermn_torch/comm/object_plane.py``, over the world's
``torch.distributed`` store) derives every deadline from one
:class:`RpcPolicy`: the key-wait budget, the barrier budget, the probe
slice that bounds how long a dead store or an aborted job goes
unnoticed, and the jittered retry ladder. The environment variables keep
the JAX package's names, so one setting drives both packages:

``CHAINERMN_TPU_RPC_TIMEOUT_MS``
    The total budget for one blocking host-plane operation (a key wait, a
    barrier, a chunked put). Default 600 000.
``CHAINERMN_TPU_RPC_PROBE_MS``
    Fail-fast granularity: long waits are sliced into probes of this
    length so a dead store or an aborted job is noticed in O(probe), not
    O(timeout). Default 10 000.

Retries between probe slices follow jittered exponential backoff
(deterministic when seeded: the chaos harness pins the seed so failure
schedules replay exactly).
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

_ENV_TIMEOUT = "CHAINERMN_TPU_RPC_TIMEOUT_MS"
_ENV_PROBE = "CHAINERMN_TPU_RPC_PROBE_MS"

_DEFAULT_TIMEOUT_MS = 600_000
_DEFAULT_PROBE_MS = 10_000


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not an integer millisecond count")
    if v <= 0:
        raise ValueError(f"{name} must be positive, got {v}")
    return v


@dataclass(frozen=True)
class RpcPolicy:
    """Deadlines and retry shape for coordinator (host-plane) RPCs.

    ``timeout_ms``  — total budget for one blocking operation;
    ``probe_ms``    — liveness-probe slice length;
    ``backoff_base_ms``/``backoff_max_ms``/``backoff_factor``/``jitter``
    — the retry ladder: attempt ``k`` waits
    ``min(base * factor**k, max) * (1 ± jitter)``.
    """

    timeout_ms: int = _DEFAULT_TIMEOUT_MS
    probe_ms: int = _DEFAULT_PROBE_MS
    backoff_base_ms: int = 100
    backoff_max_ms: int = 5_000
    backoff_factor: float = 2.0
    jitter: float = 0.25
    seed: Optional[int] = None

    @classmethod
    def from_env(cls) -> "RpcPolicy":
        return cls(timeout_ms=_env_int(_ENV_TIMEOUT, _DEFAULT_TIMEOUT_MS),
                   probe_ms=_env_int(_ENV_PROBE, _DEFAULT_PROBE_MS))

    def _rng(self) -> random.Random:
        return random.Random(self.seed)

    def backoff_ms(self, attempt: int,
                   rng: Optional[random.Random] = None) -> int:
        """Jittered exponential delay before retry ``attempt`` (0-based)."""
        if rng is None:
            rng = self._rng() if self.seed is not None else random
        base = min(self.backoff_base_ms * self.backoff_factor ** attempt,
                   float(self.backoff_max_ms))
        lo, hi = base * (1 - self.jitter), base * (1 + self.jitter)
        return max(1, int(rng.uniform(lo, hi)))

    def backoffs_ms(self, n: int) -> Iterator[int]:
        """The first ``n`` delays of the ladder (one shared RNG so a
        seeded policy yields a reproducible schedule)."""
        rng = self._rng() if self.seed is not None else None
        for k in range(n):
            yield self.backoff_ms(k, rng=rng)

    def liveness_ladder_ms(self) -> Tuple[int, ...]:
        """Per-attempt deadlines for the coordinator liveness check: two
        short attempts scaled off the probe slice (historically 2 s and
        5 s under the 10 s probe) — a loaded coordinator may miss one
        short deadline, so the second attempt waits longer."""
        return (max(1, self.probe_ms // 5), max(1, self.probe_ms // 2))

    def barrier_ms(self) -> int:
        """Budget for one host-plane barrier: barriers gate short
        metadata exchanges (allgather inventories), so they get a tenth
        of the payload budget, floored at one probe slice."""
        return max(self.probe_ms, self.timeout_ms // 10)

    def handoff_ack_ms(self) -> int:
        """Per-attempt budget for one handoff-frame acknowledgement
        (the fleet transport's). One probe slice: an unacked frame should
        re-send in O(probe), not ride out the full payload timeout —
        the re-send itself is bounded by the transport's attempt cap."""
        return max(1, self.probe_ms)

    def put_budget_ms(self, nchunks: int) -> int:
        """Budget for a chunked KV put — scales with payload so multi-GB
        scatters aren't cut off (one probe slice of headroom per chunk)."""
        return self.timeout_ms + self.probe_ms * max(1, nchunks)


_policy: Optional[RpcPolicy] = None


def policy() -> RpcPolicy:
    """The process-wide policy (env-derived, cached on first use)."""
    global _policy
    if _policy is None:
        _policy = RpcPolicy.from_env()
    return _policy


def set_policy(p: Optional[RpcPolicy]) -> Optional[RpcPolicy]:
    """Install ``p`` as the process-wide policy (``None`` re-derives from
    the environment on next use). Returns the previous policy — tests
    restore it."""
    global _policy
    prev, _policy = _policy, p
    return prev
