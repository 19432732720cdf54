"""Deterministic, seed-driven fault injection for distributed training.

Counterpart of ``chainermn_tpu/resilience/chaos.py``: the same fault
kinds, the same spec grammar and the same ``$CHAINERMN_TPU_CHAOS``
variable, so one spec drives both packages. Its one change is where a
process finds its rank (:func:`_own_rank`): ``$CHAINERMN_TPU_CHAOS_RANK``,
then ``$RANK``, then ``torch.distributed.get_rank()`` once a group
exists.

The restart-based fault-tolerance story (per-rank snapshots + consensus
election) is only as good as its worst failure mode, and the dominant
ones are preemption, one wedged host, and torn snapshot files. This
harness *injects* exactly those faults, on a deterministic schedule, so
the tests can prove the stack survives them:

* ``kill`` — deliver a signal (SIGKILL/SIGTERM/...) to the *own* process
  when the training loop reaches a given step, on a given rank;
* ``delay_rpc`` — sleep before coordinator KV RPCs in the object plane
  (a slow/loaded coordinator);
* ``blackhole_rpc`` — stall matching RPCs for a long, configurable time
  (a wedged coordinator link; the guard probes bound the damage);
* ``corrupt`` / ``truncate`` — damage a named checkpoint file right
  after it is published (a torn write / bad disk);
* ``enospc`` — fail a matching snapshot publish with ``OSError(ENOSPC)``
  before any byte is written (a full disk — the save raises, nothing is
  published, the election must fall back);
* ``slow_disk`` — sleep before a matching snapshot publish (a
  overloaded/slow disk stretching the write window);
* ``kill_replica`` — abruptly kill ONE fleet replica's scheduler loop at
  a given working iteration (the in-process SIGKILL analogue the router
  drill uses: futures stay unresolved, survivors must absorb the work);
* ``corrupt_handoff`` — damage a prefill→decode KV handoff blob on the
  wire (flip or truncate), which the decode pool's manifest verification
  must catch and answer with a clean re-prefill;
* ``reset_conn`` / ``partial_write`` / ``stall_accept`` — socket-level
  connection faults for the TCP object plane (:func:`on_socket`,
  ``comm/socket_plane.py``): a connection dies with a frame in flight,
  a frame is torn mid-write, the listener wedges. The plane's framing
  (length + SHA), bounded reconnect, and re-handshake must contain
  every one to a re-sent frame — never a torn delivery;
* ``drop_handoff`` / ``delay_handoff`` / ``dup_handoff`` — wire-level
  delivery faults for the fleet transport (:func:`on_wire`): a frame
  vanishes, arrives late, or arrives twice. The transport's sequence
  numbers + SHA-verified frames + bounded NACK/re-send protocol must
  end every case in exact adoption or a clean re-prefill — never a
  poisoned decode slot or a duplicated token. All wire faults accept
  ``times=N`` (fire at most N times) so a drill can damage exactly one
  delivery attempt and let the re-send heal;
* ``corrupt_rollout_chunk`` / ``kill_mid_swap`` / ``canary_mismatch``
  — rolling-weight-update faults (the fleet's rolling update):
  a relay chunk is damaged on the wire (per-chunk SHA must NACK and
  re-send; persistent damage must end in a rollback to v1), a replica
  dies inside its swap window (classified as a crash; the restart
  converges to the version its verified local manifest names), and the
  canary's bitwise prompt replay miscompares (the rollout must abort
  with zero traffic moved).

Faults can be pinned to one supervised incarnation with ``run=K``: the
supervisor (:mod:`chainermn_torch.resilience.supervisor`) exports
``$CHAINERMN_TPU_RESTART_COUNT`` to each child, and a fault carrying
``run=K`` fires only when that counter equals ``K`` — so "kill at step 7,
first run only" heals on restart, while the same fault *without* ``run=``
reproduces a crash loop that must trip the restart budget.

Activation is by environment variable, so worker processes
self-inject without any code path knowing about the test:

    CHAINERMN_TPU_CHAOS="kill@step=3,rank=1,signal=SIGKILL"
    CHAINERMN_TPU_CHAOS="corrupt@match=snapshot_iter_6.1;delay_rpc@op=kv_get,ms=200,prob=0.5,seed=7"

Specs are ``;``-separated faults, each ``kind@key=value,key=value,...``.
Probabilistic faults draw from a ``seed``-pinned RNG: the same spec
replays the same failure schedule (the point of *deterministic* chaos).

Hook points (all no-ops when the env var is unset):

* :func:`on_step` — called by the Trainer loop (and any manual step
  loop) with the global iteration number;
* :func:`on_rpc` — called by ``comm/object_plane.py`` before each
  store RPC (ops: ``kv_get``, ``kv_put``, ``barrier``);
* :func:`on_checkpoint` — called by the checkpointer after publishing a
  snapshot file, with its path;
* :func:`on_publish` — called by the checkpointer right BEFORE writing a
  snapshot file (fires ``enospc``/``slow_disk``);
* :func:`on_offload` — called by the async snapshot plane
  (``checkpointing/async_plane.py``) at its two pipeline stages:
  ``stage="offload"`` on the step thread right before the device→host
  copy is kicked off (fires ``slow_offload``), and ``stage="writer"`` on
  the background writer thread right before serialization + publish
  (fires ``stall_writer`` — widening the offload→publish window a crash
  can land in, which is exactly what the SIGKILL drill needs).
"""

from __future__ import annotations

import errno
import os
import random
import signal as _signal
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

ENV_VAR = "CHAINERMN_TPU_CHAOS"

#: fault kind -> one-line description (the CLI's --dry-run catalogue)
FAULT_KINDS: Dict[str, str] = {
    "kill": ("deliver a signal to this process at a training step: "
             "step=N[,rank=R|*][,signal=SIGKILL|SIGTERM|...]"),
    "delay_rpc": ("sleep before matching coordinator RPCs: "
                  "ms=M[,op=kv_get|kv_put|barrier|*][,prob=P][,seed=S]"
                  "[,rank=R|*]"),
    "blackhole_rpc": ("stall matching coordinator RPCs: "
                      "[ms=M (default 3600000)][,op=...][,prob=P]"
                      "[,seed=S][,rank=R|*][,after=K (skip first K)]"),
    "corrupt": ("flip bytes in a checkpoint file right after publish: "
                "match=SUBSTRING[,rank=R|*][,offset=O]"),
    "truncate": ("truncate a checkpoint file right after publish: "
                 "match=SUBSTRING[,rank=R|*][,keep=BYTES (default half)]"),
    "enospc": ("fail a matching snapshot publish with OSError(ENOSPC): "
               "match=SUBSTRING[,rank=R|*][,after=K][,prob=P][,seed=S]"),
    "slow_disk": ("sleep before a matching snapshot publish: "
                  "ms=M,match=SUBSTRING[,rank=R|*][,prob=P][,seed=S]"),
    "slow_offload": ("sleep on the STEP thread before the async plane's "
                     "device-to-host offload (a congested PCIe/ICI "
                     "link): ms=M,match=SUBSTRING[,rank=R|*][,after=K]"
                     "[,prob=P][,seed=S]"),
    "stall_writer": ("sleep on the async plane's WRITER thread before "
                     "serialize+publish (stretches the offload→publish "
                     "window): ms=M,match=SUBSTRING[,rank=R|*][,after=K]"
                     "[,prob=P][,seed=S]"),
    "kill_replica": ("kill ONE serving replica's scheduler (the fleet "
                     "router's SIGKILL analogue: the loop dies abruptly, "
                     "futures unresolved, and the router must re-queue): "
                     "step=N[,replica=R|*][,rank=R|*]"),
    "corrupt_handoff": ("damage a prefill→decode KV handoff on the "
                        "wire (flip 64 bytes at offset, or truncate "
                        "when keep= is given — the transport must NACK "
                        "and the decode pool must fall back to a clean "
                        "re-prefill): [offset=O][,keep=BYTES][,after=K]"
                        "[,times=N][,prob=P][,seed=S][,rank=R|*]"),
    "drop_handoff": ("swallow a handoff frame on the wire (the sender's "
                     "RpcPolicy-bounded ack wait must notice and "
                     "re-send; an unbounded drop must end in a clean "
                     "re-prefill): [times=N][,after=K][,prob=P]"
                     "[,seed=S][,rank=R|*]"),
    "delay_handoff": ("hold a handoff frame in flight for ms= before "
                      "delivery (a congested DCN link — late frames "
                      "past the receiver's deadline must be fenced "
                      "out as duplicates): ms=M[,times=N][,after=K]"
                      "[,prob=P][,seed=S][,rank=R|*]"),
    "dup_handoff": ("deliver a handoff frame twice (the receiver must "
                    "dedup by stream — a double adoption would emit "
                    "duplicated tokens): [times=N][,after=K][,prob=P]"
                    "[,seed=S][,rank=R|*]"),
    "kill_dest": ("kill the MIGRATION DESTINATION replica right after "
                  "it adopts a migrated session, before the source "
                  "releases its slot (the adopt-before-ack crash "
                  "window — the router's sweep must replay the stream "
                  "from seed on a survivor): [times=N][,after=K]"
                  "[,prob=P][,seed=S][,rank=R|*]"),
    "reset_conn": ("abruptly close a SocketObjectPlane connection "
                   "before a frame is written (a peer RST / dead NAT "
                   "entry — the sender must reconnect with backoff and "
                   "the ack machinery must re-send the lost frame): "
                   "[times=N][,after=K][,prob=P][,seed=S][,rank=R|*]"),
    "partial_write": ("write only HALF a socket frame then close the "
                      "connection (a torn TCP stream — the receiver's "
                      "length/SHA framing must reject the fragment and "
                      "resync on the reconnect, never deliver torn "
                      "bytes): [times=N][,after=K][,prob=P][,seed=S]"
                      "[,rank=R|*]"),
    "stall_accept": ("sleep in the SocketObjectPlane acceptor before "
                     "accept() (a wedged listener — connect attempts "
                     "must time out under the RpcPolicy budget and "
                     "retry with jittered backoff): [ms=M (default "
                     "2000)][,times=N][,after=K][,prob=P][,seed=S]"
                     "[,rank=R|*]"),
    "corrupt_rollout_chunk": ("damage a weight-rollout relay chunk on "
                              "the wire (flip 64 bytes at offset, or "
                              "truncate when keep= is given — the "
                              "relay's per-chunk SHA must NACK and "
                              "re-send; when every attempt is damaged "
                              "the rollout must fail and roll back to "
                              "v1): [offset=O][,keep=BYTES][,after=K]"
                              "[,times=N][,prob=P][,seed=S][,rank=R|*]"),
    "kill_mid_swap": ("kill ONE replica inside its weight-swap window "
                      "(after drain, before readmit — the rollout "
                      "controller must classify the death as a crash, "
                      "skip the replica, and the restart must converge "
                      "to whichever version its local manifest "
                      "verifies): [replica=R|*][,times=N][,after=K]"
                      "[,prob=P][,seed=S][,rank=R|*]"),
    "canary_mismatch": ("force the rollout canary's bitwise prompt "
                        "replay to MISCOMPARE (a bad v2 snapshot — the "
                        "controller must abort with zero traffic "
                        "moved): [times=N][,after=K][,prob=P][,seed=S]"
                        "[,rank=R|*]"),
}

#: every fault kind also accepts ``run=K`` — fire only in supervised
#: incarnation K ($CHAINERMN_TPU_RESTART_COUNT, 0 when unsupervised)
_INT_KEYS = {"step", "ms", "offset", "keep", "after", "seed", "run",
             "replica", "times"}
_FLOAT_KEYS = {"prob"}


@dataclass
class Fault:
    kind: str
    step: Optional[int] = None
    rank: Optional[int] = None          # None = every rank ('*')
    signal: str = "SIGKILL"
    op: Optional[str] = None            # None = every rpc op ('*')
    ms: Optional[int] = None
    prob: float = 1.0
    seed: Optional[int] = None
    match: Optional[str] = None
    offset: int = 0
    keep: Optional[int] = None
    after: int = 0
    times: Optional[int] = None         # fire at most N times (wire faults)
    run: Optional[int] = None           # None = every incarnation
    replica: Optional[int] = None       # None = every replica ('*')
    fired: int = field(default=0, repr=False)
    _rng: Optional[random.Random] = field(default=None, repr=False)
    _skipped: int = field(default=0, repr=False)

    def rng(self) -> random.Random:
        if self._rng is None:
            self._rng = random.Random(self.seed)
        return self._rng

    def applies_to_rank(self, rank: Optional[int]) -> bool:
        return self.rank is None or rank is None or self.rank == rank

    def applies_to_run(self) -> bool:
        """Supervised-incarnation match: the supervisor exports the
        restart counter; unsupervised processes count as incarnation 0."""
        if self.run is None:
            return True
        return _own_run() == self.run

    def roll(self) -> bool:
        if self.prob >= 1.0:
            return True
        return self.rng().random() < self.prob

    def describe(self) -> str:
        """One-line human rendering of the set fields (the CLI's
        --dry-run listing)."""
        parts = []
        for name in ("step", "signal", "op", "ms", "prob", "seed",
                     "match", "offset", "keep", "after", "times", "run",
                     "replica"):
            val = getattr(self, name)
            if val is None:
                continue
            if name == "signal" and self.kind != "kill":
                continue
            if name == "prob" and val >= 1.0:
                continue
            if name in ("offset", "after") and not val:
                continue
            parts.append(f"{name}={val}")
        return " ".join(parts) or "(defaults)"


def parse_spec(spec: str) -> List[Fault]:
    """Parse a ``;``-separated chaos spec into faults (raises ValueError
    with the offending clause on malformed input)."""
    faults: List[Fault] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        kind, _, rest = clause.partition("@")
        kind = kind.strip()
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown chaos fault {kind!r} in {clause!r} — known: "
                + ", ".join(sorted(FAULT_KINDS)))
        kv: Dict[str, object] = {}
        for item in filter(None, (s.strip() for s in rest.split(","))):
            key, eq, val = item.partition("=")
            if not eq:
                raise ValueError(
                    f"malformed {key!r} in chaos clause {clause!r} "
                    "(expected key=value)")
            key = key.strip()
            val = val.strip()
            if key in ("rank", "replica") and val == "*":
                kv[key] = None
            elif key in _INT_KEYS or key == "rank":
                kv[key] = int(val)
            elif key in _FLOAT_KEYS:
                kv[key] = float(val)
            else:
                kv[key] = val
        try:
            fault = Fault(kind=kind, **kv)
        except TypeError as e:
            raise ValueError(
                f"bad field in chaos clause {clause!r}: {e}") from e
        if fault.kind in ("kill", "kill_replica") and fault.step is None:
            raise ValueError(
                f"{fault.kind} fault needs step=N: {clause!r}")
        if (fault.kind in ("corrupt", "truncate", "enospc", "slow_disk",
                           "slow_offload", "stall_writer")
                and not fault.match):
            raise ValueError(
                f"{fault.kind} fault needs match=SUBSTRING: {clause!r}")
        if (fault.kind in ("delay_rpc", "slow_disk", "slow_offload",
                           "stall_writer", "delay_handoff")
                and fault.ms is None):
            raise ValueError(f"{fault.kind} fault needs ms=M: {clause!r}")
        if fault.times is not None and fault.times <= 0:
            raise ValueError(f"times must be positive: {clause!r}")
        if not (0.0 <= fault.prob <= 1.0):
            raise ValueError(f"prob must be in [0, 1]: {clause!r}")
        faults.append(fault)
    return faults


def _own_run() -> int:
    """This process's supervised-incarnation number: 0 on the first
    launch (or unsupervised), incremented by the supervisor per restart
    (resilience/supervisor.py exports $CHAINERMN_TPU_RESTART_COUNT)."""
    raw = os.environ.get("CHAINERMN_TPU_RESTART_COUNT")
    if raw is not None:
        try:
            return int(raw)
        except ValueError:
            pass
    return 0


def _own_rank() -> Optional[int]:
    """This process's rank for fault matching: the test harness's worker
    id (``$CHAINERMN_TPU_CHAOS_RANK``) when set, else ``$RANK`` (what
    ``torchrun`` and the port's launchers export), else
    ``torch.distributed.get_rank()`` once a group is initialized, else
    None (matches every-rank faults only)."""
    for var in ("CHAINERMN_TPU_CHAOS_RANK", "RANK"):
        raw = os.environ.get(var)
        if raw is not None:
            try:
                return int(raw)
            except ValueError:
                pass
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:
        pass
    return None


class ChaosPlan:
    """The parsed fault schedule plus the injection hooks.

    ``kill_fn``/``sleep_fn`` are injectable for tests; real use keeps the
    defaults (``os.kill`` on the own pid, ``time.sleep``).
    """

    def __init__(self, faults: List[Fault],
                 kill_fn: Optional[Callable[[int], None]] = None,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.faults = faults
        self._kill = kill_fn or (
            lambda signum: os.kill(os.getpid(), signum))
        self._sleep = sleep_fn
        self.log: List[str] = []  # fired faults, for tests/debugging

    # -- hooks ----------------------------------------------------------

    def on_step(self, iteration: int, rank: Optional[int] = None) -> None:
        rank = _own_rank() if rank is None else rank
        for f in self.faults:
            if f.kind != "kill" or f.step != iteration:
                continue
            if not f.applies_to_rank(rank) or not f.applies_to_run():
                continue
            signum = getattr(_signal, f.signal, None)
            if signum is None:
                raise ValueError(f"unknown signal {f.signal!r}")
            f.fired += 1
            self.log.append(f"kill step={iteration} signal={f.signal}")
            self._kill(int(signum))

    def on_rpc(self, op: str, rank: Optional[int] = None) -> None:
        rank = _own_rank() if rank is None else rank
        for f in self.faults:
            if f.kind not in ("delay_rpc", "blackhole_rpc"):
                continue
            if f.op is not None and f.op != "*" and f.op != op:
                continue
            if not f.applies_to_rank(rank) or not f.applies_to_run():
                continue
            if f._skipped < f.after:
                f._skipped += 1
                continue
            if not f.roll():
                continue
            ms = f.ms if f.ms is not None else (
                3_600_000 if f.kind == "blackhole_rpc" else 0)
            f.fired += 1
            self.log.append(f"{f.kind} op={op} ms={ms}")
            self._sleep(ms / 1000.0)

    def on_checkpoint(self, path: str,
                      rank: Optional[int] = None) -> None:
        rank = _own_rank() if rank is None else rank
        base = os.path.basename(path)
        for f in self.faults:
            if f.kind not in ("corrupt", "truncate"):
                continue
            if not f.applies_to_rank(rank) or not f.applies_to_run():
                continue
            if f.match not in path and f.match not in base:
                continue
            if not f.roll():
                continue
            f.fired += 1
            self.log.append(f"{f.kind} path={base}")
            if f.kind == "truncate":
                size = os.path.getsize(path)
                keep = f.keep if f.keep is not None else size // 2
                with open(path, "rb+") as fh:
                    fh.truncate(max(0, keep))
            else:
                with open(path, "rb+") as fh:
                    fh.seek(f.offset)
                    chunk = fh.read(64) or b"\0"
                    fh.seek(f.offset)
                    fh.write(bytes(b ^ 0xFF for b in chunk))

    def on_publish(self, path: str,
                   rank: Optional[int] = None) -> None:
        """Pre-publish hook (the checkpointer calls it before any byte of
        a snapshot is written): ``slow_disk`` sleeps, ``enospc`` raises
        ``OSError(ENOSPC)`` so the save fails with nothing published —
        the election falls back, exactly like a full disk."""
        rank = _own_rank() if rank is None else rank
        base = os.path.basename(path)
        for f in self.faults:
            if f.kind not in ("enospc", "slow_disk"):
                continue
            if not f.applies_to_rank(rank) or not f.applies_to_run():
                continue
            if f.match not in path and f.match not in base:
                continue
            if f._skipped < f.after:
                f._skipped += 1
                continue
            if not f.roll():
                continue
            f.fired += 1
            self.log.append(f"{f.kind} path={base}")
            if f.kind == "slow_disk":
                self._sleep((f.ms or 0) / 1000.0)
            else:
                raise OSError(
                    errno.ENOSPC,
                    f"No space left on device (chaos enospc: {base})")

    def on_replica_step(self, replica: int, iteration: int,
                        rank: Optional[int] = None) -> bool:
        """Fleet-replica hook: the router's per-replica scheduler loop
        calls this before each WORKING iteration (idle spins don't
        count, so ``step=N`` means the same thing under any poll rate).
        Returns True when a matching ``kill_replica`` fault fires — the
        caller must die abruptly (no drain, no future resolution), the
        in-process analogue of SIGKILLing that replica's host."""
        rank = _own_rank() if rank is None else rank
        for f in self.faults:
            if f.kind != "kill_replica" or f.step != iteration:
                continue
            if f.replica is not None and f.replica != replica:
                continue
            if not f.applies_to_rank(rank) or not f.applies_to_run():
                continue
            f.fired += 1
            self.log.append(
                f"kill_replica replica={replica} step={iteration}")
            return True
        return False

    def _damage_handoff(self, f: Fault, data: bytes) -> bytes:
        """Apply one fired corruption fault (``corrupt_handoff`` or
        ``corrupt_rollout_chunk``): truncate to ``keep`` bytes, or
        XOR-flip 64 bytes at ``offset``."""
        if f.keep is not None:
            self.log.append(f"{f.kind} keep={f.keep}")
            return data[:max(0, f.keep)]
        self.log.append(f"{f.kind} offset={f.offset}")
        buf = bytearray(data)
        end = min(len(buf), f.offset + 64)
        for i in range(f.offset, end):
            buf[i] ^= 0xFF
        return bytes(buf)

    def _wire_gate(self, f: Fault, rank: Optional[int]) -> bool:
        """Shared fire/skip decision for the wire faults: rank + run +
        ``after=`` skip window + ``times=`` fire cap + probability."""
        if not f.applies_to_rank(rank) or not f.applies_to_run():
            return False
        if f.times is not None and f.fired >= f.times:
            return False
        if f._skipped < f.after:
            f._skipped += 1
            return False
        return f.roll()

    def on_handoff(self, data: bytes,
                   rank: Optional[int] = None) -> bytes:
        """KV-handoff byte hook (legacy single-blob form of
        :meth:`on_wire`): ``corrupt_handoff`` returns a damaged copy —
        64 bytes XOR-flipped at ``offset``, or the blob truncated to
        ``keep`` bytes. The decode side's manifest verification must
        catch it and fall back to a clean re-prefill."""
        rank = _own_rank() if rank is None else rank
        for f in self.faults:
            if f.kind != "corrupt_handoff":
                continue
            if not self._wire_gate(f, rank):
                continue
            f.fired += 1
            data = self._damage_handoff(f, data)
        return data

    #: on_wire traffic kind → corruption fault that targets it (the
    #: generic delivery faults drop/delay/dup fire for every kind)
    _WIRE_CORRUPT = {"handoff": "corrupt_handoff",
                     "rollout": "corrupt_rollout_chunk"}

    def on_wire(self, data: bytes,
                rank: Optional[int] = None,
                kind: str = "handoff") -> tuple:
        """Transport wire hook (fleet/transport.py, once per delivery
        ATTEMPT — a re-send rolls the faults again): returns
        ``(verdict, data)`` with verdict ``"deliver"``, ``"drop"`` (the
        frame vanishes; the sender's RpcPolicy-bounded ack wait must
        notice and re-send), or ``"dup"`` (the frame arrives twice; the
        receiver must dedup by stream). ``delay_handoff`` sleeps the
        frame in flight; the corruption fault matching ``kind`` damages
        the returned bytes (``corrupt_handoff`` for KV-handoff traffic,
        ``corrupt_rollout_chunk`` for weight-rollout relay chunks — a
        rollout drill must not damage ordinary handoffs, and vice
        versa). Wire faults honour ``times=N`` so a drill can drop
        exactly one attempt and let the re-send heal."""
        corrupt_kind = self._WIRE_CORRUPT.get(kind)
        if corrupt_kind is None:
            raise ValueError(f"unknown wire kind {kind!r} — known: "
                             + ", ".join(sorted(self._WIRE_CORRUPT)))
        rank = _own_rank() if rank is None else rank
        verdict = "deliver"
        for f in self.faults:
            if f.kind not in ("drop_handoff", "delay_handoff",
                              "dup_handoff", corrupt_kind):
                continue
            if not self._wire_gate(f, rank):
                continue
            f.fired += 1
            if f.kind == "drop_handoff":
                self.log.append("drop_handoff")
                return ("drop", data)
            if f.kind == "delay_handoff":
                self.log.append(f"delay_handoff ms={f.ms}")
                self._sleep((f.ms or 0) / 1000.0)
            elif f.kind == "dup_handoff":
                self.log.append("dup_handoff")
                verdict = "dup"
            else:
                data = self._damage_handoff(f, data)
        return (verdict, data)

    #: socket-plane op → fault kinds that can fire there
    _SOCKET_OPS = {"send": ("reset_conn", "partial_write"),
                   "accept": ("stall_accept",)}

    def on_socket(self, op: str,
                  rank: Optional[int] = None) -> Optional[str]:
        """Socket-level wire hook (comm/socket_plane.py) — the
        connection-layer extension of :meth:`on_wire`, for faults the
        verdict-over-bytes contract cannot express. ``op`` names the
        plane operation:

        * ``"send"`` — before a frame is written. Returns
          ``"reset_conn"`` (the plane must close the connection and
          lose the frame — a peer RST) or ``"partial_write"`` (the
          plane must write half the frame then close — a torn stream),
          else None.
        * ``"accept"`` — in the acceptor loop. ``stall_accept`` sleeps
          ``ms`` (default 2000) inline; always returns None.

        One fault per call (first match wins), gated like every wire
        fault: rank + run + ``after=`` + ``times=`` + probability."""
        kinds = self._SOCKET_OPS.get(op)
        if kinds is None:
            raise ValueError(f"unknown socket op {op!r} — known: "
                             + ", ".join(sorted(self._SOCKET_OPS)))
        rank = _own_rank() if rank is None else rank
        for f in self.faults:
            if f.kind not in kinds:
                continue
            if not self._wire_gate(f, rank):
                continue
            f.fired += 1
            self.log.append(f.kind)
            if f.kind == "stall_accept":
                self._sleep((f.ms if f.ms is not None else 2000) / 1000.0)
                return None
            return f.kind
        return None

    def on_migration(self, stream_id: int,
                     rank: Optional[int] = None) -> bool:
        """Migration hook (fleet/router.py ``drain``): called right
        after the DESTINATION replica adopts a migrated session and
        before the source slot is released — the adopt-before-ack
        window. Returns True when a matching ``kill_dest`` fault fires;
        the caller must kill the destination replica, whose sweep then
        re-queues the adopted session for a replay from seed."""
        rank = _own_rank() if rank is None else rank
        for f in self.faults:
            if f.kind != "kill_dest":
                continue
            if not self._wire_gate(f, rank):
                continue
            f.fired += 1
            self.log.append(f"kill_dest stream={stream_id}")
            return True
        return False

    def on_swap(self, replica: int,
                rank: Optional[int] = None) -> bool:
        """Rollout swap hook (fleet/rollout.py): called inside a
        replica's weight-swap window — after it drained, before it is
        readmitted. Returns True when a matching ``kill_mid_swap``
        fault fires; the caller must kill that replica abruptly (the
        SIGKILL-mid-swap analogue: the rollout controller classifies
        the death as a crash and skips the replica, and a supervised
        restart converges to whichever version its local manifest
        verifies)."""
        rank = _own_rank() if rank is None else rank
        for f in self.faults:
            if f.kind != "kill_mid_swap":
                continue
            if f.replica is not None and f.replica != replica:
                continue
            if not self._wire_gate(f, rank):
                continue
            f.fired += 1
            self.log.append(f"kill_mid_swap replica={replica}")
            return True
        return False

    def on_canary(self, rank: Optional[int] = None) -> bool:
        """Rollout canary hook (fleet/rollout.py): called right before
        the canary's bitwise compare against the v2 oracle. Returns
        True when a ``canary_mismatch`` fault fires — the caller must
        treat the compare as FAILED (a bad v2 snapshot) and abort the
        rollout with the fleet untouched."""
        rank = _own_rank() if rank is None else rank
        for f in self.faults:
            if f.kind != "canary_mismatch":
                continue
            if not self._wire_gate(f, rank):
                continue
            f.fired += 1
            self.log.append("canary_mismatch")
            return True
        return False

    #: pipeline stage → fault kind for :meth:`on_offload`
    _OFFLOAD_STAGES = {"offload": "slow_offload", "writer": "stall_writer"}

    def on_offload(self, path: str, stage: str,
                   rank: Optional[int] = None) -> None:
        """Async-plane hook: ``stage`` names the pipeline point —
        ``"offload"`` (step thread, before the device→host copy) fires
        ``slow_offload``; ``"writer"`` (writer thread, before
        serialize+publish) fires ``stall_writer``."""
        kind = self._OFFLOAD_STAGES.get(stage)
        if kind is None:
            raise ValueError(f"unknown offload stage {stage!r} — known: "
                             + ", ".join(sorted(self._OFFLOAD_STAGES)))
        rank = _own_rank() if rank is None else rank
        base = os.path.basename(path)
        for f in self.faults:
            if f.kind != kind:
                continue
            if not f.applies_to_rank(rank) or not f.applies_to_run():
                continue
            if f.match not in path and f.match not in base:
                continue
            if f._skipped < f.after:
                f._skipped += 1
                continue
            if not f.roll():
                continue
            f.fired += 1
            self.log.append(f"{f.kind} path={base}")
            self._sleep((f.ms or 0) / 1000.0)


_plan: Optional[ChaosPlan] = None
_plan_spec: Optional[str] = None


def chaos_from_env() -> Optional[ChaosPlan]:
    """The process-wide plan from $CHAINERMN_TPU_CHAOS (cached; re-parsed
    when the env var's value changes, so tests can swap specs)."""
    global _plan, _plan_spec
    spec = os.environ.get(ENV_VAR)
    if not spec:
        _plan, _plan_spec = None, None
        return None
    if _plan is None or spec != _plan_spec:
        _plan = ChaosPlan(parse_spec(spec))
        _plan_spec = spec
    return _plan


# module-level hook wrappers: callers stay one `if` away from zero cost

def on_step(iteration: int) -> None:
    if os.environ.get(ENV_VAR):
        plan = chaos_from_env()
        if plan is not None:
            plan.on_step(iteration)


def on_rpc(op: str) -> None:
    if os.environ.get(ENV_VAR):
        plan = chaos_from_env()
        if plan is not None:
            plan.on_rpc(op)


def on_checkpoint(path: str) -> None:
    if os.environ.get(ENV_VAR):
        plan = chaos_from_env()
        if plan is not None:
            plan.on_checkpoint(path)


def on_publish(path: str) -> None:
    if os.environ.get(ENV_VAR):
        plan = chaos_from_env()
        if plan is not None:
            plan.on_publish(path)


def on_offload(path: str, stage: str) -> None:
    if os.environ.get(ENV_VAR):
        plan = chaos_from_env()
        if plan is not None:
            plan.on_offload(path, stage)


def on_replica_step(replica: int, iteration: int) -> bool:
    if os.environ.get(ENV_VAR):
        plan = chaos_from_env()
        if plan is not None:
            return plan.on_replica_step(replica, iteration)
    return False


def on_handoff(data: bytes) -> bytes:
    if os.environ.get(ENV_VAR):
        plan = chaos_from_env()
        if plan is not None:
            return plan.on_handoff(data)
    return data


def on_wire(data: bytes, kind: str = "handoff") -> tuple:
    if os.environ.get(ENV_VAR):
        plan = chaos_from_env()
        if plan is not None:
            return plan.on_wire(data, kind=kind)
    return ("deliver", data)


def on_socket(op: str) -> Optional[str]:
    if os.environ.get(ENV_VAR):
        plan = chaos_from_env()
        if plan is not None:
            return plan.on_socket(op)
    return None


def on_migration(stream_id: int) -> bool:
    if os.environ.get(ENV_VAR):
        plan = chaos_from_env()
        if plan is not None:
            return plan.on_migration(stream_id)
    return False


def on_swap(replica: int) -> bool:
    if os.environ.get(ENV_VAR):
        plan = chaos_from_env()
        if plan is not None:
            return plan.on_swap(replica)
    return False


def on_canary() -> bool:
    if os.environ.get(ENV_VAR):
        plan = chaos_from_env()
        if plan is not None:
            return plan.on_canary()
    return False
