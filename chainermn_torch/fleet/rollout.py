"""Zero-downtime rolling weight updates for a live Router fleet.

Counterpart of ``chainermn_tpu/fleet/rollout.py``.

A weight change used to mean killing the fleet. This controller walks a
live fleet from weights v1 to v2 with zero dropped or duplicated tokens
and zero downtime, one replica at a time, under the lifecycle

    CANARY  → the candidate snapshot must reproduce a pinned prompt set
              BITWISE against a v2 oracle (greedy, fixed seeds) on an
              off-traffic engine before any traffic moves; a miscompare
              aborts with the fleet untouched;
    DRAIN   → the replica leaves service through the router's
              ``UP → DRAINING → DRAINED`` lifecycle — live sessions
              migrate to survivors (``Router.drain``), so its streams
              never stop;
    SWAP    → the verified v2 snapshot installs in place
              (``Engine.swap_weights`` → ``ServingStep.load_params`` —
              the served snapshot is overwritten in place, no page is
              touched);
    READMIT → a fresh worker thread re-registers the replica
              (``Router.readmit``) and load-aware placement re-balances
              onto it before the next replica is taken.

**The relay.** Weights move over a chunked relay on the handoff
transport (``InProcessTransport``/``ObjectPlaneTransport`` — per-frame
SHA verify, NACK → bounded re-send, duplicate fencing, exactly wire
format 5's discipline): the snapshot is encoded ONCE
(``serving.weights.encode_weights``, ``f32`` or the ``int8-block``
publish codec), split into fixed-size chunks each carrying its own
byte-count + SHA-256 manifest, and closed by a frame committing every
chunk digest plus the full-payload weights manifest. Each replica that
finishes receiving becomes the next hop's FORWARDER, so the publisher's
egress is ~1× the snapshot regardless of fleet size (HiCCL's
hierarchical composition applied to weight broadcast). Every receiver
re-verifies the assembled payload against the weights manifest
(``decode_weights``) before a byte reaches an engine.

**Failure modes** (the point):

* canary miscompare (or chaos ``canary_mismatch``) — abort; zero
  traffic moved, zero replicas touched; ``canary_failures`` counts it.
* corrupt/truncated relay chunk (chaos ``corrupt_rollout_chunk``) —
  the transport NACKs and re-sends that chunk; persistent damage
  exhausts the attempt budget, the hop fails, and the rollout ROLLS
  BACK: every already-swapped replica walks back to v1 through the
  same drain → swap → readmit path. The fleet ends fully on v1, still
  serving.
* replica death inside the swap window (chaos ``kill_mid_swap``, a
  real SIGKILL in the supervised drill) — classified as a CRASH: the
  replica stays out of service for its supervisor, whose restart loads
  whichever version its local manifest verifies
  (``serving/weights.py``); the walk continues on the rest.
* version skew — every handoff/session manifest carries
  ``weights_version``; a v2 frame arriving at a v1 engine (or vice
  versa) is REFUSED (``WeightsVersionSkew``) and the stream falls back
  to a clean re-prefill / replay-from-seed, so every emitted stream is
  entirely ONE version, bitwise against that version's oracle — never
  silently mixed.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from chainermn_torch.fleet.transport import InProcessTransport
from chainermn_torch.resilience import chaos
from chainermn_torch.serving.weights import (WeightsError, decode_weights,
                                           encode_weights)

__all__ = ["RolloutController", "RolloutError", "DEFAULT_CHUNK_BYTES"]

#: relay chunk payload size (1 MiB): big enough that the per-chunk
#: manifest is noise, small enough that a corrupt chunk's re-send is
#: cheap relative to the snapshot
DEFAULT_CHUNK_BYTES = 1 << 20


class RolloutError(RuntimeError):
    """The rollout could not even start (bad arguments, a fleet too
    small to drain). Mid-walk failures do NOT raise — they roll back
    and report ``status='rolled_back'``."""


class RolloutController:
    """Walks a live :class:`~chainermn_torch.fleet.router.Router` fleet
    from one weights version to the next.

    ``engine_factory(params, weights_version)`` builds the OFF-TRAFFIC
    canary engine from candidate params (for the real engine:
    ``lambda p, v: Engine(model, p, cfg, weights_version=v)``; the
    FakeEngine campaign passes its fake factory). ``transport_factory``
    builds one relay hop's transport (default: an in-process transport
    tagged ``chaos_kind='rollout'``, so rollout chaos never damages
    ordinary handoff traffic and vice versa). ``like`` is the params
    template receivers unflatten against (None keeps the flat dict —
    what the FakeEngine swap face takes)."""

    def __init__(self, router, engine_factory: Callable[[Any, str], Any],
                 *, transport_factory: Optional[Callable[[], Any]] = None,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 wire_format: Optional[str] = None,
                 like: Any = None,
                 drain_deadline_ms: Optional[int] = None):
        if chunk_bytes < 1:
            raise RolloutError("chunk_bytes must be >= 1")
        self.router = router
        self.engine_factory = engine_factory
        self.transport_factory = (transport_factory or (
            lambda: InProcessTransport(chaos_kind="rollout")))
        self.chunk_bytes = int(chunk_bytes)
        self.wire_format = wire_format
        self.like = like
        self.drain_deadline_ms = drain_deadline_ms

    # ----------------------------------------------------------------
    # relay
    # ----------------------------------------------------------------

    def _frames(self, manifest: dict, data: bytes):
        """Split the encoded snapshot into SHA-manifested chunk frames
        plus the closing frame committing every chunk digest and the
        full-payload weights manifest (wire format 5's shape applied to
        weights)."""
        chunks: List[Tuple[dict, bytes]] = []
        table: List[dict] = []
        for i in range(0, max(1, len(data)), self.chunk_bytes):
            blob = data[i:i + self.chunk_bytes]
            man = {"kind": "rollout_chunk",
                   "index": len(chunks),
                   "bytes": len(blob),
                   "sha256": hashlib.sha256(blob).hexdigest()}
            chunks.append((man, blob))
            table.append({"index": man["index"], "bytes": man["bytes"],
                          "sha256": man["sha256"]})
        closing_blob = json.dumps(
            {"weights": manifest, "chunks": table},
            sort_keys=True).encode()
        closing_man = {"kind": "rollout_closing",
                       "count": len(chunks),
                       "bytes": len(closing_blob),
                       "sha256": hashlib.sha256(closing_blob).hexdigest()}
        return chunks, (closing_man, closing_blob)

    def _ship_hop(self, manifest: dict, chunks, closing,
                  ) -> Tuple[Optional[Any], int, List[str]]:
        """One relay hop: ship every chunk + the closing frame over a
        fresh transport, then assemble, verify, and decode on the
        receiving side. Returns ``(params, wire_bytes, defects)`` —
        params is None when the hop FAILED (a chunk exhausted the
        NACK/re-send budget, or the assembled payload refused the
        weights manifest). ``wire_bytes`` counts every adopted payload
        byte, so the caller's accounting is exact."""
        t = self.transport_factory()
        shipped = 0
        defects: List[str] = []
        try:
            for sid, (man, blob) in enumerate(
                    list(chunks) + [closing]):
                status = t.send(sid, man, blob)
                if status not in ("adopted", "duplicate"):
                    defects.extend(getattr(t, "last_send_defects", ()))
                    defects.append(
                        f"chunk {man.get('index', 'closing')} "
                        f"undeliverable (status={status})")
                    return None, shipped, defects
                shipped += len(blob)
            arrivals = {}
            for a in t.poll():
                if a.failed:
                    defects.extend(a.defects)
                    continue
                arrivals[a.stream_id] = a
            closing_arr = arrivals.get(len(chunks))
            if closing_arr is None:
                defects.append("closing frame never arrived")
                return None, shipped, defects
            committed = json.loads(closing_arr.blob.decode())
            parts: List[bytes] = []
            for ent in committed["chunks"]:
                a = arrivals.get(int(ent["index"]))
                if a is None:
                    defects.append(f"chunk {ent['index']} missing")
                    return None, shipped, defects
                if (len(a.blob) != int(ent["bytes"])
                        or hashlib.sha256(a.blob).hexdigest()
                        != ent["sha256"]):
                    defects.append(
                        f"chunk {ent['index']} does not match the "
                        "closing commitment")
                    return None, shipped, defects
                parts.append(a.blob)
            try:
                params = decode_weights(committed["weights"],
                                        b"".join(parts), like=self.like)
            except WeightsError as e:
                defects.append(str(e))
                return None, shipped, defects
            return params, shipped, defects
        finally:
            t.close()

    # ----------------------------------------------------------------
    # canary
    # ----------------------------------------------------------------

    def _canary_check(self, params: Any, version: str,
                      prompts: Sequence[Tuple[Any, int, int]],
                      oracle: Sequence[Sequence[int]]) -> List[int]:
        """Replay the pinned prompt set (greedy, fixed seeds) on an
        OFF-TRAFFIC engine built from the candidate params and compare
        bitwise against the caller's v2 oracle. Returns the indices
        that miscompared (chaos ``canary_mismatch`` forces ``[-1]``)."""
        if len(prompts) != len(oracle):
            raise RolloutError(
                f"{len(prompts)} canary prompts vs {len(oracle)} oracle "
                "streams")
        eng = self.engine_factory(params, version)
        reqs = []
        for prompt, seed, n in prompts:
            reqs.append(eng.submit(np.asarray(prompt, np.int32),
                                   max_new_tokens=int(n),
                                   seed=int(seed)))
        eng.run_until_drained()
        mismatched = [i for i, (req, want) in enumerate(zip(reqs, oracle))
                      if list(req.tokens) != [int(x) for x in want]]
        if chaos.on_canary():
            mismatched.append(-1)
        return mismatched

    # ----------------------------------------------------------------
    # the walk
    # ----------------------------------------------------------------

    def rollout(self, params: Any, version: str, *,
                canary_prompts: Sequence[Tuple[Any, int, int]],
                canary_oracle: Sequence[Sequence[int]],
                from_version: Optional[str] = None) -> dict:
        """Walk the fleet to ``params``/``version``. Blocking (runs on
        the caller's thread, like ``Router.drain``); traffic keeps
        flowing throughout — at most one replica is out of placement at
        any instant.

        ``canary_prompts`` is a sequence of ``(prompt, seed,
        max_new_tokens)``; ``canary_oracle`` the matching v2 streams
        (greedy, fixed seeds — produce them on a reference engine
        holding the v2 snapshot). ``from_version`` stamps any engine
        still serving UNVERSIONED weights before the walk, so the skew
        fence has a v1 name to refuse against (engines already
        versioned are left alone).

        Single-host note: the canary replays on THIS thread, and its
        first dispatches (kernel builds on a fresh card) can hold the
        GIL — on a co-located drill, build the ``Router`` with a
        ``health_timeout_ms`` that covers them, or the starved worker
        heartbeats read as replica deaths.

        Returns a status dict::

            {"status":   "completed" | "aborted" | "rolled_back",
             "version":  the target version,
             "swapped":  replicas now serving it,
             "crashed":  replicas lost inside their swap window,
             "rolled_back": replicas walked back to v1,
             "publisher_egress_bytes": hop-0 relay bytes (~1× snapshot),
             "relay_wire_bytes":       all hops' relay bytes,
             "reason":   why, for aborted/rolled_back}
        """
        report = self.router.report
        targets = sorted(rid for rid, rep in self.router.replicas.items()
                         if rep.state() == "UP")
        if len(targets) < 2:
            raise RolloutError(
                f"{len(targets)} UP replicas — a rolling update needs "
                "at least 2 (each drain migrates onto survivors)")
        if from_version is not None:
            for rid in targets:
                eng = self.router.replicas[rid].engine
                if getattr(eng, "weights_version", None) is None:
                    eng.weights_version = from_version

        manifest, data = encode_weights(
            params, wire_format=self.wire_format, weights_version=version)
        chunks, closing = self._frames(manifest, data)

        # CANARY: the candidate decodes and replays OFF-TRAFFIC before
        # a single byte moves fleet-ward. The canary engine is built
        # from the same (manifest, payload) pair the relay will ship,
        # so what it verified is what the fleet receives.
        try:
            canary_params = decode_weights(manifest, data, like=self.like)
        except WeightsError as e:
            report.record_canary_failure()
            return {"status": "aborted", "version": version,
                    "swapped": [], "crashed": [], "rolled_back": [],
                    "publisher_egress_bytes": 0, "relay_wire_bytes": 0,
                    "reason": f"candidate snapshot refused: {e}"}
        mismatched = self._canary_check(canary_params, version,
                                        canary_prompts, canary_oracle)
        if mismatched:
            report.record_canary_failure()
            return {"status": "aborted", "version": version,
                    "swapped": [], "crashed": [], "rolled_back": [],
                    "publisher_egress_bytes": 0, "relay_wire_bytes": 0,
                    "reason": ("canary miscompared on prompt(s) "
                               f"{mismatched} — fleet untouched")}

        swapped: List[Tuple[int, Any, Any]] = []   # rid, old params/ver
        crashed: List[int] = []
        egress = 0
        total_wire = 0
        failure: Optional[str] = None
        for hop, rid in enumerate(targets):
            # relay: hop 0 is the publisher's single upload; every
            # later hop forwards from the previous finished receiver
            hop_params, wire, defects = self._ship_hop(
                manifest, chunks, closing)
            total_wire += wire
            report.record_rollout_wire(wire)
            if hop == 0:
                egress = wire
            if hop_params is None:
                failure = (f"relay to replica {rid} failed: "
                           + "; ".join(defects[-3:] or ("unknown",)))
                break
            try:
                old = self._swap_and_readmit_guarded(rid, hop_params,
                                                     version, crashed)
            except Exception as e:      # drain refused / engine error
                failure = (f"replica {rid} could not swap: "
                           f"{type(e).__name__}: {e}")
                break
            if old is not None:
                swapped.append((rid, old[0], old[1]))

        if failure is None:
            report.record_rollout_completed()
            return {"status": "completed", "version": version,
                    "swapped": [rid for rid, _p, _v in swapped],
                    "crashed": crashed, "rolled_back": [],
                    "publisher_egress_bytes": egress,
                    "relay_wire_bytes": total_wire, "reason": None}

        # ROLLBACK: walk every already-swapped replica back to v1
        # through the SAME drain path, newest first. The stashed params
        # are the engine's internal (converted) form — converted=True.
        walked_back: List[int] = []
        for rid, old_params, old_version in reversed(swapped):
            self.router.drain(rid, deadline_ms=self.drain_deadline_ms)
            self.router.replicas[rid].engine.swap_weights(
                old_params, old_version, converted=True)
            self.router.readmit(rid)
            walked_back.append(rid)
        report.record_rollout_rolled_back()
        return {"status": "rolled_back", "version": version,
                "swapped": [], "crashed": crashed,
                "rolled_back": walked_back,
                "publisher_egress_bytes": egress,
                "relay_wire_bytes": total_wire, "reason": failure}

    def _swap_and_readmit_guarded(self, rid: int, params: Any,
                                  version: str, crashed: List[int]):
        """The swap window with its chaos hook: after DRAIN, before
        READMIT, ``kill_mid_swap`` may fire — the in-process analogue
        of SIGKILLing the replica's host mid-swap. The replica then
        stays OUT of service (state DRAINED, never readmitted), exactly
        like a crashed host waiting for its supervisor, whose restart
        loads whichever version its local manifest verifies. Returns
        the previous (params, version), or None when the replica was
        lost to the window."""
        self.router.drain(rid, deadline_ms=self.drain_deadline_ms)
        if chaos.on_swap(rid):
            crashed.append(rid)
            return None
        rep = self.router.replicas[rid]
        old = rep.engine.swap_weights(params, version)
        self.router.readmit(rid)
        return old
