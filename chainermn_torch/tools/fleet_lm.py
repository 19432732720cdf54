#!/usr/bin/env python
"""fleet_lm — a serving FLEET in one process: N engine replicas behind
the router, or a disaggregated prefill/decode pair.

Counterpart of the JAX package's ``tools/fleet_lm.py``, with its flags
plus ``--device`` (``cuda`` unless the caller asks for ``cpu``) and the
model's ``--d-ff``/``--dtype``/``--attention`` (JAX's model by
default: d_ff twice d_model, f32, plain attention). ``--weights``
warm-loads a snapshot this tool or the JAX one published, so the two
CLIs serve one model; without a snapshot the weights come from a
seeded init (``torch.manual_seed(--seed)``). Run on the CPU with::

    python -m chainermn_torch.tools.fleet_lm --device cpu --out s.jsonl

Builds one seeded TransformerLM, shares its weights across every
replica (warm-loading from a published snapshot when one exists, like
serve_lm.py), queues a deterministic batch of prompts, and drains:

* default — ``fleet.Router`` over ``--replicas`` engines, each in its
  own worker thread: load-aware + session-affine placement, queue-depth
  backpressure, and heartbeat-driven replica health. With
  ``$CHAINERMN_TPU_CHAOS='kill_replica@step=N,replica=R'`` the targeted
  worker dies mid-stream and the router re-queues its slots onto
  survivors — the drill asserts every stream still completes with zero
  dropped or duplicated tokens (seeded replay, serving/sampling.py).
* ``--disaggregate`` — ``fleet.DisaggregatedFleet``: prefill engine →
  KVHandoff wire (``--wire-format`` f32 | int8-block) → decode engine,
  exposed to ``corrupt_handoff`` faults (fallback = clean re-prefill).
  Add ``--async-conveyor`` to overlap the wire with decode steps.
* ``--hosts N --host-rank R`` — REAL cross-process disaggregation:
  ranks 0..P-1 (``--prefill-hosts P``, default 1) prefill and ship
  seq/SHA-framed handoffs; ranks P..N-1 adopt and decode. The wire is
  picked by ``--transport``: ``fs`` (default) is the restart-tolerant
  on-disk ``FsObjectPlane`` under ``--plane-dir``; ``socket`` is the
  TCP ``comm.socket_plane.SocketObjectPlane`` over the ``--endpoints``
  host:port list (one per rank). Destination choice is m×n: each
  prefill host ships every ready handoff to the least-loaded decode
  host that is not currently suspect (its last send failed — the
  saturated-survivor precheck), announcing ownership first with an
  ``{"kind": "expect", "sid": i}`` control frame on tag 7003 and
  closing its run with one ``{"kind": "eof"}`` per decode host.
  ``--streamed`` ships each handoff as format-5 per-layer chunk
  frames + a closing manifest — a corrupt chunk NACKs and re-sends
  alone. Wire-level chaos (``drop_handoff``/``delay_handoff``/
  ``dup_handoff``/``corrupt_handoff``, plus the socket-level
  ``reset_conn``/``partial_write``/``stall_accept``) tears at the
  frames in flight; ``kill@step=`` SIGKILLs a prefill process
  mid-transfer — under ``resilience.Supervisor`` the restarted
  incarnation re-prefills every unfinished stream and the receivers'
  fences answer already-adopted replays with duplicate acks (zero
  dropped or duplicated tokens).

Completed streams append to ``--out`` idempotently (request ids already
on disk are skipped), so a supervised restart heals to the same final
JSONL the unkilled run would have produced — per-request seeds are
``--seed + request_id``, making sampled streams as replayable as greedy
ones. In ``--hosts`` mode each decode host writes a per-incarnation
part file ``<out>.h<rank>.r<restart>`` instead (a restarted process
never appends to a file a SIGKILL may have torn mid-line); ``_done_ids``
merges base + parts and skips torn trailing lines. Exit status follows
the supervisor contract: 0 clean, 75 on a watchdog abort, anything else
is a crash.

Signal contract: **SIGUSR1 requests a graceful drain** (same contract
as serve_lm.py; ``classify_exit`` bills neither the exit nor an
unhandled -SIGUSR1 to the crash budget). Router mode sheds the
never-placed backlog (``Router.shed_pending``) and finishes every
in-flight stream — in-flight sessions on a replica being RETIRED move
with ``Router.drain``'s live migration, not this signal; the
disaggregated and ``--hosts`` modes finish their in-flight sessions.
Either way the process flushes its reports and exits 0, and the shed
ids are re-submitted by the next incarnation's idempotent replay.

**SIGHUP requests a live rolling weight update** (router mode): with
``--rollout PATH`` naming a published candidate snapshot, the serving
loop runs ``fleet.RolloutController`` over the live router — bitwise
canary gate, chunked relay, per-replica DRAIN → SWAP → READMIT — while
traffic keeps flowing; the JSONL stays idempotent across the swap. On
a COMPLETED rollout the candidate is atomically re-published to
``--weights``, so a later restart warm-loads the new version; a
SIGKILL inside the rollout window classifies as a crash
(``classify_exit``) and the supervised restart converges to whichever
version its verified local manifest names — the new one after the
publish commit point, the old one before it. A canary miscompare or a
relay failure leaves (or rolls back to) the incumbent version, fleet
still serving. SIGHUP without ``--rollout`` is logged and ignored.
"""

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def _log(msg):
    print(f"fleet_lm: {msg}", file=sys.stderr, flush=True)


def _done_ids(path):
    """Request ids already drained to the JSONL — the base file plus any
    per-host/per-incarnation part files (``--hosts`` mode). A SIGKILLed
    incarnation can leave its newest line torn, so undecodable lines are
    skipped: the request they would have recorded re-runs, and seeded
    replay makes the re-run emit the identical stream."""
    done = set()
    for p in [path] + sorted(glob.glob(path + ".h*")):
        if not os.path.exists(p):
            continue
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    done.add(json.loads(line)["request_id"])
                except (ValueError, KeyError):
                    continue     # torn trailing line from a killed run
    return done


def _emit(out, i, prompt, tokens, reason=None):
    rec = {"request_id": i, "prompt": prompt.tolist(),
           "tokens": list(tokens)}
    if reason is not None:
        # the stream fell back to a clean re-prefill; say WHY — the
        # per-frame defect history the transport attached to the failure
        rec["fallback_reason"] = reason
    out.write(json.dumps(rec) + "\n")
    out.flush()
    os.fsync(out.fileno())


def _nest(flat):
    """A flat ``{"a/b/c": array}`` dict as the nested tree it came from."""
    out = {}
    for key, arr in flat.items():
        node = out
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return out


def load_state(path, model):
    """The model's state dict from a verified snapshot at ``path``:
    one this tool published (the port's parameter names) or one the
    JAX package published (a flax tree, converted). Raises
    ``WeightsError`` when nothing verifies or the shapes disagree."""
    import torch

    from chainermn_torch.models.convert import params_from_flax
    from chainermn_torch.serving import load_weights
    from chainermn_torch.serving.weights import WeightsError

    flat, src = load_weights(path)
    sd = model.state_dict()
    if set(flat) != set(sd):
        try:
            flat = params_from_flax(model, _nest(flat))
        except (KeyError, TypeError, ValueError) as e:
            raise WeightsError(f"{src}: not this model's weights ({e})")
    out = {}
    for k, ref in sd.items():
        arr = torch.as_tensor(flat[k])
        if tuple(arr.shape) != tuple(ref.shape):
            raise WeightsError(f"{src}: shape mismatch for {k!r}: "
                               f"{tuple(arr.shape)} vs {tuple(ref.shape)}")
        out[k] = arr.to(ref.dtype)
    return out, src


def _engine_factory(args):
    """Shared model/params/engine construction. Params come from the
    seeded init (identical in every process — the cross-host bitwise
    contract needs no weight shipping) unless ``--weights`` names a
    published snapshot to warm-load or cold-publish."""
    import torch

    from chainermn_torch.models.transformer import TransformerLM
    from chainermn_torch.serving import (Engine, EngineConfig,
                                         publish_weights)
    from chainermn_torch.serving.weights import WeightsError

    torch.manual_seed(args.seed)
    model = TransformerLM(vocab=args.vocab, d_model=args.d_model,
                          n_heads=args.n_heads, n_layers=args.n_layers,
                          d_ff=args.d_ff or 2 * args.d_model,
                          max_len=args.capacity,
                          attention=args.attention, pos_emb="rope",
                          dtype=getattr(torch, args.dtype),
                          device=args.device)
    if args.weights:
        try:
            params, src = load_state(args.weights, model)
            model.load_state_dict(params)
            _log(f"warm weights loaded from {src}")
        except WeightsError:
            publish_weights(model.state_dict(), args.weights)
            _log(f"cold boot: published weights to {args.weights}")
    params = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}

    def make(p=None, weights_version=None):
        # decode_k=1 so kill_replica@step=N counts one token per
        # working iteration — the drill timing contract (serve_lm.py);
        # every engine serves a snapshot of its own, so a candidate's
        # params load into the engine and never into the shared model
        eng = Engine(model,
                     EngineConfig(n_slots=args.slots,
                                  capacity=args.capacity,
                                  max_new_tokens=args.max_new_tokens,
                                  prefill_cohort=1,
                                  buckets=[args.prompt_len,
                                           args.capacity],
                                  decode_k=args.decode_k,
                                  prefill_chunk=args.prefill_chunk),
                     device=args.device, weights_version=weights_version)
        if p is not None:
            eng.steps.load_params(p)
        return eng

    def engine():
        return make()

    # the rollout path (SIGHUP + --rollout) needs the template params
    # and a versioned-engine constructor alongside the plain factory
    engine.make = make
    engine.params = params
    engine.model = model
    return engine


def _pending_prompts(args):
    """The deterministic request batch minus what prior incarnations
    already drained (base JSONL + any ``--hosts`` part files)."""
    done = _done_ids(args.out)
    rng = np.random.RandomState(args.seed)
    prompts = {}
    for i in range(args.requests):
        prompt = rng.randint(0, args.vocab,
                             (args.prompt_len,)).astype(np.int32)
        if i not in done:
            prompts[i] = prompt
    _log(f"queued {len(prompts)} of {args.requests} requests "
         f"({len(done)} already drained)")
    return prompts


def _drain_flag():
    """Install the SIGUSR1 graceful-drain handler (module docstring).
    The handler only flips the flag; serving loops act on it at their
    next iteration boundary, so a signal never tears engine state."""
    import signal

    drain = {"requested": False}

    def _on_drain(signum, frame):
        drain["requested"] = True

    try:
        signal.signal(signal.SIGUSR1, _on_drain)
    except ValueError:
        pass                           # not the main thread (tests)
    return drain


def _reload_flag():
    """Install the SIGHUP live-reload handler (module docstring): the
    handler only flips the flag; the router serving loop runs the
    rollout at its next iteration boundary, never mid-step."""
    import signal

    reload_ = {"requested": False}

    def _on_reload(signum, frame):
        reload_["requested"] = True

    try:
        signal.signal(signal.SIGHUP, _on_reload)
    except (ValueError, AttributeError):
        pass                           # not the main thread / no SIGHUP
    return reload_


def _run_rollout(args, router, fab):
    """One SIGHUP-triggered rolling update over the live router: load
    the ``--rollout`` candidate (manifest-verified), mint the canary
    oracle greedy off-traffic on a reference engine holding it, then
    walk the fleet CANARY → DRAIN → SWAP → READMIT. On a COMPLETED
    walk the candidate re-publishes atomically to ``--weights`` — the
    commit point a supervised restart converges from."""
    from chainermn_torch.fleet import RolloutController
    from chainermn_torch.serving import publish_weights
    from chainermn_torch.serving.weights import WeightsError

    try:
        v2, src = load_state(args.rollout, fab.model)
    except WeightsError as e:
        _log(f"rollout: candidate {args.rollout} refused ({e}); "
             "fleet untouched")
        return None
    version = os.path.basename(os.path.normpath(args.rollout))
    _log(f"rollout: candidate {version} verified from {src}")

    # the pinned canary prompt set: the first requests of the
    # deterministic batch, replayed GREEDY under fixed seeds
    rng = np.random.RandomState(args.seed)
    can_p = []
    for i in range(min(2, args.requests)):
        prompt = rng.randint(0, args.vocab,
                             (args.prompt_len,)).astype(np.int32)
        can_p.append((prompt.tolist(), args.seed + i,
                      args.max_new_tokens))
    oracle_eng = fab.make(v2, version)
    oreqs = [oracle_eng.submit(np.asarray(p, np.int32),
                               max_new_tokens=n, seed=s)
             for p, s, n in can_p]
    oracle_eng.run_until_drained()
    can_o = [list(r.tokens) for r in oreqs]

    rc = RolloutController(router, fab.make, like=fab.params)
    out = rc.rollout(v2, version, canary_prompts=can_p,
                     canary_oracle=can_o, from_version="v1")
    _log("rollout: " + json.dumps(
        {k: out[k] for k in ("status", "version", "swapped", "crashed",
                             "rolled_back", "reason")}, sort_keys=True))
    if out["status"] == "completed" and args.weights:
        publish_weights(v2, args.weights, weights_version=version)
        _log(f"rollout: published {version} to {args.weights}")
    return out


def serve(args):
    from chainermn_torch.fleet import DisaggregatedFleet, FleetReport, Router
    from chainermn_torch.serving import DeadlineExceeded

    if args.hosts:
        return serve_hosts(args)

    engine = _engine_factory(args)
    prompts = _pending_prompts(args)
    report = FleetReport()
    drain = _drain_flag()
    reload_ = _reload_flag()
    shed = False
    rolled = False
    kw = dict(max_new_tokens=args.max_new_tokens,
              temperature=args.temperature, top_k=args.top_k)

    if args.disaggregate:
        fleet = DisaggregatedFleet(engine(), engine(),
                                   wire_format=args.wire_format,
                                   report=report,
                                   async_conveyor=args.async_conveyor,
                                   streamed=args.streamed)
        streams = {i: fleet.submit(p, seed=args.seed + i, **kw)
                   for i, p in emit_order(prompts)}
        with open(args.out, "a") as out:
            emitted = set()
            while not fleet.idle():
                if drain["requested"] and not shed:
                    shed = True
                    _log("SIGUSR1: drain — finishing in-flight sessions")
                # each engine step syncs internally (int32 token pulls)
                fleet.step()  # dlint: disable=DL104
                for i, s in streams.items():
                    if s.finished and i not in emitted:
                        emitted.add(i)
                        _emit(out, i, prompts[i], s.tokens,
                              reason=s.fallback_reason)
        fleet.close()
        summary = fleet.summary()
    else:
        # a rollout's canary traces on the serving thread; co-located
        # worker heartbeats starve under the GIL, so give health a
        # compile-sized timeout when a live reload is on the table
        with Router([engine() for _ in range(args.replicas)],
                    max_queue_depth=args.max_queue_depth,
                    health_timeout_ms=(600_000 if args.rollout
                                       else None),
                    report=report) as router:
            futs = {i: router.submit(p, seed=args.seed + i, **kw)
                    for i, p in emit_order(prompts)}
            pending = dict(futs)
            with open(args.out, "a") as out:
                while pending:
                    if reload_["requested"] and not rolled:
                        reload_["requested"] = False
                        rolled = True
                        if args.rollout:
                            _run_rollout(args, router, engine)
                        else:
                            _log("SIGHUP ignored: no --rollout "
                                 "candidate named")
                    if drain["requested"] and not shed:
                        shed = True
                        n = router.shed_pending()
                        _log(f"SIGUSR1: drain — shed {n} queued "
                             "request(s), finishing in-flight streams")
                    for i in sorted(pending):
                        fut = pending[i]
                        if fut.cancelled():
                            del pending[i]   # shed: next incarnation's
                            continue         # replay re-submits it
                        try:
                            req = router.result(fut, timeout_ms=100)
                        except DeadlineExceeded:
                            continue     # still decoding; poll the rest
                        del pending[i]
                        _emit(out, i, prompts[i], req.tokens)
            summary = router.summary()

    _log(("drained (SIGUSR1 retirement); " if shed else "drained; ")
         + f"fleet report: {json.dumps(summary, sort_keys=True)}")
    if args.report:
        with open(args.report, "w") as f:
            f.write(json.dumps(summary, sort_keys=True))
    return None


#: control channel for the dynamic-ownership protocol (``--hosts``):
#: a prefill host announces ``{"kind": "expect", "sid": i}`` to the
#: decode host it picked BEFORE shipping data frames, and sends one
#: ``{"kind": "eof"}`` per decode host when its batch is drained.
#: Control frames have no ack of their own, and a socket plane loses a
#: frame sent to a peer that is not listening yet; so every decode host
#: announces ``{"kind": "ready"}`` to each prefill host (again every
#: :data:`READY_EVERY_S` until that host's eof, which also covers a
#: restarted prefill host), and a prefill host sends nothing before it
#: has heard ``ready`` from every decode host.
CTRL_TAG = 7003
READY_EVERY_S = 0.25


def _await_ready(plane, peers, deadline):
    """Block (bounded by ``deadline``) until every rank in ``peers`` has
    announced ``ready`` on :data:`CTRL_TAG`."""
    waiting = set(peers)
    while waiting:
        if time.monotonic() > deadline:
            raise RuntimeError(f"decode host(s) {sorted(waiting)} never "
                               "announced ready")
        for r in sorted(waiting):
            try:
                msg = plane.try_recv_obj(r, tag=CTRL_TAG, timeout_ms=20)
            except TimeoutError:
                continue
            if isinstance(msg, dict) and msg.get("kind") == "ready":
                waiting.discard(r)


def _parse_endpoints(spec, n):
    """``host:port,host:port,...`` — one endpoint per rank. A bare
    ``:port`` binds/dials 127.0.0.1."""
    eps = []
    for part in spec.split(","):
        host, _, port = part.strip().rpartition(":")
        try:
            eps.append((host or "127.0.0.1", int(port)))
        except ValueError:
            raise SystemExit(f"bad --endpoints entry {part!r} "
                             "(want host:port)")
    if len(eps) != n:
        raise SystemExit(f"--endpoints names {len(eps)} endpoints "
                         f"for --hosts {n}")
    return eps


def _make_plane(args, rank, n):
    """The object-plane wire for ``--hosts`` mode: file-backed (``fs``,
    restart-tolerant by construction) or real TCP (``socket``, restart
    fencing via incarnation handshake + seq HWM)."""
    if args.transport == "socket":
        if not args.endpoints:
            raise SystemExit("--transport socket needs --endpoints")
        from chainermn_torch.comm.socket_plane import SocketObjectPlane
        return SocketObjectPlane(_parse_endpoints(args.endpoints, n),
                                 rank)
    if not args.plane_dir:
        raise SystemExit("--hosts needs --plane-dir (the shared wire)")
    from chainermn_torch.comm.object_plane import FsObjectPlane
    return FsObjectPlane(args.plane_dir, rank, n)


def serve_hosts(args):
    """One host of a REAL cross-process disaggregated fleet (m×n).

    Ranks 0..P-1 prefill; ranks P..N-1 decode. Any prefill host can
    feed any decode host: each ready handoff goes to the decode host
    with the fewest streams shipped to it so far, skipping hosts whose
    last send failed until they deliver again (the saturated-survivor
    precheck). Ownership is announced with an ``expect`` control frame
    on :data:`CTRL_TAG` before the data frames fly, so the receiving
    host can build the stream and start its arrival deadline; an
    ``eof`` per prefill rank closes the protocol. Decode hosts adopt
    (or, past ``--handoff-deadline-s``, fence + fall back to a clean
    re-prefill from seed) and append finished streams to their own
    per-incarnation part file. With ``--streamed`` the data frames are
    format-5 per-layer chunks + a closing manifest, reassembled by
    ``StreamAssembler`` — a chunk that misses its delivery budget
    fails assembly and re-prefills cleanly.

    The ``fs`` wire survives a SIGKILLed rank by construction (a
    process group's store cannot re-admit one — the whole point
    of this mode is surviving exactly that under the supervisor); the
    ``socket`` wire survives it via the reborn peer's incarnation
    handshake. After a prefill restart, a re-announced stream may pick
    a DIFFERENT decode host than the dead incarnation did; with one
    decode host (the drill topology) that is moot, with several the
    seeded replay keeps every emission bitwise and ``_done_ids``'s
    merge keeps the final JSONL idempotent.
    """
    from chainermn_torch.fleet import FleetReport
    from chainermn_torch.fleet.handoff import (HANDOFF_FORMAT_STREAMED,
                                             HandoffError, decode_handoff,
                                             decode_handoff_streamed,
                                             encode_handoff,
                                             encode_handoff_streamed,
                                             streamed_chunk_sid,
                                             streamed_wire_bytes)
    from chainermn_torch.fleet.pools import (DecodePool, PrefillPool,
                                           Stream, StreamAssembler)
    from chainermn_torch.fleet.transport import ObjectPlaneTransport
    from chainermn_torch.resilience import chaos
    from chainermn_torch.resilience.supervisor import restart_count

    if args.hosts < 2:
        raise SystemExit("--hosts needs at least 2 (1 prefill + 1 decode)")
    if not (0 <= args.host_rank < args.hosts):
        raise SystemExit(f"--host-rank {args.host_rank} outside "
                         f"[0, {args.hosts})")
    rank, n, P = args.host_rank, args.hosts, args.prefill_hosts
    if not (1 <= P < n):
        raise SystemExit(f"--prefill-hosts {P} outside [1, {n})")
    plane = _make_plane(args, rank, n)
    engine = _engine_factory(args)()
    prompts = _pending_prompts(args)
    report = FleetReport()
    drain = _drain_flag()              # SIGUSR1: finish in flight, exit 0
    kw = dict(temperature=args.temperature, top_k=args.top_k)
    budget_s = args.handoff_deadline_s + 120.0   # hard stop for any loop
    decode_ranks = list(range(P, n))

    def _ship(transport, sid, handoff):
        """Encode + send one handoff; returns the terminal status (the
        closing frame's, in streamed mode — a chunk that exhausts its
        budget is caught by the receiver's assembly check instead)."""
        if not args.streamed:
            manifest, blob = encode_handoff(handoff, args.wire_format)
            report.record_handoff(args.wire_format, len(blob))
            return transport.send(sid, manifest, blob)
        chunks, closing, closing_blob = encode_handoff_streamed(
            handoff, args.wire_format)
        report.record_handoff(args.wire_format,
                              streamed_wire_bytes(closing))
        for ci, (man, blob) in enumerate(chunks):
            transport.send(streamed_chunk_sid(sid, ci), man, blob)
        return transport.send(sid, closing, closing_blob)

    if rank < P:
        pool = PrefillPool(engine)
        transports = {r: ObjectPlaneTransport(plane, peer=r)
                      for r in decode_ranks}
        mine = {i: p for i, p in prompts.items() if i % P == rank}
        for i, p in emit_order(mine):
            pool.submit(Stream(i, p, args.max_new_tokens,
                               dict(kw, seed=args.seed + i)))
        shipped = {r: 0 for r in decode_ranks}
        suspect = set()                # last send failed: prefer others
        deadline = time.monotonic() + budget_s
        _await_ready(plane, decode_ranks, deadline)
        it = 0
        while not engine.idle() or engine.held:
            if drain.pop("requested", None):
                _log("SIGUSR1: drain — finishing in-flight prefills")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"prefill host failed to drain within {budget_s}s")
            # the drill's kill@step= SIGKILL lands here — between
            # engine steps, possibly with frames already in flight
            chaos.on_step(it)
            it += 1
            # export/encode below pulls every ready slot's pages to
            # host (np.asarray) — that IS the per-iteration sync
            pool.step()  # dlint: disable=DL104
            for stream, req in pool.ready():
                sid = stream.stream_id
                dest = min(decode_ranks,
                           key=lambda r: (r in suspect, shipped[r], r))
                plane.send_obj({"kind": "expect", "sid": sid}, dest,
                               tag=CTRL_TAG)
                status = _ship(transports[dest], sid, pool.export(req))
                shipped[dest] += 1
                if status == "failed":
                    report.record_fallback()
                    suspect.add(dest)
                    why = transports[dest].last_send_defects
                    _log(f"handoff stream={sid} -> h{dest}: failed "
                         f"({'; '.join(why) or 'no defect history'})")
                else:
                    suspect.discard(dest)
                    _log(f"handoff stream={sid} -> h{dest}: {status}")
                pool.release(req, aborted=(status == "failed"))
        for r in decode_ranks:
            plane.send_obj({"kind": "eof"}, r, tag=CTRL_TAG)
        for t in transports.values():
            report.record_transport(sender_stats=t.stats)
        report.record_transport(plane_stats=getattr(plane, "stats", {}))
        summary = report.summary([engine.report])
    else:
        pool = DecodePool(engine)
        transports = {r: ObjectPlaneTransport(plane, peer=r)
                      for r in range(P)}
        asm = StreamAssembler()
        streams = {}                   # sid → Stream (built on expect)
        src_of = {}                    # sid → announcing prefill rank
        expected, placed, emitted, eofs = set(), set(), set(), set()
        backlog = []
        part = f"{args.out}.h{rank}.r{restart_count()}"
        arrive_by = time.monotonic() + args.handoff_deadline_s
        deadline = time.monotonic() + budget_s

        def _fallback(sid, reason):
            report.record_fallback()
            pool.fallback(streams[sid], reason)
            placed.add(sid)

        announced = 0.0
        with open(part, "a") as out:
            while len(eofs) < P or len(emitted) < len(expected):
                if time.monotonic() - announced >= READY_EVERY_S:
                    announced = time.monotonic()
                    for pr in range(P):
                        if pr not in eofs:
                            plane.send_obj({"kind": "ready"}, pr,
                                           tag=CTRL_TAG)
                if drain.pop("requested", None):
                    _log("SIGUSR1: drain — finishing in-flight decodes")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"decode host {rank} failed to drain within "
                        f"{budget_s}s ({len(emitted)}/{len(expected)} "
                        f"expected, eof {len(eofs)}/{P})")
                for pr in range(P):
                    while True:
                        try:
                            msg = plane.try_recv_obj(pr, tag=CTRL_TAG,
                                                     timeout_ms=1)
                        except TimeoutError:
                            break
                        if msg.get("kind") == "eof":
                            eofs.add(pr)
                        elif msg.get("kind") == "expect":
                            sid = int(msg["sid"])
                            if sid in expected or sid not in prompts:
                                continue   # replay of a drained stream
                            expected.add(sid)
                            src_of[sid] = pr
                            streams[sid] = Stream(
                                sid, prompts[sid], args.max_new_tokens,
                                dict(kw, seed=args.seed + sid))
                for t in transports.values():
                    backlog.extend(t.poll(timeout_ms=10))
                still = []
                for arr in backlog:
                    if arr.stream_id < 0:
                        asm.add_chunk(arr)     # format-5 chunk frame
                        continue
                    sid = arr.stream_id
                    if sid in placed:
                        continue
                    if sid not in streams:
                        # data outran its expect frame (separate
                        # channel): hold until the announcement lands
                        still.append(arr)
                        continue
                    if arr.failed:
                        _, notes = asm.take(sid)
                        why = "; ".join(arr.defects) or "delivery failed"
                        if notes:
                            why += " [" + "; ".join(notes) + "]"
                        _fallback(sid, why)
                        continue
                    if not pool.has_room():
                        still.append(arr)   # adopted frame waits for room
                        continue
                    notes = []
                    try:
                        man = arr.manifest
                        if (isinstance(man, dict) and man.get("format")
                                == HANDOFF_FORMAT_STREAMED):
                            chunks, notes = asm.take(sid)
                            handoff = decode_handoff_streamed(
                                man, arr.blob, chunks)
                        else:
                            handoff = decode_handoff(man, arr.blob)
                        pool.place(streams[sid], handoff)
                        placed.add(sid)
                    except HandoffError as e:
                        # attach the per-chunk defect history: the
                        # fallback log says WHY the wire failed
                        why = str(e)
                        if notes:
                            why += " [" + "; ".join(notes) + "]"
                        _fallback(sid, why)
                backlog = still
                if time.monotonic() > arrive_by:
                    for sid in sorted(expected - placed):
                        # never arrived: fence the stream (a late frame
                        # now acks duplicate) and re-prefill from seed
                        transports[src_of[sid]].resolve(sid)
                        _fallback(sid, "missed the handoff deadline")
                        _log(f"stream {sid} missed the handoff "
                             f"deadline; fenced + re-prefilled")
                pool.step()
                for sid, s in streams.items():
                    if s.finished and sid not in emitted:
                        emitted.add(sid)
                        _emit(out, sid, prompts[sid], s.tokens,
                              reason=s.fallback_reason)
        for t in transports.values():
            report.record_transport(receiver_stats=t.receiver_stats)
        report.record_transport(plane_stats=getattr(plane, "stats", {}))
        summary = report.summary([engine.report])

    if hasattr(plane, "close"):
        plane.close()
    _log(f"host {rank} drained; report: "
         f"{json.dumps(summary, sort_keys=True)}")
    if args.report:
        wire = {"fleet": report.to_wire(),
                "serving": [engine.report.to_wire()]}
        with open(f"{args.report}.h{rank}", "w") as f:
            f.write(json.dumps(wire, sort_keys=True))
    return None


def emit_order(prompts):
    return sorted(prompts.items())


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="fleet_lm", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True,
                    help="JSONL of completed streams (append, idempotent)")
    ap.add_argument("--weights", default=None,
                    help="published-weights path: warm-load when present, "
                         "publish on cold boot")
    ap.add_argument("--report", default=None,
                    help="write the merged FleetReport JSON here on drain")
    ap.add_argument("--replicas", type=int, default=2,
                    help="engine replicas behind the router")
    ap.add_argument("--disaggregate", action="store_true",
                    help="prefill/decode pools + KVHandoff instead of "
                         "the replicated router")
    ap.add_argument("--wire-format", default="f32",
                    choices=["f32", "int8-block"],
                    help="KVHandoff wire format (disaggregated mode)")
    ap.add_argument("--async-conveyor", action="store_true",
                    help="overlap handoff transfer with decode steps "
                         "(disaggregated mode, bounded worker queue)")
    ap.add_argument("--streamed", action="store_true",
                    help="ship handoffs as format-5 per-layer chunk "
                         "frames + a closing manifest (per-chunk "
                         "SHA/NACK/re-send granularity)")
    ap.add_argument("--hosts", type=int, default=0,
                    help="cross-PROCESS disaggregation over N hosts "
                         "(this process is one of them; see --host-rank)")
    ap.add_argument("--host-rank", type=int, default=0,
                    help="this process's rank in --hosts mode "
                         "(0..P-1 = prefill hosts, P..N-1 = decode "
                         "hosts; see --prefill-hosts)")
    ap.add_argument("--prefill-hosts", type=int, default=1,
                    help="P prefill ranks in --hosts mode: any prefill "
                         "host feeds any decode host (least-outstanding "
                         "destination choice)")
    ap.add_argument("--transport", default="fs",
                    choices=["fs", "socket"],
                    help="--hosts wire: 'fs' = on-disk FsObjectPlane "
                         "under --plane-dir; 'socket' = TCP "
                         "SocketObjectPlane over --endpoints")
    ap.add_argument("--endpoints", default=None,
                    help="comma list of host:port, one per rank "
                         "(--transport socket)")
    ap.add_argument("--plane-dir", default=None,
                    help="shared directory backing the FsObjectPlane "
                         "wire (--hosts mode, --transport fs)")
    ap.add_argument("--handoff-deadline-s", type=float, default=30.0,
                    help="decode-host budget for a stream's handoff to "
                         "arrive before fencing it and re-prefilling "
                         "from seed (--hosts mode)")
    ap.add_argument("--rollout", default=None,
                    help="published candidate-weights path for the "
                         "SIGHUP-triggered live rolling update "
                         "(router mode; see the signal contract)")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="per-replica admission bound (router mode)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--capacity", type=int, default=32)
    ap.add_argument("--decode-k", type=int, default=1,
                    help="tokens committed per decode dispatch")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill width (default: monolithic)")
    ap.add_argument("--temperature", type=float, default=None,
                    help="sampling temperature (default: greedy argmax)")
    ap.add_argument("--top-k", type=int, default=None,
                    help="top-k truncation for sampled decode")
    ap.add_argument("--vocab", type=int, default=43)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=None,
                    help="feed-forward width (default: 2 x --d-model)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="model and page dtype")
    ap.add_argument("--attention", default="reference",
                    choices=["reference", "flash"],
                    help="attention of the served model (flash runs the "
                         "port's flash kernel on the card)")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default cuda; cpu only "
                         "when asked)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from chainermn_torch.resilience.supervisor import main_exit_code

    return main_exit_code(lambda: serve(args))


if __name__ == "__main__":
    sys.exit(main())
