#!/usr/bin/env python
"""schedtune: search the collective-schedule knob space, print the chosen
schedule and its overlap fraction, and write the winner into the
per-topology profile DB.

Counterpart of the JAX package's ``tools/schedtune.py``, with its flags,
its output JSON and its exit behaviour. The search
(:mod:`chainermn_torch.tuning`) sweeps bucket_bytes, bucket emission
order, double-buffering (only with --allow-stale), reducer strategy and
the synthesized programs. Two schedule sources:

* default: the canned scheduled-HLO emulator, scored by the DL201/DL203
  parsers and the multi-tier Topology cost model. Deterministic, runs
  anywhere. A measured sweep stored in the DB for the topology
  (``measure_strategies(db=...)``) replaces the modeled prices;
* ``--trace``: on N ≥ 2 CUDA ranks over NCCL, each candidate runs warmed
  data-parallel steps of the model JAX's ``--aot`` compiles (three
  ``Linear(4096)`` and a ``Linear(10)`` on 28×28 inputs, batch 64 a rank,
  SGD) under ``torch.profiler``. Before each measured step every rank
  synchronizes its card and meets the others at a host barrier (the
  store's, which launches no NCCL kernel), so the ranks enter the
  reductions together. A candidate is measured 5 times, each time over
  ``--steps`` steps (4 by default, after 5 warm ones): a sample is the
  NCCL time per step of the rank whose NCCL kernels took least. The
  median sample replaces the modeled NCCL time, the overlap fraction
  (the share of NCCL kernel time that ran concurrently with compute
  kernels) is the median of the repeats', and the plan's ``source`` is
  ``"trace"``. A candidate is ordered before the least median only
  where their spreads (the samples' interquartile ranges) do not
  overlap: of the candidates whose spread overlaps the leader's, the one
  the canned search ranks first wins. When every candidate ties so, the
  trace decided nothing: the plan is the canned pick and its ``source``
  is ``"canned"``. Without ``RANK`` in the environment it starts
  ``--ranks`` processes itself (default: every visible GPU); ``--intra``
  factors the ranks into tiers. It refuses a CPU or one-rank world.

``--aot`` has no counterpart: the port compiles no HLO. It refuses and
names ``--trace``.

Usage::

  python -m chainermn_torch.tools.schedtune [--grad-bytes N] [--db PATH]
      [--model-key K] [--intra N] [--inter N] [--lossy] [--allow-stale]
      [--no-write] [--device cpu]
  python -m chainermn_torch.tools.schedtune --trace [--ranks N]
      [--intra N] [--steps N] [--lossy] [--db PATH] [--no-write]

Prints one JSON line (rank 0 under ``--trace``): the chosen plan, the
untuned-default score row, and the full candidate table (under
``--trace`` each row also holds its ``samples_us``, its
``score_spread`` and its ``tie_set``, and the line the leader's
``tie_set`` and ``decided_by_trace``). Exit 0 (a tuner that found no
improvement still found the answer). A run whose winner strictly beats
the default's overlap fraction sets ``"improves_overlap": true``.
Without ``--intra``/``--inter`` the canned search describes the local
communicator (``--device``, ``cuda`` unless ``cpu`` is asked for).
"""

import json
import math
import os
import statistics
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

#: ResNet-50 bf16 grads ≈ 51 MiB — 13 buckets at the 4 MiB default, a
#: representative payload for the canned search
DEFAULT_GRAD_BYTES = 51 << 20
#: the traced model's input and per-rank batch (JAX's --aot step)
TRACE_BATCH, TRACE_IMAGE = 64, 28
#: warm-up steps before a candidate's traced steps
TRACE_WARMUP = 5
#: measurements of each candidate under --trace, and steps in each
TRACE_REPEATS, TRACE_STEPS = 5, 4


def _flag(argv, name, default=None, has_value=True):
    for a in list(argv):
        if a == name and not has_value:
            argv.remove(a)
            return True
        if a == name and has_value:
            i = argv.index(a)
            argv.pop(i)
            return argv.pop(i)
        if has_value and a.startswith(name + "="):
            argv.remove(a)
            return a.split("=", 1)[1]
    return default


def trace_model(device):
    """JAX's ``--aot`` model (``Big``): three ``Dense(4096)`` with ReLU and
    a ``Dense(10)`` on flattened 28×28 inputs (~36.8M parameters)."""
    import torch
    from torch import nn

    layers, width = [nn.Flatten()], TRACE_IMAGE * TRACE_IMAGE
    for _ in range(3):
        layers += [nn.Linear(width, 4096), nn.ReLU()]
        width = 4096
    layers.append(nn.Linear(width, 10))
    torch.manual_seed(0)
    return nn.Sequential(*layers).to(device)


def _trace_compile_fn(comm, model, steps: int, repeats: int):
    """A ``compile_fn`` that measures each candidate ``repeats`` times,
    each time over ``steps`` traced data-parallel steps of ``model``
    (after :data:`TRACE_WARMUP` warm ones; a card sync and a host barrier
    before every step), and returns the
    :class:`~chainermn_torch.tuning.TraceEvidence` of the samples: each
    the NCCL time a step of the rank whose NCCL kernels took least (every
    rank calls it in the same order). Reducers are built once per
    (strategy, wire, program) and re-knobbed per candidate, so the
    sub-communicators of a structure are made once."""
    import torch

    from chainermn_torch.collectives import make_grad_reducer
    from chainermn_torch.optimizers import create_multi_node_optimizer
    from chainermn_torch.training import (classifier_loss,
                                          make_data_parallel_train_step)
    from chainermn_torch.training.profiling import (capture, kernel_events,
                                                    nccl_overlap)
    from chainermn_torch.tuning import TraceEvidence

    g = torch.Generator(device=comm.device).manual_seed(comm.rank)
    x = torch.rand(TRACE_BATCH, TRACE_IMAGE, TRACE_IMAGE, generator=g,
                   device=comm.device)
    y = torch.randint(0, 10, (TRACE_BATCH,), generator=g,
                      device=comm.device)
    reducers = {}

    def compile_fn(cand):
        key = (cand.strategy, cand.wire_format,
               None if cand.program is None else cand.program.name)
        red = reducers.get(key)
        if red is None:
            extra = {}
            if cand.program is not None:
                extra["program"] = cand.program
            red = reducers[key] = make_grad_reducer(
                cand.strategy, comm, bucket_bytes=cand.bucket_bytes,
                bucket_order=cand.bucket_order,
                wire_format=(cand.wire_format
                             if cand.wire_format != "f32" else None),
                **extra)
        red.bucket_bytes = cand.bucket_bytes
        red.bucket_order = cand.bucket_order
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=0.1), comm,
            grad_reducer=red, double_buffering=cand.double_buffering)
        step = make_data_parallel_train_step(model, opt, comm,
                                             loss_fn=classifier_loss)
        for _ in range(TRACE_WARMUP):
            # dlint: disable=DL104 — warm-up, synced after it
            step(x, y)
        torch.cuda.synchronize(comm.device)
        comm.barrier()
        samples, fracs = [], []
        for _ in range(repeats):
            with capture(comm.device) as rec:
                for _ in range(steps):
                    # the ranks enter each step's reductions together
                    torch.cuda.synchronize(comm.device)
                    comm.host_barrier()
                    step(x, y)
            frac, nccl_us = nccl_overlap(kernel_events(rec["trace"]))
            # an NCCL kernel also spins while its peers catch up: the
            # rank whose kernels waited least shows the transfer, so
            # every rank takes that rank's sample
            us, frac = min(comm.allgather_obj((nccl_us / steps, frac)))
            samples.append(us)
            fracs.append(frac)
        return TraceEvidence(overlap_fraction=statistics.median(fracs),
                             comm_us=statistics.median(samples),
                             samples=tuple(samples))

    return compile_fn


def _spawn(ranks: int) -> int:
    """Start ``ranks`` copies of this command as one localhost world."""
    import socket
    import subprocess

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "chainermn_torch.tools.schedtune",
         *sys.argv[1:]],
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(ranks),
                 LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(ranks),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
        for r in range(ranks)]
    return max(p.wait() for p in procs)


def _trace(intra, steps, lossy, allow_stale, model_key):
    """The ``--trace`` search on this rank; returns ``(result, grad_bytes,
    rank)``."""
    import torch

    from chainermn_torch.comm import create_communicator
    from chainermn_torch.tuning import Topology, tune

    comm = create_communicator("pure_nccl")
    try:
        if comm.device.type != "cuda" or comm.size < 2:
            raise SystemExit(
                f"--trace measures NCCL on N >= 2 CUDA ranks; this world "
                f"has {comm.size} rank(s) on {comm.device.type}")
        topology = Topology.from_comm(
            comm, intra=int(intra) if intra else None)
        model = trace_model(comm.device)
        total = sum(p.numel() * p.element_size()
                    for p in model.parameters())
        result = tune(topology, total,
                      _trace_compile_fn(comm, model, steps, TRACE_REPEATS),
                      lossy=lossy, allow_stale=allow_stale,
                      model_key=model_key, source="trace")
        torch.cuda.synchronize(comm.device)
        return result, total, comm.rank
    finally:
        comm.finalize()


def main():
    argv = sys.argv[1:]
    grad_bytes = int(_flag(argv, "--grad-bytes", DEFAULT_GRAD_BYTES))
    db_path = _flag(argv, "--db")
    model_key = _flag(argv, "--model-key", "default")
    intra = _flag(argv, "--intra")
    inter = _flag(argv, "--inter")
    device = _flag(argv, "--device")
    ranks = _flag(argv, "--ranks")
    steps = int(_flag(argv, "--steps", TRACE_STEPS))
    lossy = bool(_flag(argv, "--lossy", False, has_value=False))
    allow_stale = bool(_flag(argv, "--allow-stale", False,
                             has_value=False))
    no_write = bool(_flag(argv, "--no-write", False, has_value=False))
    trace = bool(_flag(argv, "--trace", False, has_value=False))
    for a in list(argv):  # --aot is optionally valued: --aot[=NAME]
        if a == "--aot" or a.startswith("--aot="):
            raise NotImplementedError(
                "--aot does not apply: the port compiles no HLO; measure "
                "the real step's schedule on CUDA ranks with --trace")
    if argv:
        raise SystemExit(f"unknown arguments: {argv} (see module doc)")

    from chainermn_torch.tuning import ProfileDB, tune_canned, two_tier

    source = "canned"
    if trace:
        if "RANK" not in os.environ:
            import torch

            n = int(ranks) if ranks else torch.cuda.device_count()
            if n < 2:
                raise SystemExit(f"--trace needs N >= 2 CUDA ranks; "
                                 f"{n} GPU(s) visible")
            raise SystemExit(_spawn(n))
        result, grad_bytes, rank = _trace(intra, steps, lossy, allow_stale,
                                          model_key)
        source = "trace"
        if rank != 0:
            return
    else:
        if intra or inter:
            topology = two_tier(int(intra or 8), int(inter or 1))
        else:
            # describe the local communicator
            from chainermn_torch.comm import create_communicator
            from chainermn_torch.tuning import Topology

            comm = create_communicator("pure_nccl", device=device)
            try:
                topology = Topology.from_comm(comm)
            finally:
                comm.finalize()
        db_probe = ProfileDB(db_path)
        measured = db_probe.measured_for(topology) or None
        result = tune_canned(topology, grad_bytes, lossy=lossy,
                             allow_stale=allow_stale, model_key=model_key,
                             measured=measured)

    plan = result.plan
    db = ProfileDB(db_path)
    written = None
    if not no_write:
        db.put_plan(plan)
        written = db.save()

    k = max(1, math.ceil(grad_bytes / plan.bucket_bytes))
    print(f"chosen schedule  : {plan.strategy} bucket_bytes="
          f"{plan.bucket_bytes:,} ({k} buckets) order={plan.bucket_order}"
          f"{' wire=' + plan.wire_format if plan.wire_format != 'f32' else ''}"
          f"{' +double_buffering' if plan.double_buffering else ''}",
          file=sys.stderr)
    print(f"overlap fraction : {plan.overlap_fraction:.4f} (default "
          f"flat: {result.default['overlap_fraction']:.4f})",
          file=sys.stderr)
    line = {
        "ok": True,
        "source": source,
        "topology": plan.fingerprint,
        "grad_bytes": grad_bytes,
        "chosen": plan.to_dict(),
        "default": result.default,
        "improves_overlap": result.improves_overlap,
        "n_candidates": len(result.rows),
        "candidates": result.rows,
        "db": written,
    }
    if source == "trace":
        line["tie_set"] = result.tie_set
        line["decided_by_trace"] = result.decided
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
