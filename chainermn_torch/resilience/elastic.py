"""Shrink-to-fit resume: continue on a smaller world when a host is
permanently gone.

Counterpart of ``chainermn_tpu/resilience/elastic.py``, on the port's
checkpointer (``maybe_load(allow_incomplete=True)``) and its reshard
path (``checkpointing/reshard.py``). The consensus election and restart
loop assume the SAME world size comes back; when a host (and its disk)
is gone for good, that never happens — yet the surviving ranks still
hold (or ring-hold, see ``resilience/replica.py``) every byte of state
needed to continue:

1. :func:`plan_elastic_resume` — elect the newest iteration the
   CURRENT (smaller) world can recover, compare against the saved world
   size recorded in each snapshot (``__world__``), and decide:
   ``resume`` (same world), ``shrink`` (fewer ranks than saved —
   re-splice), ``reshard`` (another mesh — the manifest-driven path) or
   ``give_up`` (nothing recoverable).
2. :func:`elastic_resume` — execute the plan: load the state through the
   checkpointer's splice path (``allow_incomplete=True`` bypasses the
   complete-file-set gate; the per-leaf coverage check still rejects a
   genuinely missing shard), then rebalance the HOST side — re-scatter
   the dataset over the surviving ranks and reposition the iterator.

The port's inventory is stricter than the JAX package's in one case.
JAX's counts any iteration with one valid file in view, so when the
survivors of a killed rank wrote emergency snapshots at the kill's
iteration, it elects that iteration, and a state with sharded leaves
then fails to load (the dead rank's shard was never written). Here an
iteration counts when this rank can read a complete file set of it
(primaries or replicas of every saving rank), or a valid file whose
manifest shows only whole leaves (any one file restores a replicated
state). On file sets that restore, both plans agree.

What shrinking preserves: device state — exact (whole leaves load from
any file, sharded leaves are spliced from all surviving files); the
iteration count — exact; the data order — approximate (per-rank shards
are re-split for the new world); averaging — automatic for steps that
average over the live communicator (``allreduce_grad(op="mean")``),
while a step that baked the OLD world size into a constant must multiply
by :attr:`ElasticPlan.averaging_rescale`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
import os
import re
from typing import Any, Dict, List, Optional

__all__ = ["ElasticPlan", "ElasticResumeError", "ElasticTopologyError",
           "elastic_resume", "plan_elastic_resume"]


class ElasticResumeError(RuntimeError):
    """Elastic resume cannot proceed (nothing recoverable)."""


class ElasticTopologyError(ElasticResumeError):
    """The mesh topology does not support elastic resharding.

    Retained for compatibility: since the manifest-driven reshard path
    (checkpointing/reshard.py) landed, multi-axis meshes plan as
    ``action="reshard"`` instead of raising this."""


@dataclass
class ElasticPlan:
    """The decision :func:`plan_elastic_resume` reached.

    ``action`` is ``resume`` / ``shrink`` / ``reshard`` / ``give_up``;
    ``averaging_rescale`` is ``saved_world / new_world`` — multiply
    into any loss/grad normalization that baked in the OLD world size
    (steps averaging through the live communicator need no fix).
    ``saved_axes``/``new_axes`` carry the mesh axis→size maps for
    ``reshard`` plans (from the coverage manifest and the live mesh;
    None when unknowable)."""

    action: str
    iteration: Optional[int]
    saved_world: Optional[int]
    new_world: int
    reason: str
    averaging_rescale: float = 1.0
    saved_axes: Optional[Dict[str, int]] = field(default=None)
    new_axes: Optional[Dict[str, int]] = field(default=None)

    def describe(self) -> str:
        return (f"elastic plan: {self.action} at iteration "
                f"{self.iteration} (saved world {self.saved_world}, "
                f"current {self.new_world}) — {self.reason}")


def _axes_total(axes: Optional[Dict[str, int]]) -> Optional[int]:
    """Total device count spanned by an axis→size map (None when
    unknown)."""
    if not axes:
        return None
    n = 1
    for v in axes.values():
        n *= int(v)
    return n


_SNAP_RE = re.compile(r"snapshot_iter_(\d+)\.(\d+)$")


def _all_whole(fn: str) -> bool:
    """Does the manifest of snapshot file ``fn`` show only whole leaves
    (a replicated state, which any one file restores)? A file without a
    coverage map counts as whole (the JAX package's inventory)."""
    from chainermn_torch.extensions.checkpoint import read_manifest

    mf = read_manifest(fn) or {}
    leaves = mf.get("leaves")
    if not leaves:
        return True
    return all(int(v.get("nshards", 0)) == 0 for v in leaves.values())


def _recoverable_iters(ck) -> List[int]:
    """Iterations THIS rank can restore on a smaller world: those whose
    file set it can read complete (primaries or replicas of every saving
    rank: ``_complete_iters_on_disk``), and those with a valid file in
    view (own primary, a peer's primary on shared storage, or a ring
    replica) whose leaves are all whole."""
    seen = set(ck._complete_iters_on_disk())
    for d in (ck.path, ck.replica_path):
        if not os.path.isdir(d):
            continue
        for f in os.listdir(d):
            m = _SNAP_RE.match(f)
            if not m or int(m.group(1)) in seen:
                continue
            fn = os.path.join(d, f)
            if (not os.path.isdir(fn) and ck._verify_snapshot_file(fn)
                    and _all_whole(fn)):
                seen.add(int(m.group(1)))
    return sorted(seen)


def plan_elastic_resume(ck) -> ElasticPlan:
    """Elect over the CURRENT world and classify the resume.

    Collective: every surviving process must call it (the inventory is
    allgathered). Never raises for "nothing found" — that returns a
    ``give_up`` plan so the caller can report and exit. A snapshot
    whose MESH differs from the current one (multi-axis reshape, tile
    re-layout) plans as ``action="reshard"`` — executed through the
    manifest-driven path in ``checkpointing/reshard.py``."""
    comm = ck.comm
    world = comm.size
    ck._drain()
    ck._pre_election_barrier()
    mine = _recoverable_iters(ck)
    all_lists = comm.allgather_obj(mine)
    common = set(all_lists[0])
    for lst in all_lists[1:]:
        common &= set(lst)
    if not common:
        return ElasticPlan(
            action="give_up", iteration=None, saved_world=None,
            new_world=world,
            reason="no snapshot iteration is recoverable on every "
                   "surviving process — nothing to resume from "
                   f"(per-rank inventories: {all_lists})")
    it = max(common)
    ck._elected = it  # pin against GC, same as the strict election
    saved = ck._saved_world(it)
    from chainermn_torch.checkpointing.reshard import mesh_axes, saved_axes

    cur_axes = mesh_axes(comm)
    sv_axes = saved_axes(ck, it)
    axes_changed = (sv_axes is not None and cur_axes is not None
                    and sv_axes != cur_axes)
    multi = len(tuple(getattr(comm, "axis_names", ()) or ())) > 1
    if axes_changed or (multi and saved is not None and saved != world):
        sv_n, cur_n = _axes_total(sv_axes), _axes_total(cur_axes)
        rescale = (sv_n / cur_n if sv_n and cur_n
                   else (saved / world if saved else 1.0))
        return ElasticPlan(
            action="reshard", iteration=it, saved_world=saved,
            new_world=world, averaging_rescale=rescale,
            saved_axes=sv_axes, new_axes=cur_axes,
            reason=f"snapshot mesh {sv_axes} differs from the current "
                   f"mesh {cur_axes} — re-splicing through the "
                   "manifest-driven reshard path "
                   "(checkpointing/reshard.py)")
    if saved is None or saved == world:
        return ElasticPlan(
            action="resume", iteration=it, saved_world=saved,
            new_world=world, saved_axes=sv_axes, new_axes=cur_axes,
            reason="saved world matches the current world"
                   if saved == world else
                   "saved world unknown (pre-marker snapshot) — "
                   "assuming shape-preserving resume")
    rescale = saved / world
    return ElasticPlan(
        action="shrink", iteration=it, saved_world=saved,
        new_world=world, averaging_rescale=rescale,
        saved_axes=sv_axes, new_axes=cur_axes,
        reason=f"snapshot was saved by {saved} process(es), "
               f"{world} survive — re-splicing shards onto the "
               "smaller mesh")


def _template(updater):
    """The restore template: the updater's state, with a sharded
    optimizer's ``state_dict(template=True)`` (an optimizer that has not
    stepped gets the state shapes a step would give, so every saved
    sharded leaf has a place to land)."""
    opt = getattr(updater, "optimizer", None)
    model = getattr(updater, "model", None)
    try:
        opt_sd = opt.state_dict(template=True)
    except TypeError:
        return updater.state
    return {"model": model.state_dict(), "optimizer": opt_sd}


def elastic_resume(ck, updater, global_dataset: Any = None,
                   shuffle: bool = False,
                   seed: Optional[int] = None) -> ElasticPlan:
    """Plan + execute: restore ``updater`` at the newest recoverable
    iteration on the current world size, rebalancing the host side.

    ``global_dataset`` is the FULL dataset (the thing originally passed
    to ``scatter_dataset``); when given, it is re-scattered over the
    surviving ranks and installed as the iterator's dataset — without
    it, the iterator keeps its existing (old-world) shard and only the
    position is rebalanced. The state loads in place (``updater.state =
    ...``). Returns the executed :class:`ElasticPlan`; raises
    :class:`ElasticResumeError` on a ``give_up`` plan."""
    plan = plan_elastic_resume(ck)
    if plan.action == "give_up":
        raise ElasticResumeError(plan.describe())
    resharder = None
    if plan.action == "reshard":
        from chainermn_torch.checkpointing.reshard import \
            default_leaf_resharder

        resharder = default_leaf_resharder
    allow_inc = (plan.action == "shrink"
                 or (plan.action == "reshard"
                     and plan.saved_world is not None
                     and plan.saved_world > plan.new_world))
    state, it = ck.maybe_load(_template(updater), iteration=plan.iteration,
                              allow_incomplete=allow_inc,
                              leaf_resharder=resharder)
    updater.state = state
    updater.iteration = it
    same_world = plan.saved_world in (None, plan.new_world)
    if plan.action == "resume" or (plan.action == "reshard"
                                   and same_world):
        # shape-preserving host side: exact restore
        host = ck.load_host_state(it)
        restore = getattr(updater, "load_host_state", None)
        if host is not None and callable(restore):
            restore(host)
        return plan
    _rebalance_host(ck, updater, plan, global_dataset, shuffle, seed)
    return plan


def _rebalance_host(ck, updater, plan: ElasticPlan, global_dataset,
                    shuffle, seed) -> None:
    """Shrink path: new data shard + approximate iterator position.

    The np RNG from the host state is restored when available (augment
    pipelines keep their stream); the iterator position is recomputed —
    the saved one indexes a shard that no longer exists."""
    host = ck.load_host_state(plan.iteration)
    if host is not None and host.get("np_random") is not None:
        import numpy as np

        np.random.set_state(host["np_random"])
    iterator = getattr(updater, "iterator", None)
    if iterator is None:
        return
    if global_dataset is not None:
        from chainermn_torch.datasets import scatter_dataset

        iterator.dataset = scatter_dataset(
            global_dataset, ck.comm, shuffle=shuffle, seed=seed)
    n = len(getattr(iterator, "dataset", ()) or ())
    bs = getattr(iterator, "batch_size", None)
    if not n or not bs:
        return
    consumed = plan.iteration * bs  # per-rank samples drawn so far
    if hasattr(iterator, "set_position"):
        iterator.set_position(consumed % n, consumed // n)
    elif hasattr(iterator, "epoch"):
        iterator.epoch = consumed // n
