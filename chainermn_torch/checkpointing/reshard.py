"""Manifest-driven elastic resharding across world sizes.

Counterpart of ``chainermn_tpu/checkpointing/reshard.py`` on the port's
checkpointer (``chainermn_torch/extensions/checkpoint.py``). Its splice
restores a sharded leaf by global index, so a leaf whose global shape is
unchanged restores onto any world. One class of leaf depends on the
world: the ZeRO steps' error-feedback residuals
(``optimizers/zero.py``), saved as the world-stacked ``(n_ranks,
padded)`` frame whose leading dimension is the saving world's size. The
coverage manifest every publish carries (saving world, axes, each leaf's
geometry) and this module's functions handle it:

* :func:`default_leaf_resharder`: the ``leaf_resharder`` hook that
  ``maybe_load`` calls on a global-shape mismatch. It regroups
  world-stacked EF frames between world sizes and refuses anything else
  (a model change still raises);
* :func:`ef_frame_regroup`: the regrouping itself;
* :func:`reshard_state`, :func:`manifest_info`, :func:`saved_axes`,
  :func:`mesh_axes`, :func:`scan_snapshot_dir`, :func:`leaf_coverage`:
  the restore and the host-side views of a file set.

EF regroup semantics (why it is correct): the reducers average with
``op='mean'``, so the aggregate correction entering each step is the
MEAN over ranks of the per-rank residuals. Shrinking ``n → n/k``
replaces each group of ``k`` rows by their mean (``sum / k`` — exact
for the power-of-two worlds real meshes use), growing ``n → k·n``
duplicates rows (bitwise): both directions preserve
``mean_r e_r`` exactly, so the resumed error feedback injects the same
aggregate correction the old world would have.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from chainermn_torch.extensions.checkpoint import read_manifest

__all__ = ["default_leaf_resharder", "ef_frame_regroup", "manifest_info",
           "mesh_axes", "reshard_state", "saved_axes"]

_SNAP_RE = re.compile(r"snapshot_iter_(\d+)\.(\d+)$")


def mesh_axes(comm) -> Optional[Dict[str, int]]:
    """The communicator's ``{axis_name: size}`` map (its ``mesh_shape``;
    None when the communicator has none)."""
    shape = getattr(comm, "mesh_shape", None)
    if not shape:
        return None
    return {str(a): int(s) for a, s in shape.items()}


def manifest_info(ck, iteration: int) -> Optional[dict]:
    """The richest coverage manifest any rank published for
    ``iteration`` — primary files first, then ring replicas. Host-side
    JSON only; no array is loaded."""
    best = None
    for d in (ck.path, ck.replica_path):
        if not os.path.isdir(d):
            continue
        for fn in sorted(glob.glob(
                os.path.join(d, f"snapshot_iter_{iteration}.*"))):
            if not _SNAP_RE.search(os.path.basename(fn)):
                continue
            mf = read_manifest(fn)
            if mf is None:
                continue
            if "axes" in mf or "leaves" in mf:
                return mf
            best = best or mf
    return best


def saved_axes(ck, iteration: int) -> Optional[Dict[str, int]]:
    """The SAVING run's mesh axes for ``iteration``, from its coverage
    manifest (None for pre-coverage snapshots)."""
    info = manifest_info(ck, iteration)
    if info is None:
        return None
    axes = info.get("axes")
    return {str(k): int(v) for k, v in axes.items()} if axes else None


def ef_frame_regroup(full: np.ndarray, n_new: int) -> np.ndarray:
    """Regroup a world-stacked ``(n_old, padded)`` EF residual frame
    onto ``n_new`` rows, preserving the cross-rank mean exactly (see
    the module docstring). Requires one row count to divide the other;
    raises ValueError otherwise."""
    full = np.asarray(full)
    if full.ndim != 2:
        raise ValueError(
            f"EF frame must be 2-D (n_ranks, padded): got {full.shape}")
    n_old = full.shape[0]
    if n_old == n_new:
        return full
    if n_old % n_new == 0:
        k = n_old // n_new
        # group mean: pairwise float sums then one exact /k for the
        # power-of-two worlds real meshes use
        out = full.reshape(n_new, k, full.shape[1]).sum(axis=1) / k
        return out.astype(full.dtype, copy=False)
    if n_new % n_old == 0:
        return np.repeat(full, n_new // n_old, axis=0)
    raise ValueError(
        f"cannot regroup an EF frame from {n_old} to {n_new} ranks — "
        "one world size must divide the other (power-of-two meshes "
        "always satisfy this)")


def default_leaf_resharder(i: int, ref, gshape: Tuple[int, ...],
                           fetch_full: Callable[[], np.ndarray]):
    """The ``leaf_resharder`` hook ``maybe_load`` consults when a leaf's
    saved GLOBAL shape differs from the template's.

    Only the world-stacked flat-frame shape is accepted: a 2-D saved
    frame onto a 2-D template with the SAME trailing (padded flat)
    dimension and a divisible leading (rank) dimension — exactly the EF
    residual stacks ``optimizers/zero.py`` builds, whose trailing dim
    is device-count-independent by the quantum padding. Everything else
    returns None, falling through to the checkpointer's different-model
    error. ``fetch_full`` splices the full saved global frame on host —
    EF frames are small (one padded flat vector per rank), so this does
    not breach the no-global-leaf contract for model-sized leaves."""
    tshape = tuple(getattr(ref, "shape", ()) or ())
    if len(gshape) != 2 or len(tshape) != 2 or gshape[1] != tshape[1]:
        return None
    n_old, n_new = int(gshape[0]), int(tshape[0])
    if n_old == n_new:
        return None  # same frame — the splice path handles tile changes
    if n_old % n_new and n_new % n_old:
        return None
    return ef_frame_regroup(np.asarray(fetch_full()), n_new)


def reshard_state(ck, state: Any, iteration: Optional[int] = None,
                  allow_incomplete: bool = False):
    """Restore ``state`` from ``ck``'s snapshots onto the CURRENT mesh,
    resharding as needed: same-shape leaves re-scatter through the
    splice path, world-stacked EF frames regroup through
    :func:`default_leaf_resharder`. Returns ``(state, iteration)`` like
    ``maybe_load``. This is the load half of an elastic resume (the
    host-side rebalancing around it is ``resilience/elastic.py``'s
    ``elastic_resume``). The template's sharded leaves
    (``state_dict(template=True)`` of the restoring world's ZeRO or FSDP
    state) say which piece each rank restores."""
    return ck.maybe_load(state, iteration=iteration,
                         allow_incomplete=allow_incomplete,
                         leaf_resharder=default_leaf_resharder)


# -- offline helpers (host-side, no restore) --------------------------------

def scan_snapshot_dir(path: str) -> Dict[int, List[str]]:
    """``{iteration: [files]}`` for every snapshot file under ``path``
    and its ``replicas/`` subtree (host-side, no array loads)."""
    out: Dict[int, List[str]] = {}
    for d in (path, os.path.join(path, "replicas")):
        if not os.path.isdir(d):
            continue
        for f in sorted(os.listdir(d)):
            m = _SNAP_RE.match(f)
            fn = os.path.join(d, f)
            if m and not os.path.isdir(fn):
                out.setdefault(int(m.group(1)), []).append(fn)
    return out


def leaf_coverage(files: List[str]) -> Dict[int, dict]:
    """Per-leaf shard-coverage report across a snapshot file set:
    ``{leaf: {gshape, nshards, intervals, covered, volume}}`` where
    ``covered`` is True when the saved shard intervals tile the full
    global volume (disjoint-partition accounting, the same invariant
    ``_SpliceTargets`` enforces at load). Reads only the SMALL manifest
    keys (gshape/nshards/idx) — shard data stays untouched."""
    leaves: Dict[int, dict] = {}
    for fn in files:
        with np.load(fn, allow_pickle=False) as z:
            keys = set(z.files)
            for k in keys:
                m = re.match(r"leaf_(\d+)_nshards$", k)
                if m:
                    i = int(m.group(1))
                    gshape = tuple(
                        int(d) for d in z[f"leaf_{i}_gshape"])
                    rec = leaves.setdefault(i, {
                        "gshape": gshape, "nshards": 0,
                        "intervals": set()})
                    rec["nshards"] += int(z[k])
                    for s in range(int(z[k])):
                        idx = np.asarray(z[f"leaf_{i}_idx{s}"])
                        bounds = tuple(
                            (int(a), int(b) if b != -1 else d)
                            for (a, b), d in zip(idx, gshape))
                        rec["intervals"].add(bounds)
                    continue
                m = re.match(r"leaf_(\d+)$", k)
                if m:
                    i = int(m.group(1))
                    gshape = tuple(int(d) for d in z[k].shape)
                    rec = leaves.setdefault(i, {
                        "gshape": gshape, "nshards": 0,
                        "intervals": set()})
                    rec["intervals"].add(tuple(
                        (0, d) for d in gshape))
    for rec in leaves.values():
        total = int(np.prod(rec["gshape"], dtype=np.int64)) \
            if rec["gshape"] else 1
        vol = sum(
            int(np.prod([b - a for a, b in iv], dtype=np.int64))
            for iv in rec["intervals"])
        rec["volume"] = vol
        # deduplicated intervals: disjoint by construction (they are the
        # saving mesh's shard partition), so covering volume == covered
        rec["covered"] = vol == total
        rec["intervals"] = sorted(rec["intervals"])
    return leaves
