"""Distributed checkpointer with consensus resume.

Counterpart of ``chainermn_tpu/extensions/checkpoint.py``
``MultiNodeCheckpointer`` / ``create_multi_node_checkpointer`` (reference:
chainermn/extensions/checkpoint.py): each process writes its own
``snapshot_iter_<N>.<rank>`` file, keeps a rolling window, and on resume
all ranks agree on the newest iteration present on every rank before
loading — restart-based fault tolerance.

The JAX package writes one file per process, and a JAX process drives a
host's devices (``comm.inter_rank``); a port process drives one GPU, so
the file's index is the process's ``comm.rank`` and the saving world is
``comm.size``.

A state is a nested structure of dicts, lists and tuples whose leaves
are tensors, numpy arrays and Python numbers (the updater's state is the
model's and the optimizer's ``state_dict``s, :class:`~chainermn_torch.
training.StandardUpdater`); anything else in it (``None``, strings) is
structure. The file format is the JAX package's: an npz with one array
``leaf_<i>`` per leaf in the port's own leaf order (tensors copied to
host numpy, bf16 as its 16 raw bits), ``__world__`` (the saving world),
``__host_state__`` (the pickled host state as uint8) and, the port's
own, ``__tree__`` (the pickled structure with each leaf's kind and
dtype: a fresh torch optimizer has no state until its first step, so the
state to restore cannot come from the restoring run's template). It is
published atomically (tmp name, fsync, SHA-256, rename) with a sidecar
JSON manifest of the same keys (``format`` 1, ``sha256``, ``bytes``, the
coverage map). A snapshot does not load across the two packages, but the
JAX checkpointer verifies and elects the port's files, and the port's
elects the JAX package's.

**Sharded leaves.** A :class:`ShardedLeaf` (the local tensor, the leaf's
global shape and the global ``(start, stop)`` it covers in each
dimension: what ``ZeroState.state_dict()`` and ``FsdpState.state_dict()``
give) is saved under JAX's keys: ``leaf_i_nshards``, ``leaf_i_gshape``,
``leaf_i_s0`` and ``leaf_i_idx0`` (an ``[ndim, 2]`` array), so a rank's
file holds only its own pieces. :meth:`MultiNodeCheckpointer.maybe_load`
restores each onto the index the template's sharded leaf at the same
place in the structure asks for, splicing it by global index from
whichever saved pieces intersect it (JAX's ``_SpliceTargets``): the
rank's own file first, then its peers', so a state saved on more ranks
restores onto fewer. A leaf whose global shape changed goes to
``leaf_resharder`` (``checkpointing/reshard.py``: the world-stacked
error-feedback frames regroup) or raises as another model.
:meth:`~MultiNodeCheckpointer.set_layout` folds a shard-layout manifest
(``zero_layout_manifest``, ``fsdp_layout_manifest``) into every publish,
and :func:`read_manifest` reads a file's manifest back.

The ``orbax`` backend is JAX's own library; the port keeps the npz
backend, which saves and reshards sharded states (ROADMAP.md queue 3).
The chaos harness (``$CHAINERMN_TPU_CHAOS``) hooks every publish
(``on_publish`` before, ``on_checkpoint`` after); the ring replicas'
writer is ``resilience/replica.py``, their read side (``replicas/``) is
here. The election's barrier is the communicator's store-backed
``host_barrier``.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import pickle
import queue
import re
import threading
import time
import types
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from chainermn_torch.comm.base import CommunicatorBase
from chainermn_torch.resilience import chaos as _chaos

__all__ = ["MultiNodeCheckpointer", "create_multi_node_checkpointer",
           "ShardedLeaf", "read_manifest"]

#: subdirectory (under the checkpointer's path) where ring-neighbor
#: replicas land, read by the election and restore fallbacks below
REPLICA_DIRNAME = "replicas"

def _sha256_file(fn: str) -> str:
    h = hashlib.sha256()
    with open(fn, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _fsync_file(fn: str) -> None:
    fd = os.open(fn, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass  # fsync unsupported (some tmpfs): the rename is still atomic
    finally:
        os.close(fd)


def read_manifest(fn: str) -> Optional[dict]:
    """The sidecar JSON manifest published next to snapshot file ``fn``
    (None when missing or torn): the integrity keys (``format``,
    ``sha256``, ``bytes``) and the coverage map (``iteration``,
    ``world``, ``axes``, each leaf's ``gshape`` and ``nshards``, and the
    ``layout`` given to :meth:`MultiNodeCheckpointer.set_layout`)."""
    try:
        with open(fn + ".json", encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


class ShardedLeaf:
    """One rank's piece of a leaf split across ranks: ``local`` (the
    tensor), ``gshape`` (the whole leaf's shape) and ``index`` (the
    global ``(start, stop)`` it covers in each dimension)."""

    __slots__ = ("local", "gshape", "index")

    def __init__(self, local, gshape, index):
        self.local = local
        self.gshape = tuple(int(d) for d in gshape)
        self.index = tuple((int(a), int(b)) for a, b in index)
        if len(self.index) != len(self.gshape):
            raise ValueError(f"index {self.index} does not match global "
                             f"shape {self.gshape}")


# -- state <-> flat host arrays -------------------------------------------

class _Leaf:
    """A leaf's place in the pickled structure: its index, its kind
    (``tensor``, ``ndarray`` or the Python number type) and for tensors
    its dtype."""

    __slots__ = ("i", "kind", "dtype")

    def __init__(self, i: int, kind: str, dtype: Optional[str] = None):
        self.i, self.kind, self.dtype = i, kind, dtype


_NUMBERS = (bool, int, float)


def _flatten(state, leaves: list):
    """``state`` → its structure with :class:`_Leaf` placeholders;
    ``leaves`` collects the leaves in order."""
    if isinstance(state, ShardedLeaf):
        leaves.append(state)
        return _Leaf(len(leaves) - 1, "sharded",
                     str(torch.as_tensor(state.local).dtype)[6:])
    if isinstance(state, torch.Tensor):
        leaves.append(state)
        return _Leaf(len(leaves) - 1, "tensor", str(state.dtype)[6:])
    if isinstance(state, (np.ndarray, np.generic)):
        leaves.append(state)
        return _Leaf(len(leaves) - 1, "ndarray")
    if isinstance(state, _NUMBERS):
        leaves.append(state)
        return _Leaf(len(leaves) - 1, type(state).__name__)
    if isinstance(state, dict):
        return {k: _flatten(v, leaves) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        items = [_flatten(v, leaves) for v in state]
        if isinstance(state, tuple) and hasattr(state, "_fields"):
            return type(state)(*items)
        return type(state)(items)
    return state


def _host_copies(leaves: list) -> list:
    """Each leaf's host copy (a sharded leaf's local piece): CUDA
    tensors copied into page-locked memory without blocking (the caller
    synchronizes), CPU tensors cloned, bf16 as its raw bits (numpy has
    no bf16), numbers as arrays."""
    host = []
    for leaf in leaves:
        t = leaf.local if isinstance(leaf, ShardedLeaf) else leaf
        if isinstance(t, torch.Tensor):
            t = t.detach()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            if t.is_cuda:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                host.append(buf)
            else:
                host.append(t.clone())
        else:
            host.append(np.array(t))
    return host


def _leaf_arrays(leaves: list, host: list) -> Dict[str, np.ndarray]:
    """The npz arrays of the leaves' host copies: ``leaf_i`` for a whole
    leaf; JAX's ``leaf_i_nshards``/``_gshape``/``_s0``/``_idx0`` for a
    sharded one."""
    arrays: Dict[str, np.ndarray] = {}
    for i, (leaf, h) in enumerate(zip(leaves, host)):
        a = h.numpy() if isinstance(h, torch.Tensor) else h
        if isinstance(leaf, ShardedLeaf):
            arrays[f"leaf_{i}_nshards"] = np.int64(1)
            arrays[f"leaf_{i}_gshape"] = np.asarray(leaf.gshape, np.int64)
            arrays[f"leaf_{i}_s0"] = a
            arrays[f"leaf_{i}_idx0"] = np.asarray(
                leaf.index, np.int64).reshape(len(leaf.index), 2)
        else:
            arrays[f"leaf_{i}"] = a
    return arrays


def _host_arrays(state) -> Tuple[Dict[str, np.ndarray], Any]:
    """``{leaf keys: ndarray}`` and the structure of ``state``. CUDA
    tensors are copied into page-locked host memory asynchronously and
    waited for once."""
    leaves: list = []
    tree = _flatten(state, leaves)
    host = _host_copies(leaves)
    if any(getattr(getattr(leaf, "local", leaf), "is_cuda", False)
           for leaf in leaves):
        torch.cuda.synchronize()
    return _leaf_arrays(leaves, host), tree


def _restore_leaf(arr: np.ndarray, leaf: _Leaf):
    """One saved array back to its kind: a CPU tensor in its saved
    dtype, an array, or a number."""
    arr = np.asarray(arr)
    if leaf.kind in ("tensor", "sharded"):
        t = torch.from_numpy(np.array(arr, copy=True))
        return t.view(torch.bfloat16) if leaf.dtype == "bfloat16" else t
    if leaf.kind == "ndarray":
        return arr
    return {"bool": bool, "int": int, "float": float}[leaf.kind](arr.item())


_MISSING = object()


def _child(template, key):
    """The template's entry at ``key`` (``_MISSING`` where it has none)."""
    if isinstance(template, dict):
        return template.get(key, _MISSING)
    if isinstance(template, (list, tuple)) and isinstance(key, int) \
            and key < len(template):
        return template[key]
    return _MISSING


def _unflatten(tree, restore, template=_MISSING):
    """Rebuild ``tree`` (the saved structure): each placeholder becomes
    ``restore(leaf, template entry at the same place)``."""
    if isinstance(tree, _Leaf):
        return restore(tree, template)
    if isinstance(tree, dict):
        return {k: _unflatten(v, restore, _child(template, k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_unflatten(v, restore, _child(template, i))
                 for i, v in enumerate(tree)]
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return tree


def _bounds(index, gshape):
    """Concrete ``(start, stop)`` per dimension of a saved ``[ndim, 2]``
    index (JAX writes -1 for a stop at the end)."""
    return [(int(a), int(b) if b != -1 else int(d))
            for (a, b), d in zip(np.asarray(index), gshape)]


class _SpliceTargets:
    """JAX's resharding assembly of one leaf (``extensions/checkpoint.py
    :152``): the ranges this rank needs, filled from whatever saved
    pieces intersect them; a piece's data is read only when it
    intersects. Saved pieces partition the leaf, so coverage is counted
    by intersection volume, and a piece seen in two files (a primary and
    its replica) counts once."""

    def __init__(self, targets, gshape, dtype):
        self.gshape = gshape
        self.bounds = [list(t) for t in targets]
        self.bufs = [np.empty(tuple(b - a for a, b in tb), dtype)
                     for tb in self.bounds]
        self.vols = [b.size for b in self.bufs]
        self.covered = [0] * len(self.bufs)
        self._seen = set()

    def consume(self, src, i):
        """Fold leaf ``i``'s pieces from one snapshot file in."""
        if f"leaf_{i}_nshards" not in src.files:
            return
        for k in range(int(src[f"leaf_{i}_nshards"])):
            idx = np.asarray(src[f"leaf_{i}_idx{k}"])
            key = idx.tobytes()
            if key in self._seen:
                continue
            sb = _bounds(idx, self.gshape)
            arr = None
            for t, tb in enumerate(self.bounds):
                inter = [(max(a1, a2), min(b1, b2))
                         for (a1, b1), (a2, b2) in zip(tb, sb)]
                if any(b <= a for a, b in inter):
                    continue
                if arr is None:
                    arr = np.asarray(src[f"leaf_{i}_s{k}"])
                dst = tuple(slice(a - ta, b - ta)
                            for (a, b), (ta, _) in zip(inter, tb))
                sl = tuple(slice(a - sa, b - sa)
                           for (a, b), (sa, _) in zip(inter, sb))
                self.bufs[t][dst] = arr[sl]
                self.covered[t] += int(np.prod([b - a for a, b in inter],
                                               initial=1))
                if self.covered[t] > self.vols[t]:
                    raise ValueError(
                        f"snapshot leaf {i}: saved shards overlap "
                        f"(covered {self.covered[t]} > {self.vols[t]} "
                        f"elements of target range {t}) — snapshot files "
                        "are not a disjoint partition; was the snapshot "
                        "written by mixed runs?")
            if arr is not None:
                self._seen.add(key)

    @property
    def complete(self) -> bool:
        return self.covered == self.vols

    def require_complete(self, i):
        if not self.complete:
            raise ValueError(
                f"snapshot leaf {i}: saved shards cover only "
                f"{self.covered}/{self.vols} elements of this process's "
                "target ranges — snapshot incomplete (a peer process's "
                "file is missing?)")


class MultiNodeCheckpointer:
    """Snapshot and restore a training state, one file per process.

    ``async_write=True`` moves the disk write off the training thread:
    the device → host copy still happens inside ``save`` (the snapshot
    captures the state now; the next step updates the model in place),
    while serialization, the atomic publish and GC run on a writer thread
    behind a queue of one. A failed write surfaces on the next ``save`` or
    ``flush``; ``flush()`` joins outstanding writes, and every read-side
    operation (election, load) drains the queue first so it only sees
    published files.
    """

    def __init__(self, name: str, comm: CommunicatorBase, path: str = ".",
                 cp_interval: int = 5, async_write: bool = False,
                 backend: str = "npz"):
        if backend == "orbax":
            raise NotImplementedError(
                "the orbax backend is JAX's library and is not ported: the "
                "npz backend saves and reshards sharded states (ROADMAP.md "
                "queue 3)")
        if backend != "npz":
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        self.name = name
        self.comm = comm
        self.path = os.path.join(path, name)
        self.cp_interval = cp_interval  # snapshots kept in the window
        self.async_write = async_write
        self.backend = backend
        self._queue: Optional[queue.Queue] = None
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self._verify_cache: Dict[tuple, bool] = {}
        self.replica_path = os.path.join(self.path, REPLICA_DIRNAME)
        # iterations GC never deletes: what protect() pinned, plus the
        # last consensus winner (one slot, replaced at each election)
        self._protected: set = set()
        self._elected: Optional[int] = None
        #: shard-layout metadata (zero_layout_manifest /
        #: fsdp_layout_manifest) folded into every published manifest
        self.layout: Optional[dict] = None
        # each process may have its own filesystem: each makes the path
        os.makedirs(self.path, exist_ok=True)
        self._pre_election_barrier()

    @property
    def _rank(self) -> int:
        return self.comm.rank

    def _pre_election_barrier(self):
        """The store-backed host barrier when the communicator offers one
        (bounded waits, watchdog-abortable: a dead peer raises instead of
        hanging); the communicator's barrier otherwise."""
        hb = getattr(self.comm, "host_barrier", None)
        if callable(hb):
            hb()
        else:
            self.comm.barrier()

    def set_layout(self, layout: Optional[dict]) -> None:
        """Attach optimizer shard-layout metadata
        (``optimizers.zero_layout_manifest`` / ``fsdp_layout_manifest``)
        to every manifest published from now on, so tools can read a
        file set's sharded leaves without the live step."""
        self.layout = layout

    # -- async writer ---------------------------------------------------

    def _ensure_writer(self):
        if self._writer is not None and self._writer.is_alive():
            return
        # a queue of one is backpressure: a disk slower than the save
        # cadence stalls save() instead of piling up host copies
        self._queue = queue.Queue(maxsize=1)
        self._writer = threading.Thread(
            target=self._writer_loop, name=f"ckpt-writer-{self.name}",
            daemon=True)
        self._writer.start()
        self._register_atexit()

    def _register_atexit(self):
        # a script that never calls close() must not lose checkpoints
        if getattr(self, "_atexit_done", False):
            return
        self._atexit_done = True
        import atexit

        def _close_at_exit():
            try:
                self.close()
            except Exception as e:
                warnings.warn(f"checkpoint writer at exit: {e}")

        atexit.register(_close_at_exit)

    def _writer_loop(self):
        while True:
            # same-process producer, sentinel-terminated: close() always
            # delivers the None wake-up
            item = self._queue.get()
            try:
                if item is None:
                    return
                arrays, fn, meta = item
                self._publish(arrays, fn, meta=meta)
            except BaseException as e:  # surfaced on the next save/flush
                self._write_error = e
            finally:
                self._queue.task_done()

    def _raise_pending(self):
        if self._write_error is not None:
            e, self._write_error = self._write_error, None
            raise RuntimeError(
                f"async checkpoint write failed: {e!r}") from e

    def _drain(self):
        """Join queued writes without raising: the election must reach
        its allgather even when this process's last write failed, or the
        other ranks hang in the collective; a failed write was never
        published, so the election skips it."""
        if self._queue is not None:
            self._queue.join()
        if self._write_error is not None:
            e, self._write_error = self._write_error, None
            warnings.warn(
                f"async checkpoint write failed (election will skip the "
                f"unpublished snapshot): {e!r}")

    def flush(self):
        """Block until every queued snapshot is published."""
        if self._queue is not None:
            self._queue.join()
        self._raise_pending()

    def close(self):
        """Join outstanding writes (trainer finalization hook)."""
        if self._writer is not None and self._writer.is_alive():
            self._queue.join()
            self._queue.put(None)
            self._writer.join()
        self._writer = None
        self._raise_pending()

    # -- save -----------------------------------------------------------

    def _publish(self, arrays: dict, fn: str, meta: Optional[dict] = None):
        """Atomic, verifiable publish: tmp name, fsync, rename, then the
        sidecar manifest with the file's SHA-256 (itself tmp + fsync +
        rename). A torn or corrupted file fails verification and is left
        out of the election instead of poisoning the restore. The chaos
        harness's hooks sit on both sides: ``on_publish`` before any byte
        is written (``enospc`` raises with nothing published,
        ``slow_disk`` stalls), ``on_checkpoint`` after the publish
        (``corrupt``/``truncate`` damage a fully valid file, as a bad
        disk would)."""
        _chaos.on_publish(fn)
        tmp = fn + ".npz"
        np.savez(tmp, **arrays)
        _fsync_file(tmp)
        sha = _sha256_file(tmp)
        size = os.path.getsize(tmp)
        os.replace(tmp, fn)  # atomic publish
        manifest = dict(meta or {})
        manifest.update({"format": 1, "sha256": sha, "bytes": size})
        mtmp = fn + ".json.tmp"
        with open(mtmp, "w", encoding="utf-8") as fh:
            json.dump(manifest, fh)
            fh.flush()
            try:
                os.fsync(fh.fileno())
            except OSError:
                pass
        os.replace(mtmp, fn + ".json")
        _chaos.on_checkpoint(fn)
        self._gc()

    def _coverage_meta(self, arrays: dict, iteration: int) -> dict:
        """The manifest's coverage map (JAX's): saving iteration and
        world, the communicator's mesh axes, each leaf's global shape and
        local piece count (0 for a whole leaf), and the layout given to
        :meth:`set_layout`."""
        leaves = {}
        for k, a in arrays.items():
            m = re.match(r"leaf_(\d+)_nshards$", k)
            if m:
                leaves[m.group(1)] = {
                    "gshape": [int(d) for d in
                               arrays[f"leaf_{m.group(1)}_gshape"]],
                    "nshards": int(a)}
                continue
            m = re.match(r"leaf_(\d+)$", k)
            if m:
                leaves[m.group(1)] = {
                    "gshape": [int(d) for d in np.shape(a)], "nshards": 0}
        meta = {"iteration": int(iteration), "world": int(self.comm.size),
                "leaves": leaves}
        axes = getattr(self.comm, "mesh_shape", None)
        if axes:
            meta["axes"] = {str(k): int(v) for k, v in axes.items()}
        if self.layout is not None:
            meta["layout"] = self.layout
        return meta

    def _snapshot_arrays(self, state, host_state) -> dict:
        arrays, tree = _host_arrays(state)
        # the saving world: the completeness election checks the file set
        # against it, so a snapshot stays electable after the process
        # count changes while a lost file still reads as incomplete
        arrays["__world__"] = np.int64(self.comm.size)
        arrays["__tree__"] = np.frombuffer(
            pickle.dumps(tree, pickle.HIGHEST_PROTOCOL), np.uint8).copy()
        if host_state is not None:
            # pickled bytes as a uint8 array (allow_pickle stays False on
            # load), covered by the same SHA-256 as the state
            arrays["__host_state__"] = np.frombuffer(
                pickle.dumps(host_state, pickle.HIGHEST_PROTOCOL),
                np.uint8).copy()
        return arrays

    def _file(self, iteration: int, rank: Optional[int] = None) -> str:
        return os.path.join(
            self.path, f"snapshot_iter_{iteration}."
                       f"{self._rank if rank is None else rank}")

    def save(self, state: Any, iteration: int,
             host_state: Any = None) -> str:
        """Snapshot ``state`` plus an optional small picklable
        ``host_state`` (iterator position, RNG state:
        ``StandardUpdater.host_state_dict``) under this rank's file for
        ``iteration``. Returns the file name."""
        self._raise_pending()
        fn = self._file(iteration)
        arrays = self._snapshot_arrays(state, host_state)
        meta = self._coverage_meta(arrays, iteration)
        if self.async_write:
            self._ensure_writer()
            self._queue.put((arrays, fn, meta))
        else:
            self._publish(arrays, fn, meta=meta)
        return fn

    def _iters_on_disk(self) -> List[int]:
        pat = re.compile(rf"snapshot_iter_(\d+)\.{self._rank}$")
        out = []
        if os.path.isdir(self.path):
            for f in os.listdir(self.path):
                m = pat.match(f)
                if m:
                    out.append(int(m.group(1)))
        return sorted(out)

    def protect(self, iteration: int) -> None:
        """Pin ``iteration`` against the rolling-window GC (idempotent,
        for the life of this checkpointer: a milestone snapshot). The
        election separately pins its current winner."""
        self._protected.add(int(iteration))

    def _gc(self):
        """Rolling-window GC, consensus-aware: delete this rank's
        snapshots older than the ``cp_interval`` window, except protected
        iterations, the last consensus winner and the newest iteration
        whose own file verifies (so a failed or corrupt latest save never
        strands the next election with only broken files)."""
        iters = self._iters_on_disk()
        drop = iters[:-self.cp_interval] if self.cp_interval else iters
        if not drop:
            return
        keep = set(self._protected)
        if self._elected is not None:
            keep.add(self._elected)
        valid = [it for it in iters
                 if self._verify_snapshot_file(self._file(it))]
        if valid:
            keep.add(max(valid))
        for it in drop:
            if it in keep:
                continue
            fn = self._file(it)
            for f in (fn, fn + ".json"):
                try:
                    os.remove(f)
                except OSError:
                    pass

    # -- integrity ------------------------------------------------------

    def _verify_snapshot_file(self, fn: str) -> bool:
        """Is this snapshot file intact? Its manifest carries the
        published file's SHA-256 and size; a mismatch (torn write,
        truncation, bit rot) marks it invalid. A file without a manifest
        is accepted as it is; a torn manifest is not. Results are cached
        by (mtime, size)."""
        if not os.path.isfile(fn):
            return False
        mf = fn + ".json"
        if not os.path.exists(mf):
            return True
        try:
            with open(mf, encoding="utf-8") as fh:
                manifest = json.load(fh)
        except (OSError, ValueError):
            return False  # torn manifest: the snapshot is suspect
        st = os.stat(fn)
        key = (fn, st.st_mtime_ns, st.st_size)
        if key in self._verify_cache:
            return self._verify_cache[key]
        if manifest.get("bytes") not in (None, st.st_size):
            ok = False  # truncation shows in the size alone
        else:
            try:
                ok = _sha256_file(fn) == manifest.get("sha256")
            except OSError:
                ok = False
        if len(self._verify_cache) > 128:
            self._verify_cache.clear()
        self._verify_cache[key] = ok
        return ok

    def _replica_file(self, it: int, rank: Optional[int] = None) -> str:
        """Where a ring replica of (iteration, rank) would live."""
        return os.path.join(
            self.replica_path,
            f"snapshot_iter_{it}.{self._rank if rank is None else rank}")

    def _own_file(self, it: int) -> Optional[str]:
        """This rank's readable copy of iteration ``it``: the primary
        file when it verifies, else the ring replica, else None."""
        for fn in (self._file(it), self._replica_file(it)):
            if self._verify_snapshot_file(fn):
                return fn
        return None

    def _replica_iters_on_disk(self) -> List[int]:
        """Iterations with a valid replica of this rank's file."""
        pat = re.compile(rf"snapshot_iter_(\d+)\.{self._rank}$")
        out = []
        if os.path.isdir(self.replica_path):
            for f in os.listdir(self.replica_path):
                m = pat.match(f)
                if m and self._verify_snapshot_file(
                        os.path.join(self.replica_path, f)):
                    out.append(int(m.group(1)))
        return sorted(out)

    def _valid_iters_on_disk(self) -> List[int]:
        """This rank's iterations whose files verify, replicas
        included: the election's own-file inventory."""
        own = [it for it in self._iters_on_disk()
               if self._verify_snapshot_file(self._file(it))]
        return sorted(set(own) | set(self._replica_iters_on_disk()))

    # -- trainer integration --------------------------------------------

    def __call__(self, trainer):
        """Trainer-extension protocol (``trainer.extend(checkpointer)``):
        snapshot the updater's state and host state at each trigger."""
        host_fn = getattr(trainer.updater, "host_state_dict", None)
        self.save(trainer.updater.state, trainer.updater.iteration,
                  host_state=host_fn() if callable(host_fn) else None)

    def emergency_save(self, trainer, deadline_s: Optional[float] = None):
        """Last-chance synchronous snapshot (preemption or crash): on this
        thread, past the writer queue, published before it returns. No
        collective is involved. ``deadline_s`` (``time.monotonic``) skips
        the write once the window has closed."""
        if deadline_s is not None and time.monotonic() >= deadline_s:
            return None
        host_fn = getattr(trainer.updater, "host_state_dict", None)
        iteration = trainer.updater.iteration
        fn = self._file(iteration)
        arrays = self._snapshot_arrays(
            trainer.updater.state, host_fn() if callable(host_fn) else None)
        self._publish(arrays, fn, meta=self._coverage_meta(arrays,
                                                           iteration))
        return fn

    def load_host_state(self, iteration: int) -> Any:
        """The host state saved with this rank's snapshot of
        ``iteration`` (None when it has none or no readable file)."""
        fn = self._own_file(iteration)
        if fn is None:
            return None
        with np.load(fn, allow_pickle=False) as z:
            if "__host_state__" not in z.files:
                return None
            return pickle.loads(z["__host_state__"].tobytes())

    def resume(self, updater) -> Optional[int]:
        """Restore the updater from the newest complete snapshot, if any.

        The state loads in place (``updater.state = ...`` runs
        ``load_state_dict`` on the model and the optimizer the step
        holds) and ``updater.iteration`` is set; returns the iteration or
        None. With host state, the iterator position and RNG are restored
        too, so the run continues on the exact next batch; without it the
        iterator's epoch counter is fast-forwarded (the reference's
        restart semantics: the position within the epoch restarts)."""
        state, it = self.maybe_load(updater.state)
        if it is None:
            return None
        updater.state = state
        updater.iteration = it
        host = self.load_host_state(it)
        restore = getattr(updater, "load_host_state", None)
        if host is not None and callable(restore):
            restore(host)
            return it
        iterator = getattr(updater, "iterator", None)
        if (iterator is not None and hasattr(iterator, "epoch")
                and hasattr(iterator, "batch_size")
                and hasattr(iterator, "dataset")):
            n = len(iterator.dataset)
            if n:
                iterator.epoch = it * iterator.batch_size // n
        return it

    # -- election and restore -------------------------------------------

    def _complete_iters_on_disk(self) -> List[int]:
        """Iterations whose file set is complete as seen from this
        filesystem: every rank of the saving world (``__world__``),
        primaries or replicas, verifies. Without the marker, rank-suffix
        contiguity decides."""
        by_iter: Dict[int, set] = {}
        for d in (self.path, self.replica_path):
            if not os.path.isdir(d):
                continue
            for f in os.listdir(d):
                m = re.match(r"snapshot_iter_(\d+)\.(\d+)$", f)
                if m and self._verify_snapshot_file(os.path.join(d, f)):
                    by_iter.setdefault(int(m.group(1)), set()).add(
                        int(m.group(2)))
        out = []
        for it, ranks in by_iter.items():
            world = self._saved_world(it)
            need = (set(range(world)) if world
                    else set(range(max(ranks) + 1)))
            if need <= ranks:
                out.append(it)
        return sorted(out)

    def _files_of(self, it: int) -> List[str]:
        """Every primary and replica file of iteration ``it``."""
        pat = re.compile(rf"snapshot_iter_{it}\.(\d+)$")
        return [fn for d in (self.path, self.replica_path)
                for fn in sorted(glob.glob(
                    os.path.join(d, f"snapshot_iter_{it}.*")))
                if pat.search(os.path.basename(fn)) and os.path.isfile(fn)]

    def _saved_world(self, it: int) -> Optional[int]:
        """The saving run's world size, from any surviving file of
        iteration ``it`` (None when unknowable)."""
        for fn in self._files_of(it):
            try:
                with np.load(fn, allow_pickle=False) as z:
                    if "__world__" in z.files:
                        return int(z["__world__"])
            except Exception:  # noqa: BLE001 — unreadable: skip it
                continue
        return None

    def latest_common_iteration(self) -> Optional[int]:
        """Consensus election: each rank's inventory is the union of its
        own valid files and the complete file sets it can see (a rank
        that is new since the save sees its peers' set on a shared
        filesystem); the newest iteration every rank lists wins. A
        barrier first, so that no peer's save is still in flight."""
        self._drain()
        self._pre_election_barrier()
        mine = sorted(set(self._valid_iters_on_disk())
                      | set(self._complete_iters_on_disk()))
        common = set(mine)
        for lst in self.comm.allgather_obj(mine):
            common &= set(lst)
        if common:
            # pin the winner against GC until the next election
            self._elected = max(common)
            return self._elected
        return None

    def maybe_load(self, state: Any = None,
                   iteration: Optional[int] = None,
                   allow_incomplete: bool = False,
                   leaf_resharder: Optional[Any] = None):
        """Restore from the newest complete snapshot (or ``iteration``).
        Returns ``(state, iteration)``: the restored state and its
        iteration, or ``state`` unchanged and None when nothing is
        restorable.

        The restored state has the saved structure (a fresh optimizer's
        state lacks the buffers it will hold), its tensors on the CPU in
        their saved dtypes: ``load_state_dict`` moves them where they
        belong. A saved sharded leaf is restored onto the template: where
        ``state`` holds a :class:`ShardedLeaf` at the same place, onto
        its index (spliced from every saved piece that intersects it,
        peers' files included), returning a sharded leaf; where it holds
        a tensor, whole; where it holds nothing, the restore raises (the
        steps' ``state_dict(template=True)`` gives a full template),
        except on the saving world, where each rank takes its own saved
        piece. A saved whole leaf onto a template's sharded leaf is
        sliced.

        ``leaf_resharder(i, ref, saved_gshape, fetch_full)`` (JAX's
        hook, ``checkpointing/reshard.py:default_leaf_resharder``) is
        asked for a leaf whose saved global shape differs from the
        template's (``ref.shape``): ``fetch_full()`` splices the whole
        saved leaf; it returns an array of the template's global shape,
        or None for the different-model error.

        A rank with no own file (a world larger than the saving one)
        reads every leaf from its peers' files of a complete snapshot;
        ``allow_incomplete`` skips that completeness gate. An explicit
        ``iteration`` whose own file fails verification raises, and so
        does a file of the JAX package (no ``__tree__``)."""
        self._drain()
        it = (iteration if iteration is not None
              else self.latest_common_iteration())
        if it is None:
            return state, None
        self._elected = it
        fn = self._file(it)
        own = self._own_file(it)
        if own is None and os.path.exists(fn):
            raise ValueError(
                f"{fn}: snapshot file fails SHA-256 verification against "
                "its manifest (torn write or corruption) — refusing to "
                "load; the consensus election excludes such files, so "
                "pass no explicit iteration to fall back to the newest "
                "intact snapshot")
        if own is None and not allow_incomplete and (
                it not in self._complete_iters_on_disk()):
            raise FileNotFoundError(
                f"{fn}: no snapshot file for this rank and iteration {it} "
                "is not a complete smaller-world snapshot")
        sources = ([own] if own is not None else []) + [
            f for f in self._files_of(it)
            if f != own and self._verify_snapshot_file(f)]
        opened: Dict[str, Any] = {}
        try:
            def load(f):
                if f not in opened:
                    opened[f] = np.load(f, allow_pickle=False)
                return opened[f]

            first = load(sources[0])
            if "__tree__" not in first.files:
                raise ValueError(f"{sources[0]} carries no __tree__: not a "
                                 "snapshot of the port's")
            tree = pickle.loads(first["__tree__"].tobytes())
            # on the saving world, this rank's own pieces are its targets
            own_pieces = (own is not None
                          and self._saved_world(it) == self.comm.size)
            restore = _Restorer(it, sources, load, leaf_resharder,
                                own if own_pieces else None)
            return _unflatten(tree, restore, state), it
        finally:
            for z in opened.values():
                z.close()


class _Restorer:
    """One restore's leaf reader: ``restore(leaf, template)`` for each
    saved placeholder (``maybe_load``)."""

    def __init__(self, it, sources, load, leaf_resharder, own=None):
        self.it, self.sources, self.load = it, sources, load
        self.resharder = leaf_resharder
        self.own = own

    def _file_with(self, key: str):
        for f in self.sources:
            z = self.load(f)
            if key in z.files:
                return z
        raise ValueError(f"snapshot iteration {self.it}: {key} appears in "
                         "no snapshot file")

    def _splice(self, i: int, gshape, dtype, targets):
        sp = _SpliceTargets(targets, gshape, dtype)
        for f in self.sources:
            sp.consume(self.load(f), i)
            if sp.complete:
                break
        sp.require_complete(i)
        return sp.bufs

    def _reshard(self, i, want_shape, saved_shape, fetch):
        """The saved leaf's whole value at the template's global shape
        ``want_shape`` (the resharder's), or the different-model
        error."""
        if self.resharder is not None:
            ref = types.SimpleNamespace(shape=tuple(want_shape))
            out = self.resharder(i, ref, tuple(saved_shape), fetch)
            if out is not None:
                out = np.asarray(out)
                if tuple(out.shape) != tuple(want_shape):
                    raise ValueError(
                        f"leaf_resharder returned shape {tuple(out.shape)}"
                        f" for leaf {i}; template is {tuple(want_shape)}")
                return out
        raise ValueError(
            f"snapshot leaf {i}: saved global shape {tuple(saved_shape)}, "
            f"template is {tuple(want_shape)} — different model, not a "
            "resharding")

    def __call__(self, leaf: _Leaf, template):
        i = leaf.i
        if leaf.kind != "sharded":
            arr = self._file_with(f"leaf_{i}")[f"leaf_{i}"]
            if isinstance(template, ShardedLeaf):
                full = np.asarray(arr)
                if full.shape != template.gshape:
                    full = self._reshard(i, template.gshape, full.shape,
                                         lambda: np.asarray(arr))
                sl = tuple(slice(a, b) for a, b in template.index)
                return ShardedLeaf(_restore_leaf(full[sl], leaf),
                                   template.gshape, template.index)
            shape = getattr(template, "shape", None)
            if (self.resharder is not None and shape is not None
                    and tuple(shape) != np.shape(arr)):
                arr = self._reshard(i, tuple(shape), np.shape(arr),
                                    lambda: np.asarray(arr))
            return _restore_leaf(arr, leaf)
        z = self._file_with(f"leaf_{i}_nshards")
        gshape = tuple(int(d) for d in z[f"leaf_{i}_gshape"])
        dtype = z[f"leaf_{i}_s0"].dtype
        whole = tuple((0, d) for d in gshape)
        if isinstance(template, ShardedLeaf):
            if template.gshape != gshape:
                full = self._reshard(
                    i, template.gshape, gshape,
                    lambda: self._splice(i, gshape, dtype, [whole])[0])
                sl = tuple(slice(a, b) for a, b in template.index)
                piece = full[sl]
            else:
                (piece,) = self._splice(i, gshape, dtype,
                                        [template.index])
            return ShardedLeaf(_restore_leaf(piece, leaf), template.gshape,
                               template.index)
        if template is _MISSING:
            z = None if self.own is None else self.load(self.own)
            if z is None or f"leaf_{i}_nshards" not in z.files:
                raise ValueError(
                    f"snapshot leaf {i} is sharded, and the template has "
                    "no leaf at its place to restore it onto (pass the "
                    "step state's state_dict(template=True))")
            # the saving world: this rank's own piece, where it was
            index = _bounds(z[f"leaf_{i}_idx0"], gshape)
            return ShardedLeaf(_restore_leaf(z[f"leaf_{i}_s0"], leaf),
                               gshape, index)
        shape = getattr(template, "shape", None)
        if shape is not None and tuple(shape) != gshape:
            full = self._reshard(
                i, tuple(shape), gshape,
                lambda: self._splice(i, gshape, dtype, [whole])[0])
        else:
            (full,) = self._splice(i, gshape, dtype, [whole])
        return _restore_leaf(full, leaf)


def create_multi_node_checkpointer(name: str, comm: CommunicatorBase,
                                   path: str = ".", cp_interval: int = 5,
                                   async_write: bool = False,
                                   **kwargs) -> MultiNodeCheckpointer:
    """Factory matching the reference name
    (chainermn/extensions/checkpoint.py)."""
    return MultiNodeCheckpointer(name, comm, path=path,
                                 cp_interval=cp_interval,
                                 async_write=async_write, **kwargs)
