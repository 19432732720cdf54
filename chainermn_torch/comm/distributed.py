"""A communicator over ``torch.distributed``: NCCL on the GPU, gloo on
the CPU.

Counterpart of ``chainermn_tpu/comm/xla.py`` ``XlaCommunicator``. One
process per GPU, each a rank of the default process group, which this
class creates when none exists:

* with ``RANK`` and ``WORLD_SIZE`` in the environment (``torchrun``, or a
  launcher that sets ``MASTER_ADDR``/``MASTER_PORT``), from the
  environment;
* otherwise as a world of one, on a ``TCPStore`` on localhost, so a
  single script runs as one rank with real collectives.

``allreduce_grad`` packs the gradients into flat buckets of at most
``DEFAULT_BUCKET_BYTES`` (:func:`plan_buckets`, a copy of the JAX
package's),
casts them to ``allreduce_grad_dtype`` when one is set, all-reduces each
bucket with one collective, casts back and, for ``op="mean"``, divides by
the world size: the reference ``pure_nccl`` communicator's pack → NCCL
all-reduce → unpack × 1/N.

The object collectives (``bcast_obj``, ``gather_obj``, ``allgather_obj``,
``allreduce_obj``, ``scatter_obj``, ``send_obj``, ``recv_obj``) pickle
host objects over a gloo group that every communicator creates at
construction, so objects never stage through NCCL or the GPU, and
``send_obj``/``recv_obj`` keep their ``tag`` (gloo matches tags, NCCL
ignores them).

Waiting for later slices (``NotImplementedError``, ROADMAP.md queue 1
item 2): ``split``, array ``send``/``recv`` and the host-staged
(``non_cuda_aware``) path.
"""

from __future__ import annotations

import functools
import operator
import os
import pickle
from typing import Any, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from chainermn_torch.comm.base import CommunicatorBase
from chainermn_torch.device import resolve_device

__all__ = ["DistributedCommunicator", "plan_buckets",
           "DEFAULT_BUCKET_BYTES"]

#: flat gradient bucket (torch DDP's default size): few enough collectives
#: per step that their launch cost stays small, small enough that the
#: packed copy of a 135M-parameter model's gradients is not doubled at once
DEFAULT_BUCKET_BYTES = 25 * 2 ** 20

_LATER = ("waits for a later slice of the port (ROADMAP.md queue 1 item "
          "2, comm/)")

_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}

# leaf reductions of allreduce_obj ("mean" is the sum over the count)
_OBJ_OPS = {"sum": operator.add, "mean": operator.add, "max": max,
            "min": min}


def plan_buckets(sized_items, bucket_bytes):
    """Greedy in-order packing of ``(key, nbytes)`` items into buckets of
    at most ``bucket_bytes`` (an oversized single item gets its own
    bucket). Returns a list of key-lists."""
    buckets, cur, cur_bytes = [], [], 0
    for key, nb in sized_items:
        if cur and cur_bytes + nb > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(key)
        cur_bytes += nb
    if cur:
        buckets.append(cur)
    return buckets


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a module (parameters and buffers), a dict or a
    sequence."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [t for v in tree for t in _tensors(v)]


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts, lists and tuples of one
    structure, as ``jax.tree_util.tree_map`` maps them (None is an empty
    node); another structure raises ``ValueError``."""
    first = trees[0]
    if first is None:
        if any(t is not None for t in trees):
            raise ValueError("tree structures differ: None vs a value")
        return None
    if isinstance(first, (dict, list, tuple)):
        if any(type(t) is not type(first) or len(t) != len(first)
               for t in trees):
            raise ValueError(f"tree structures differ: {trees!r}")
        if isinstance(first, dict):
            if any(t.keys() != first.keys() for t in trees):
                raise ValueError(f"tree structures differ: {trees!r}")
            return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
        out = [_tree_map(fn, *leaves) for leaves in zip(*trees)]
        if isinstance(first, list):
            return out
        return type(first)(*out) if hasattr(first, "_fields") else tuple(out)
    return fn(*trees)


class DistributedCommunicator(CommunicatorBase):
    """Communicator over the default ``torch.distributed`` process group.

    Args:
      device: ``cuda`` (default; NCCL) or ``cpu`` (gloo). Without a GPU
        and without ``device="cpu"`` it raises.
      allreduce_grad_dtype: communication dtype of :meth:`allreduce_grad`
        (e.g. ``torch.bfloat16``), or None for the gradients' own.
    """

    def __init__(self, device=None,
                 allreduce_grad_dtype: Optional[torch.dtype] = None):
        dev = resolve_device(device)
        self._owns_group = False
        if not dist.is_initialized():
            backend = "nccl" if dev.type == "cuda" else "gloo"
            if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
                dist.init_process_group(backend, init_method="env://")
            else:
                store = dist.TCPStore("localhost", 0, 1, is_master=True)
                dist.init_process_group(backend, store=store, rank=0,
                                        world_size=1)
            self._owns_group = True
        self._rank = dist.get_rank()
        self._size = dist.get_world_size()
        self._intra_size = int(os.environ.get("LOCAL_WORLD_SIZE",
                                              self._size))
        self._intra_rank = int(os.environ.get("LOCAL_RANK",
                                              self._rank % self._intra_size))
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", self._intra_rank
                                   % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        self.device = dev
        # the object plane: a gloo group over every rank (collective call)
        self._host = dist.new_group(backend="gloo")
        self.allreduce_grad_dtype = allreduce_grad_dtype
        self.name = "pure_nccl"

    # -- topology -------------------------------------------------------

    @property
    def size(self) -> int:
        return self._size

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def intra_rank(self) -> int:
        return self._intra_rank

    @property
    def intra_size(self) -> int:
        return self._intra_size

    @property
    def inter_rank(self) -> int:
        return self._rank // self._intra_size

    @property
    def inter_size(self) -> int:
        return -(-self._size // self._intra_size)

    # -- array collectives ----------------------------------------------

    def _op(self, op: str):
        if op not in _OPS:
            raise ValueError(f"unsupported allreduce op: {op!r}")
        return _OPS[op]

    def allreduce(self, x, op: str = "sum"):
        """All-reduce of this rank's tensor → a new tensor."""
        red = self._op(op)
        y = torch.as_tensor(x).clone()
        dist.all_reduce(y, red)
        return y / self._size if op == "mean" else y

    def bcast(self, x, root: int = 0):
        """``root``'s tensor on every rank (a new tensor)."""
        self._check_root(root)
        y = torch.as_tensor(x).clone().contiguous()
        dist.broadcast(y, root)
        return y

    def allgather(self, x):
        """Every rank's tensor stacked on axis 0 (rank order)."""
        x = torch.as_tensor(x).contiguous()
        out = [torch.empty_like(x) for _ in range(self._size)]
        dist.all_gather(out, x)
        return torch.stack(out)

    def split(self, color: int, key: int):
        raise NotImplementedError(f"split {_LATER}")

    def send(self, x, dest: int, tag: int = 0):
        raise NotImplementedError(f"send {_LATER}")

    def recv(self, src: int, tag: int = 0):
        raise NotImplementedError(f"recv {_LATER}")

    # -- object collectives (pickled over the gloo host group) ----------

    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        self._check_root(root)
        if self._size == 1:
            return obj
        box = [obj if self._rank == root else None]
        dist.broadcast_object_list(box, src=root, group=self._host)
        return box[0]

    def gather_obj(self, obj: Any, root: int = 0) -> Optional[List[Any]]:
        self._check_root(root)
        if self._size == 1:
            return [obj]
        out = [None] * self._size if self._rank == root else None
        dist.gather_object(obj, out, dst=root, group=self._host)
        return out

    def allgather_obj(self, obj: Any) -> List[Any]:
        if self._size == 1:
            return [obj]
        out = [None] * self._size
        dist.all_gather_object(out, obj, group=self._host)
        return out

    def allreduce_obj(self, obj: Any, op: str = "sum") -> Any:
        """Leafwise reduction of every rank's object (nested dicts, lists
        and tuples; any other value is a leaf). ``mean`` divides the sum
        by the rank count, so int leaves become floats."""
        if op not in _OBJ_OPS:
            raise ValueError(f"unsupported allreduce_obj op: {op!r}")
        objs = self.allgather_obj(obj)
        out = functools.reduce(
            lambda a, b: _tree_map(_OBJ_OPS[op], a, b), objs)
        if op == "mean":
            out = _tree_map(lambda x: x / len(objs), out)
        return out

    def scatter_obj(self, objs: Optional[Sequence[Any]],
                    root: int = 0) -> Any:
        self._check_root(root)
        if self._rank == root and (objs is None
                                   or len(objs) != self._size):
            raise ValueError(f"scatter_obj needs one object per rank "
                             f"({self._size}) on the root")
        if self._size == 1:
            return objs[0]
        out = [None]
        dist.scatter_object_list(
            out, list(objs) if self._rank == root else None, src=root,
            group=self._host)
        return objs[root] if self._rank == root else out[0]

    def _check_peer(self, peer: int) -> None:
        if self._size == 1:
            raise RuntimeError("point-to-point with a single rank has no "
                               "peer")
        self._check_root(peer)
        if peer == self._rank:
            raise ValueError(f"rank {peer} cannot message itself")

    def send_obj(self, obj: Any, dest: int, tag: int = 0) -> None:
        """Send ``obj`` to ``dest``: its pickled length, then its bytes,
        both under ``tag``. Messages of one tag arrive in order. Like the
        reference's MPI send (and unlike the JAX package's key-value
        store), it returns once ``dest`` has posted the matching
        :meth:`recv_obj`."""
        self._check_peer(dest)
        payload = torch.frombuffer(
            bytearray(pickle.dumps(obj, pickle.HIGHEST_PROTOCOL)),
            dtype=torch.uint8)
        dist.send(torch.tensor([payload.numel()], dtype=torch.int64), dest,
                  group=self._host, tag=tag)
        dist.send(payload, dest, group=self._host, tag=tag)

    def recv_obj(self, src: int, tag: int = 0) -> Any:
        self._check_peer(src)
        n = torch.empty(1, dtype=torch.int64)
        dist.recv(n, src, group=self._host, tag=tag)
        payload = torch.empty(int(n), dtype=torch.uint8)
        dist.recv(payload, src, group=self._host, tag=tag)
        # bytes a rank of this job pickled in send_obj
        return pickle.loads(payload.numpy().tobytes())

    # -- model-level ops ------------------------------------------------

    def _check_root(self, root: int) -> None:
        if not 0 <= root < self._size:
            raise ValueError(f"root {root} out of range for a size-"
                             f"{self._size} communicator")

    @torch.no_grad()
    def bcast_data(self, params, root: int = 0):
        """Overwrite every rank's parameters (and buffers, for a module)
        with ``root``'s, in place; returns ``params``."""
        self._check_root(root)
        for t in _tensors(params):
            dist.broadcast(t.data, root)
        return params

    @torch.no_grad()
    def allreduce_grad(self, grads: Iterable[torch.Tensor],
                       op: str = "mean"):
        """All-reduce gradients in place: a module's ``.grad`` tensors, or
        a dict or sequence of tensors. ``op="mean"`` is the mean over
        ranks of the per-rank gradients; returns ``grads``."""
        red = self._op(op)
        if isinstance(grads, nn.Module):
            leaves = [p.grad for p in grads.parameters()
                      if p.grad is not None]
        else:
            leaves = _tensors(grads)
        groups = {}
        for i, g in enumerate(leaves):
            cdt = self.allreduce_grad_dtype or g.dtype
            groups.setdefault((cdt, g.device), []).append(i)
        for (cdt, _), idxs in groups.items():
            item = torch.empty((), dtype=cdt).element_size()
            for bucket in plan_buckets(
                    [(i, leaves[i].numel() * item) for i in idxs],
                    DEFAULT_BUCKET_BYTES):
                flat = torch.cat([leaves[i].reshape(-1).to(cdt)
                                  for i in bucket])
                dist.all_reduce(flat, red)
                off = 0
                for i in bucket:
                    g = leaves[i]
                    piece = flat[off:off + g.numel()].view(g.shape).to(
                        g.dtype)
                    off += g.numel()
                    if op == "mean":
                        piece = piece / self._size
                    g.copy_(piece)
        return grads

    # -- misc -----------------------------------------------------------

    def barrier(self) -> None:
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def finalize(self) -> None:
        """Destroy the host group, and the process group if this
        communicator created it."""
        if dist.is_initialized():
            if self._owns_group:
                dist.destroy_process_group()
            elif self._host is not None:
                dist.destroy_process_group(self._host)
        self._owns_group = False
        self._host = None
