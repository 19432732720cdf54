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

Array ``send``/``recv`` (and :meth:`DistributedCommunicator.exchange`,
several of them at once) carry a tensor or a nested structure of
tensors: a header over a second gloo group (structure, shapes, dtypes,
tag and the pair's sequence number; :mod:`chainermn_torch.comm.p2p`),
then the payload over the array route. Sends never wait for the
receiver; their buffers are kept until sent. Over NCCL, which matches no
tags, a receiver must take one sender's messages in send order, and a
receive out of that order raises (the header's sequence number shows
it) rather than return another message's data. NCCL payloads go as
batches on the world's communicator, which the constructor creates and
connects pair by pair with one all-to-all.

``host_staged=True`` is the reference's ``non_cuda_aware`` communicator:
the world is gloo, tensors stay on the rank's GPU, and every array
collective, ``bcast_data``, ``allreduce_grad`` and ``send``/``recv``
copies through page-locked host buffers (``staged_bytes`` counts the
bytes copied each way). It is how several ranks share one GPU: NCCL
refuses two ranks on one device, and a NCCL communicator that finds
ranks sharing a GPU raises and names ``non_cuda_aware``; it never
switches on its own.

Sub-communicators. :meth:`DistributedCommunicator.over_mesh` gives the
communicator over some axes of a mesh of ranks (a ``torch.distributed.
device_mesh.DeviceMesh`` or the grid the factory builds for
``hierarchical``/``two_dimensional``), and :meth:`DistributedCommunicator.
split` the communicator over this rank's colour group, as
``MPI_Comm_split`` orders it. Each gets its own groups: the array route's
(NCCL, or gloo on the CPU and for host staging), and gloo groups for the
object collectives and the point-to-point headers. ``new_group`` is
collective over the whole world, so every rank creates the groups of every
rank's sub-communicator (the *family*: the groups that partition the
world, the same list on every rank), in the same order, and keeps its
own. A sub-communicator's ranks are dense in ``[0, size)`` in its own
order; collectives that return or take per-rank slots (``allgather``,
``gather``, ``scatter``, ``alltoall``, the tiled reduce-scatter and
all-gather) follow that order even where a reordering key makes it
differ from the group's ascending global ranks.
"""

from __future__ import annotations

import functools
import operator
import os
import pickle
import socket
import time
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from chainermn_torch.comm import p2p
from chainermn_torch.comm.base import CommunicatorBase
from chainermn_torch.device import resolve_device

__all__ = ["DistributedCommunicator", "plan_buckets",
           "DEFAULT_BUCKET_BYTES"]

#: flat gradient bucket (torch DDP's default size): few enough collectives
#: per step that their launch cost stays small, small enough that the
#: packed copy of a 135M-parameter model's gradients is not doubled at once
DEFAULT_BUCKET_BYTES = 25 * 2 ** 20

#: bytes of unfinished gloo sends a rank keeps before it waits for the
#: oldest (a gloo send finishes once the receiver has posted its receive)
PENDING_SEND_BYTES = 64 * 2 ** 20

#: the fixed size of a point-to-point header message (a longer header
#: sends its rest in a second message)
HEADER_BYTES = 1024

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


def grad_tensors(grads) -> List[torch.Tensor]:
    """The tensors a gradient reduction writes: a module's ``.grad``
    tensors (of the parameters that have one), or a dict's or a
    sequence's tensors."""
    if isinstance(grads, nn.Module):
        return [p.grad for p in grads.parameters() if p.grad is not None]
    return _tensors(grads)


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


_SHARED_GPU = ("{} share one GPU; NCCL refuses two ranks on one device. "
               "Run several ranks on one card with "
               "create_communicator('non_cuda_aware') (host-staged, gloo)")


def duplicate_devices(ids: Sequence[Any]) -> List[List[int]]:
    """Groups of ranks (each of two or more) whose device ids are equal;
    ``ids[r]`` is rank r's ``(host, GPU)``."""
    where = {}
    for r, i in enumerate(ids):
        where.setdefault(i, []).append(r)
    return [rs for rs in where.values() if len(rs) > 1]


def _device_id(dev: torch.device):
    """This host and the GPU's UUID (its index where torch gives none)."""
    props = torch.cuda.get_device_properties(dev)
    return socket.gethostname(), str(getattr(props, "uuid", dev.index))


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
      host_staged: the ``non_cuda_aware`` path (module docstring): a gloo
        world whose array operations copy through host memory.
      dcn_bucket_bytes: the bucket of :meth:`allreduce_grad` (None:
        ``DEFAULT_BUCKET_BYTES``), and the default bucket of the gradient
        reducers (``chainermn_torch.collectives``; None: their 4 MiB).
    """

    def __init__(self, device=None,
                 allreduce_grad_dtype: Optional[torch.dtype] = None,
                 host_staged: bool = False,
                 dcn_bucket_bytes: Optional[int] = None):
        dev = resolve_device(device)
        self._owns_group = False
        self._host = None
        if not dist.is_initialized():
            backend = ("nccl" if dev.type == "cuda" and not host_staged
                       else "gloo")
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
        self._inter_rank = self._rank // self._intra_size
        self._inter_size = -(-self._size // self._intra_size)
        self._ranks_per_node = self._intra_size
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", self._intra_rank
                                   % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        self.device = dev
        # the object plane: a gloo group over every rank (collective call)
        self._host = dist.new_group(backend="gloo")
        # array point-to-point headers (and gloo payloads): their own
        # group, so their tags never meet send_obj's
        self._p2p = dist.new_group(backend="gloo")
        gloo_world = dist.get_backend() == "gloo"
        self._host_staged = host_staged and dev.type == "cuda"
        # array collectives' group: the world, or for a host-staged
        # communicator in a NCCL world a gloo group over every rank
        self._arrays = (dist.new_group(backend="gloo")
                        if host_staged and not gloo_world else None)
        self._nccl_p2p = not gloo_world and not host_staged
        self._channels = p2p.Channels(ordered=self._nccl_p2p)
        self._pending: List[Tuple[Any, torch.Tensor]] = []
        self._pending_bytes = 0
        self.staged_bytes = 0
        #: host seconds spent in :meth:`exchange` (waiting for the peers
        #: included): what a pipeline's hops cost its ranks
        self.exchange_seconds = 0.0
        self.allreduce_grad_dtype = allreduce_grad_dtype
        self._bucket_bytes = dcn_bucket_bytes
        self.name = "non_cuda_aware" if host_staged else "pure_nccl"
        #: bytes this rank handed to the reduction collectives (the
        #: buffer of each all-reduce, the input of each reduce-scatter and
        #: all-gather): what the gradient reducers put on the wire
        self.collective_bytes = 0
        # the world as a mesh of one axis; the family is the list of
        # groups that partition the world into communicators like this one
        self._members = tuple(range(self._size))
        self._family = (self._members,)
        self._perm = None
        self._grid = np.arange(self._size)
        self._dims = self._axes = ("r",)
        self._world_host = self._host
        self._device_mesh = None
        self._finalize_with = None
        self._own_groups = ()
        self._obj_plane = None
        if self._nccl_p2p and self._size > 1:
            shared = duplicate_devices(self.allgather_obj(_device_id(dev)))
            if shared:
                self.finalize()
                raise RuntimeError(_SHARED_GPU.format(f"ranks {shared}"))
            # make the world's NCCL communicator and connect every pair of
            # ranks now, with an all-to-all of 1 MiB a pair (large enough
            # to open the channels a large message uses): NCCL's first
            # send to a peer blocks until that peer's first NCCL call,
            # which a receiver still waiting for another header never
            # makes; and the point-to-point batches ride this communicator
            probe = torch.zeros(self._size * 2 ** 18, device=dev)
            dist.all_to_all_single(torch.empty_like(probe), probe)

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
        return self._inter_rank

    @property
    def inter_size(self) -> int:
        return self._inter_size

    @property
    def members(self) -> Tuple[int, ...]:
        """The world ranks of this communicator, in its rank order."""
        return self._members

    @property
    def global_index(self) -> int:
        """This process's world rank: a position in the world, not a rank
        of this communicator (never a root or a peer here)."""
        return self._members[self._rank]

    # -- the mesh -------------------------------------------------------

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The mesh axes this communicator reduces over."""
        return self._axes

    @property
    def axis_name(self) -> str:
        """The single axis name; a communicator over several axes raises
        (split it, or use :attr:`axis_names`)."""
        if len(self._axes) != 1:
            raise ValueError(f"communicator spans axes {self._axes}; use "
                             f".axis_names or split()")
        return self._axes[0]

    @property
    def mesh_shape(self) -> dict:
        """Mesh axis name → its size."""
        return dict(zip(self._dims, self._grid.shape))

    @property
    def mesh(self):
        """The mesh as a ``torch.distributed.device_mesh.DeviceMesh`` with
        ``mesh_dim_names`` (the one given to :meth:`over_mesh`, or one
        made on first use without process groups of its own: this
        communicator's collectives run on groups it made itself)."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            self._device_mesh = DeviceMesh(
                self.device.type, torch.as_tensor(self._grid),
                mesh_dim_names=self._dims, _init_backend=False)
        return self._device_mesh

    # -- sub-communicators ----------------------------------------------

    def over_mesh(self, mesh, axes: Optional[Sequence[str]] = None
                  ) -> "DistributedCommunicator":
        """The communicator over ``axes`` (default: all of them) of
        ``mesh``: a ``DeviceMesh`` with ``mesh_dim_names``, or a
        ``(grid, names)`` pair (an integer array of world ranks and its
        axis names). Its ranks walk the mesh along ``axes`` in row-major
        order, the other coordinates fixed at this rank's. Every rank of
        the world must call it with the same mesh and axes."""
        if isinstance(mesh, tuple):
            grid, dims = mesh
            device_mesh = None
        else:
            grid, dims, device_mesh = mesh.mesh, mesh.mesh_dim_names, mesh
            if dims is None:
                raise ValueError("the DeviceMesh needs mesh_dim_names")
        grid = np.asarray(torch.as_tensor(grid).cpu(), dtype=np.int64)
        dims = tuple(dims)
        if len(dims) != grid.ndim:
            raise ValueError(f"{len(dims)} axis names for a {grid.ndim}-D "
                             f"mesh")
        axes = tuple(axes) if axes else dims
        for a in axes:
            if a not in dims:
                raise ValueError(f"axis {a!r} not in mesh axes {dims}")
        others = [i for i, d in enumerate(dims) if d not in axes]
        order = others + [dims.index(a) for a in axes]
        size = int(np.prod([grid.shape[dims.index(a)] for a in axes]))
        family = tuple(tuple(int(r) for r in row) for row in
                       np.transpose(grid, order).reshape(-1, size))
        sub = self._derive(family)
        sub._grid, sub._dims, sub._axes = grid, dims, axes
        sub._device_mesh = device_mesh
        return sub

    def split(self, color, key=None, rank: Optional[int] = None
              ) -> "DistributedCommunicator":
        """The communicator over this rank's colour group
        (``MPI_Comm_split``). ``color`` is this rank's colour (an int, the
        reference's per-rank form), every rank's colour (a sequence of
        ``size``), or the closed forms ``("block", k)`` (groups of ``k``
        consecutive ranks) and ``("stride", k)`` (``size // k`` groups,
        rank ``r`` in group ``r % (size // k)``). ``key`` orders a group
        by ``(key, rank)``: this rank's key with an int colour, every
        rank's keys with the other forms (a scalar key there carries no
        order and is ignored, as all-equal keys are). Every rank of the
        world calls it (group creation is collective over the world);
        ranks of different parent communicators may split differently.
        ``rank``, if given, must be this rank: a process drives only the
        groups it belongs to."""
        if rank is not None and rank != self._rank:
            raise ValueError(f"split(rank={rank}) on rank {self._rank}: a "
                             f"process can drive only its own group")
        n = self._size
        if isinstance(color, (int, np.integer)):
            spec = ("rank", int(color), None if key is None else int(key))
        else:
            if (isinstance(color, tuple) and len(color) == 2
                    and color[0] in ("block", "stride")):
                kind, k = color
                if k <= 0 or n % k:
                    raise ValueError(f"group size {k} does not divide "
                                     f"world {n}")
                colors = ([r // k for r in range(n)] if kind == "block"
                          else [r % (n // k) for r in range(n)])
            else:
                colors = [int(c) for c in color]
                if len(colors) != n:
                    raise ValueError(f"need {n} colors, got {len(colors)}")
            keys = None
            if key is not None and not isinstance(key, (int, np.integer)):
                keys = [int(k) for k in key]
                if len(keys) != n:
                    raise ValueError(f"need {n} keys, got {len(keys)}")
            spec = ("all", tuple(colors), None if keys is None
                    else tuple(keys))
        specs = [None] * dist.get_world_size()
        dist.all_gather_object(specs, spec, group=self._world_host)
        family = []
        for sib in self._family:
            mine = [specs[g] for g in sib]
            if mine[0][0] == "rank":
                if any(m[0] != "rank" for m in mine):
                    raise ValueError("split: every rank of a communicator "
                                     "must use the same form of colour")
                colors = [m[1] for m in mine]
                keys = [i if m[2] is None else m[2]
                        for i, m in enumerate(mine)]
            else:
                if any(m != mine[0] for m in mine):
                    raise ValueError("split: the ranks of a communicator "
                                     "passed different colour sequences")
                colors = list(mine[0][1])
                keys = list(mine[0][2] or range(len(sib)))
            for c in sorted(set(colors)):
                group = sorted((i for i in range(len(sib))
                                if colors[i] == c),
                               key=lambda i: (keys[i], i))
                family.append(tuple(sib[i] for i in group))
        sub = self._derive(tuple(family))
        name = f"{self._axes[0]}_split"
        sub._grid, sub._dims, sub._axes = (np.asarray(sub._members),
                                           (name,), (name,))
        return sub

    def _derive(self, family) -> "DistributedCommunicator":
        """A communicator over this rank's group of ``family`` (groups of
        world ranks in rank order that partition the world, the same on
        every rank). Every rank creates every group, in family order; a
        family that is this communicator's own reuses its groups."""
        me = dist.get_rank()
        if sorted(g for grp in family for g in grp) != list(
                range(dist.get_world_size())):
            raise ValueError(f"groups {family} do not partition the world")
        sub = object.__new__(type(self))
        sub.__dict__.update(self.__dict__)
        sub._finalize_with = None
        sub._device_mesh = None
        sub._obj_plane = None
        sub.collective_bytes = sub.staged_bytes = 0
        sub.exchange_seconds = 0.0
        sub._family = tuple(tuple(g) for g in family)
        members = next(g for g in sub._family if me in g)
        sub._members = members
        sub._rank = members.index(me)
        sub._size = len(members)
        order = sorted(members)
        perm = [order.index(g) for g in members]
        sub._perm = None if perm == list(range(len(perm))) else perm
        sub._owns_group = False
        if sub._family == self._family and members == self._members:
            sub._own_groups = None      # the parent's groups: destroys none
            return sub
        gloo_world = dist.get_backend() == "gloo"
        backend = "gloo" if gloo_world or self._host_staged else "nccl"
        own = []
        for grp in sub._family:
            made = (dist.new_group(list(grp), backend=backend),
                    dist.new_group(list(grp), backend="gloo"),
                    dist.new_group(list(grp), backend="gloo"))
            if grp == members:
                own = made
        sub._arrays, sub._host, sub._p2p = own
        sub._own_groups = own
        sub._channels = p2p.Channels(ordered=self._nccl_p2p)
        sub._pending, sub._pending_bytes = [], 0
        # node-local counts among the group's members, as the reference's
        # hostname split gives them
        node = self._ranks_per_node
        nodes = sorted({g // node for g in members})
        local = [g for g in members if g // node == me // node]
        sub._intra_rank = local.index(me)
        sub._intra_size = len(local)
        sub._inter_rank = nodes.index(me // node)
        sub._inter_size = len(nodes)
        if self._nccl_p2p and sub._size > 1:
            # connect the subgroup's pairs now (see __init__)
            probe = torch.zeros(sub._size * 2 ** 18, device=self.device)
            dist.all_to_all_single(torch.empty_like(probe), probe,
                                   group=sub._arrays)
        return sub

    def _g(self, r: int) -> int:
        """World rank of this communicator's rank ``r``."""
        return self._members[r]

    def _to_group(self, items: Sequence[Any]) -> List[Any]:
        """Per-rank slots in this communicator's order → the group's
        (ascending world ranks), which ``torch.distributed`` uses."""
        if self._perm is None:
            return list(items)
        out = [None] * self._size
        for i, p in enumerate(self._perm):
            out[p] = items[i]
        return out

    def _from_group(self, items: Sequence[Any]) -> List[Any]:
        """Per-rank slots in the group's order → this communicator's."""
        if self._perm is None:
            return list(items)
        return [items[p] for p in self._perm]

    # -- host staging (the non_cuda_aware path) ------------------------

    def _out(self, t: torch.Tensor, copy: bool = False) -> torch.Tensor:
        """``t`` as the array route takes it: contiguous (a new tensor
        with ``copy``), and for a host-staged communicator copied into
        page-locked host memory."""
        if not self._host_staged or t.device.type != "cuda":
            return t.clone(memory_format=torch.contiguous_format) \
                if copy else t.contiguous()
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        self.staged_bytes += buf.numel() * buf.element_size()
        return buf

    def _in(self, buf: torch.Tensor) -> torch.Tensor:
        """A tensor the array route delivered, on this rank's device."""
        if not self._host_staged:
            return buf
        self.staged_bytes += buf.numel() * buf.element_size()
        return buf.to(self.device)

    def _empty(self, shape, dtype) -> torch.Tensor:
        """A receive buffer on the array route."""
        if self._host_staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    # -- array collectives ----------------------------------------------

    def _op(self, op: str):
        if op not in _OPS:
            raise ValueError(f"unsupported allreduce op: {op!r}")
        return _OPS[op]

    def allreduce(self, x, op: str = "sum"):
        """All-reduce of this rank's tensor → a new tensor. A meta tensor
        (shapes only: the pipelines' ``eval_shape``) passes through."""
        red = self._op(op)
        x = torch.as_tensor(x)
        if x.is_meta:
            y = x.clone()
        else:
            buf = self._out(x, copy=True)
            dist.all_reduce(buf, red, group=self._arrays)
            y = self._in(buf)
        return y / self._size if op == "mean" else y

    def bcast(self, x, root: int = 0):
        """``root``'s tensor on every rank (a new tensor)."""
        self._check_root(root)
        x = torch.as_tensor(x)
        buf = (self._out(x, copy=True) if self._rank == root
               else self._empty(x.shape, x.dtype))
        dist.broadcast(buf, self._g(root), group=self._arrays)
        return self._in(buf)

    def allgather(self, x):
        """Every rank's tensor stacked on axis 0 (rank order)."""
        buf = self._out(torch.as_tensor(x))
        out = [self._empty(buf.shape, buf.dtype) for _ in range(self._size)]
        dist.all_gather(out, buf, group=self._arrays)
        return self._in(torch.stack(self._from_group(out)))

    def alltoall(self, x):
        """``x``'s leading axis splits into ``size`` equal chunks: chunk
        ``s`` goes to rank ``s``, and chunk ``r`` of the result is rank
        ``r``'s chunk for this rank."""
        x = torch.as_tensor(x)
        if x.ndim == 0 or x.shape[0] % self._size:
            raise ValueError(f"alltoall expects a leading axis divisible "
                             f"by {self._size}, got shape "
                             f"{tuple(x.shape)}")
        if self._perm is not None:
            x = torch.cat(self._to_group(x.chunk(self._size)))
        buf = self._out(x)
        out = self._empty(buf.shape, buf.dtype)
        dist.all_to_all_single(out, buf, group=self._arrays)
        out = self._in(out)
        if self._perm is not None:
            out = torch.cat(self._from_group(out.chunk(self._size)))
        return out

    def gather(self, x, root: int = 0):
        """Every rank's tensor stacked in rank order on ``root``; None on
        the other ranks (the reference's ``gather``)."""
        self._check_root(root)
        buf = self._out(torch.as_tensor(x))
        out = ([self._empty(buf.shape, buf.dtype)
                for _ in range(self._size)]
               if self._rank == root else None)
        dist.gather(buf, out, dst=self._g(root), group=self._arrays)
        return (self._in(torch.stack(self._from_group(out)))
                if out is not None else None)

    def scatter(self, x, root: int = 0):
        """``x[rank]`` of ``root``'s tensor ``x`` (leading axis ``size``)
        on each rank; the other ranks' ``x`` is not read (None will do):
        the shape and dtype come from the root."""
        self._check_root(root)
        meta = None
        if self._rank == root:
            x = torch.as_tensor(x)
            if x.ndim == 0 or x.shape[0] != self._size:
                raise ValueError(f"scatter expects a leading axis of "
                                 f"{self._size} on the root, got shape "
                                 f"{tuple(x.shape)}")
            meta = (tuple(x.shape[1:]), str(x.dtype))
        shape, dtype = self.bcast_obj(meta, root)
        out = self._empty(shape, p2p.parse_dtype(dtype))
        parts = (self._to_group(list(self._out(x).unbind(0)))
                 if self._rank == root else None)
        dist.scatter(out, parts, src=self._g(root), group=self._arrays)
        return self._in(out)

    # -- flat reductions (the gradient reducers' collectives) -----------

    def _count(self, t: torch.Tensor) -> None:
        self.collective_bytes += t.numel() * t.element_size()

    def reduce_flat(self, flat: torch.Tensor, op: str = "sum"
                    ) -> torch.Tensor:
        """All-reduce of a contiguous vector, in place where the route
        allows (the result is returned; ``op="mean"`` is the sum)."""
        buf = self._out(flat)
        self._count(buf)
        dist.all_reduce(buf, self._op(op), group=self._arrays)
        return self._in(buf)

    def reduce_scatter_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum-reduce-scatter of a vector whose length ``size`` divides:
        rank ``r`` gets tile ``r`` (a new tensor)."""
        n = self._size
        if flat.numel() % n:
            raise ValueError(f"reduce_scatter_flat: length {flat.numel()} "
                             f"is not a multiple of {n}")
        if self._perm is not None:
            flat = torch.cat(self._to_group(flat.chunk(n)))
        buf = self._out(flat)
        self._count(buf)
        out = self._empty((flat.numel() // n,), flat.dtype)
        dist.reduce_scatter_tensor(out, buf, group=self._arrays)
        return self._in(out)

    def all_gather_flat(self, tile: torch.Tensor,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Every rank's tile, concatenated in rank order; into ``out`` (a
        contiguous vector on this rank's device, returned) when given:
        written by the collective itself where nothing is staged or
        reordered."""
        buf = self._out(tile)
        self._count(buf)
        n = tile.numel() * self._size
        if out is not None and not self._host_staged and self._perm is None:
            dist.all_gather_into_tensor(out, buf, group=self._arrays)
            return out
        full = self._empty((n,), tile.dtype)
        dist.all_gather_into_tensor(full, buf, group=self._arrays)
        full = self._in(full)
        if self._perm is not None:
            full = torch.cat(self._from_group(full.chunk(self._size)))
        if out is None:
            return full
        return out.copy_(full)

    # -- array point-to-point -------------------------------------------

    def send(self, x, dest: int, tag: int = 0):
        """Send a tensor or a nested structure of tensors to ``dest`` on
        the channel ``tag``. It returns at once; the receiver learns the
        structure, shapes and dtypes from the message's header."""
        self.exchange(sends=[(dest, tag, x)])

    def recv(self, src: int, tag: int = 0):
        """The next message ``src`` sent to this rank on ``tag``, on this
        rank's device."""
        return self.exchange(recvs=[(src, tag)])[0]

    def exchange(self, sends: Sequence[Tuple[int, int, Any]] = (),
                 recvs: Sequence[Tuple[int, int]] = ()) -> List[Any]:
        """Several point-to-point messages at once: ``sends`` of
        ``(dest, tag, tree)`` and ``recvs`` of ``(src, tag)``; returns the
        received trees in ``recvs``' order. Headers go first, every send
        before any receive, so two ranks may swap messages in one call.
        The call's host time adds to ``exchange_seconds``."""
        t0 = time.perf_counter()
        try:
            return self._exchange(sends, recvs)
        finally:
            self.exchange_seconds += time.perf_counter() - t0

    def _exchange(self, sends, recvs) -> List[Any]:
        outgoing, wanted = [], []
        for dest, tag, tree in sends:
            self._check_peer(dest)
            p2p.check_tag(tag)
            leaves, spec = p2p.flatten(tree)
            leaves = [t.detach() for t in leaves]
            header = self._channels.header(dest, tag, spec, leaves)
            self._isend_header(header, self._g(dest),
                               p2p.wire_tags(tag)[0])
            outgoing.append((dest, tag, leaves))
        for src, tag in recvs:
            self._check_peer(src)
            p2p.check_tag(tag)
            header = self._recv_header(self._g(src),
                                       p2p.wire_tags(tag)[0])
            wanted.append((src, tag, header,
                           self._channels.accept(src, tag, header)))
        if self._nccl_p2p:
            return self._nccl_payloads(outgoing, wanted)
        for dest, tag, leaves in outgoing:
            for t in leaves:
                buf = self._out(t)
                self._keep(dist.isend(buf, self._g(dest),
                                      group=self._p2p,
                                      tag=p2p.wire_tags(tag)[1]), buf)
        out = []
        for src, tag, header, metas in wanted:
            bufs = [self._empty(shape, dtype) for shape, dtype in metas]
            works = [dist.irecv(b, self._g(src), group=self._p2p,
                                tag=p2p.wire_tags(tag)[1]) for b in bufs]
            for w in works:
                w.wait()
            out.append(p2p.unflatten(header["spec"],
                                     [self._in(b) for b in bufs]))
        return out

    def _nccl_payloads(self, outgoing, wanted):
        """The payloads over NCCL, as one batch: NCCL groups the sends
        and receives, so two ranks may swap messages, and the batch rides
        the world's communicator (made and connected at construction)."""
        ops = [dist.P2POp(dist.isend, t.to(self.device).contiguous(),
                          self._g(dest), group=self._arrays)
               for dest, _, leaves in outgoing for t in leaves]
        received = []
        for src, _, header, metas in wanted:
            bufs = [self._empty(shape, dtype) for shape, dtype in metas]
            ops += [dist.P2POp(dist.irecv, b, self._g(src),
                               group=self._arrays) for b in bufs]
            received.append((header["spec"], bufs))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return [p2p.unflatten(spec, bufs) for spec, bufs in received]

    def _keep(self, work, buf: torch.Tensor) -> None:
        """Hold an unfinished gloo send's buffer; past
        ``PENDING_SEND_BYTES`` wait for the oldest sends."""
        self._pending.append((work, buf))
        self._pending_bytes += buf.numel() * buf.element_size()
        while self._pending and self._pending_bytes > PENDING_SEND_BYTES:
            self._pop_pending()

    def _pop_pending(self) -> None:
        work, buf = self._pending.pop(0)
        work.wait()
        self._pending_bytes -= buf.numel() * buf.element_size()

    def _drain(self) -> None:
        """Wait for every unfinished send."""
        while self._pending:
            self._pop_pending()

    def _isend_header(self, header: dict, dest: int, tag: int) -> None:
        """A header as one message of ``HEADER_BYTES`` (its pickle's
        length, then the pickle), and what does not fit as a second: one
        round of gloo's rendezvous for a usual header instead of two."""
        raw = pickle.dumps(header, pickle.HIGHEST_PROTOCOL)
        first = bytearray(HEADER_BYTES)
        first[:8] = len(raw).to_bytes(8, "little")
        first[8:8 + len(raw)] = raw[:HEADER_BYTES - 8]
        parts = [first]
        if len(raw) > HEADER_BYTES - 8:
            parts.append(bytearray(raw[HEADER_BYTES - 8:]))
        for part in parts:
            t = torch.frombuffer(part, dtype=torch.uint8)
            self._keep(dist.isend(t, dest, group=self._p2p, tag=tag), t)

    def _recv_header(self, src: int, tag: int) -> dict:
        first = torch.empty(HEADER_BYTES, dtype=torch.uint8)
        dist.recv(first, src, group=self._p2p, tag=tag)
        first = first.numpy().tobytes()
        n = int.from_bytes(first[:8], "little")
        raw = first[8:8 + n]
        if n > HEADER_BYTES - 8:
            rest = torch.empty(n - (HEADER_BYTES - 8), dtype=torch.uint8)
            dist.recv(rest, src, group=self._p2p, tag=tag)
            raw += rest.numpy().tobytes()
        # a header a rank of this job pickled in _isend_header
        return pickle.loads(raw)

    # -- object collectives (pickled over the gloo host group) ----------

    def bcast_obj(self, obj: Any, root: int = 0) -> Any:
        self._check_root(root)
        if self._size == 1:
            return obj
        box = [obj if self._rank == root else None]
        dist.broadcast_object_list(box, src=self._g(root),
                                   group=self._host)
        return box[0]

    def gather_obj(self, obj: Any, root: int = 0) -> Optional[List[Any]]:
        self._check_root(root)
        if self._size == 1:
            return [obj]
        out = [None] * self._size if self._rank == root else None
        dist.gather_object(obj, out, dst=self._g(root), group=self._host)
        return None if out is None else self._from_group(out)

    def allgather_obj(self, obj: Any) -> List[Any]:
        if self._size == 1:
            return [obj]
        out = [None] * self._size
        dist.all_gather_object(out, obj, group=self._host)
        return self._from_group(out)

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
            out, self._to_group(list(objs)) if self._rank == root else None,
            src=self._g(root), group=self._host)
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
        dest = self._g(dest)
        dist.send(torch.tensor([payload.numel()], dtype=torch.int64), dest,
                  group=self._host, tag=tag)
        dist.send(payload, dest, group=self._host, tag=tag)

    def recv_obj(self, src: int, tag: int = 0) -> Any:
        self._check_peer(src)
        src = self._g(src)
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
            buf = (self._out(t.data) if self._rank == root
                   or not self._host_staged
                   else self._empty(t.shape, t.dtype))
            dist.broadcast(buf, self._g(root), group=self._arrays)
            if buf.data_ptr() != t.data.data_ptr():
                t.data.copy_(self._in(buf))
        return params

    @torch.no_grad()
    def allreduce_grad(self, grads: Iterable[torch.Tensor],
                       op: str = "mean"):
        """All-reduce gradients in place: a module's ``.grad`` tensors, or
        a dict or sequence of tensors. ``op="mean"`` is the mean over
        ranks of the per-rank gradients; returns ``grads``. Buckets hold
        at most :attr:`grad_bucket_bytes`."""
        self._op(op)
        leaves = grad_tensors(grads)
        groups = {}
        for i, g in enumerate(leaves):
            cdt = self.allreduce_grad_dtype or g.dtype
            groups.setdefault((cdt, g.device), []).append(i)
        for (cdt, _), idxs in groups.items():
            item = torch.empty((), dtype=cdt).element_size()
            for bucket in plan_buckets(
                    [(i, leaves[i].numel() * item) for i in idxs],
                    self.grad_bucket_bytes):
                flat = self.reduce_flat(torch.cat(
                    [leaves[i].reshape(-1).to(cdt) for i in bucket]), op)
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

    @property
    def grad_bucket_bytes(self) -> int:
        """The bucket of :meth:`allreduce_grad`: ``dcn_bucket_bytes``, or
        ``DEFAULT_BUCKET_BYTES``."""
        return self._bucket_bytes or DEFAULT_BUCKET_BYTES

    # -- the store-backed host plane --------------------------------------

    @property
    def object_plane(self):
        """This communicator's :class:`~chainermn_torch.comm.object_plane.
        ObjectPlane`: object messages over the world's store, whose every
        wait is guarded (the abort key, the store's liveness). Its
        ``send_obj`` returns without waiting for the receiver."""
        if self._obj_plane is None:
            from chainermn_torch.comm.object_plane import ObjectPlane

            world = self._members == tuple(range(dist.get_world_size()))
            self._obj_plane = ObjectPlane(
                self._rank, self._size, namespace="" if world else
                "g" + "_".join(map(str, self._members)))
        return self._obj_plane

    def host_barrier(self, timeout_ms: Optional[int] = None) -> None:
        """Barrier over the store (JAX ``host_barrier``): every wait is
        guarded, so a dead peer yields a bounded ``JobAbortedError`` or
        ``TimeoutError``, not an endless rendezvous. For host-side sync
        points (checkpoint elections); :meth:`barrier` stays the array
        route's barrier."""
        self.object_plane.barrier(timeout_ms)

    # -- misc -----------------------------------------------------------

    def barrier(self) -> None:
        """Wait for every rank (and for this rank's unfinished sends)."""
        self._drain()
        if dist.get_backend(self._arrays) == "nccl":
            dist.barrier(group=self._arrays, device_ids=[self.device.index])
        else:
            dist.barrier(group=self._arrays)

    def finalize(self) -> None:
        """Wait for unfinished sends, then destroy this communicator's
        groups, and the process group if this communicator created
        it."""
        if self._host is None:
            return
        self._drain()
        if dist.is_initialized():
            if self._owns_group:
                dist.destroy_process_group()
            elif self._own_groups is not None:
                # a world communicator's groups, or a sub-communicator's
                # own (one that reuses its parent's has None)
                for g in (self._own_groups or (self._host, self._p2p,
                                               self._arrays)):
                    if g is not None:
                        dist.destroy_process_group(g)
        self._owns_group = False
        self._host = None
        if self._finalize_with is not None:
            self._finalize_with.finalize()
