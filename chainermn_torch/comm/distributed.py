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

Waiting for a later slice (``NotImplementedError``, ROADMAP.md queue 1
item 2): ``split``.
"""

from __future__ import annotations

import functools
import operator
import os
import pickle
import socket
from typing import Any, Iterable, List, Optional, Sequence, Tuple

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
    """

    def __init__(self, device=None,
                 allreduce_grad_dtype: Optional[torch.dtype] = None,
                 host_staged: bool = False):
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
        self.allreduce_grad_dtype = allreduce_grad_dtype
        self.name = "non_cuda_aware" if host_staged else "pure_nccl"
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
        return self._rank // self._intra_size

    @property
    def inter_size(self) -> int:
        return -(-self._size // self._intra_size)

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
        """All-reduce of this rank's tensor → a new tensor."""
        red = self._op(op)
        buf = self._out(torch.as_tensor(x), copy=True)
        dist.all_reduce(buf, red, group=self._arrays)
        y = self._in(buf)
        return y / self._size if op == "mean" else y

    def bcast(self, x, root: int = 0):
        """``root``'s tensor on every rank (a new tensor)."""
        self._check_root(root)
        x = torch.as_tensor(x)
        buf = (self._out(x, copy=True) if self._rank == root
               else self._empty(x.shape, x.dtype))
        dist.broadcast(buf, root, group=self._arrays)
        return self._in(buf)

    def allgather(self, x):
        """Every rank's tensor stacked on axis 0 (rank order)."""
        buf = self._out(torch.as_tensor(x))
        out = [self._empty(buf.shape, buf.dtype) for _ in range(self._size)]
        dist.all_gather(out, buf, group=self._arrays)
        return self._in(torch.stack(out))

    def alltoall(self, x):
        """``x``'s leading axis splits into ``size`` equal chunks: chunk
        ``s`` goes to rank ``s``, and chunk ``r`` of the result is rank
        ``r``'s chunk for this rank."""
        x = torch.as_tensor(x)
        if x.ndim == 0 or x.shape[0] % self._size:
            raise ValueError(f"alltoall expects a leading axis divisible "
                             f"by {self._size}, got shape "
                             f"{tuple(x.shape)}")
        buf = self._out(x)
        out = self._empty(buf.shape, buf.dtype)
        dist.all_to_all_single(out, buf, group=self._arrays)
        return self._in(out)

    def gather(self, x, root: int = 0):
        """Every rank's tensor stacked in rank order on ``root``; None on
        the other ranks (the reference's ``gather``)."""
        self._check_root(root)
        buf = self._out(torch.as_tensor(x))
        out = ([self._empty(buf.shape, buf.dtype)
                for _ in range(self._size)]
               if self._rank == root else None)
        dist.gather(buf, out, dst=root, group=self._arrays)
        return self._in(torch.stack(out)) if out is not None else None

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
        parts = (list(self._out(x).unbind(0)) if self._rank == root
                 else None)
        dist.scatter(out, parts, src=root, group=self._arrays)
        return self._in(out)

    def split(self, color: int, key: int):
        raise NotImplementedError(f"split {_LATER}")

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
        before any receive, so two ranks may swap messages in one call."""
        outgoing, wanted = [], []
        for dest, tag, tree in sends:
            self._check_peer(dest)
            p2p.check_tag(tag)
            leaves, spec = p2p.flatten(tree)
            leaves = [t.detach() for t in leaves]
            header = self._channels.header(dest, tag, spec, leaves)
            self._isend_header(header, dest, p2p.wire_tags(tag)[0])
            outgoing.append((dest, tag, leaves))
        for src, tag in recvs:
            self._check_peer(src)
            p2p.check_tag(tag)
            header = self._recv_header(src, p2p.wire_tags(tag)[0])
            wanted.append((src, tag, header,
                           self._channels.accept(src, tag, header)))
        if self._nccl_p2p:
            return self._nccl_payloads(outgoing, wanted)
        for dest, tag, leaves in outgoing:
            for t in leaves:
                buf = self._out(t)
                self._keep(dist.isend(buf, dest, group=self._p2p,
                                      tag=p2p.wire_tags(tag)[1]), buf)
        out = []
        for src, tag, header, metas in wanted:
            bufs = [self._empty(shape, dtype) for shape, dtype in metas]
            works = [dist.irecv(b, src, group=self._p2p,
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
        ops = [dist.P2POp(dist.isend, t.to(self.device).contiguous(), dest)
               for dest, _, leaves in outgoing for t in leaves]
        received = []
        for src, _, header, metas in wanted:
            bufs = [self._empty(shape, dtype) for shape, dtype in metas]
            ops += [dist.P2POp(dist.irecv, b, src) for b in bufs]
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
            buf = (self._out(t.data) if self._rank == root
                   or not self._host_staged
                   else self._empty(t.shape, t.dtype))
            dist.broadcast(buf, root, group=self._arrays)
            if buf.data_ptr() != t.data.data_ptr():
                t.data.copy_(self._in(buf))
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
                buf = self._out(flat)
                dist.all_reduce(buf, red, group=self._arrays)
                flat = self._in(buf)
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
        """Wait for every rank (and for this rank's unfinished sends)."""
        self._drain()
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

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
            else:
                for g in (self._host, self._p2p, self._arrays):
                    if g is not None:
                        dist.destroy_process_group(g)
        self._owns_group = False
        self._host = None
