"""GradReducer — the strategy registry for gradient reduction.

Counterpart of ``chainermn_tpu/collectives/base.py``. ChainerMN's
communicator zoo was a set of algorithms for turning per-rank gradients
into reduced ones: ``pure_nccl`` (one flat ring, optional fp16 wire),
``hierarchical`` (intra-node reduce → inter-node all-reduce → intra-node
broadcast), ``two_dimensional`` (reduce-scatter / all-reduce /
all-gather). A :class:`GradReducer` owns that choice:

==============  =====================================================
``flat``        ``comm.allreduce_grad`` — the default, the numerical
                reference
``hierarchical``  reduce-scatter over the fast (intra) tier →
                all-reduce over the inter tier → all-gather
``quantized``   bf16/int8/blockwise-scaled all-reduce with
                error-feedback residuals carried as reducer state
``auto``        a latency/bandwidth cost model picks one of the above
                per bucket
==============  =====================================================

Each process of the port is one rank holding its own gradient, so two
pieces of the JAX module have no meaning here and are not imitated: the
varying-axes ("vma") passthrough of leaves that autodiff already summed,
and the quantized reducer's pre-scaling of such leaves by their
over-count; nor ``init_global``'s stacked per-rank states (each process
keeps its own). ``reduce`` works in place, as ``allreduce_grad`` does,
and returns ``(grads, new_state)``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple, Type

import torch
from torch import nn

from chainermn_torch.comm.distributed import grad_tensors, plan_buckets
from chainermn_torch.comm.factory import DEFAULT_DCN_BUCKET_BYTES

__all__ = ["GradReducer", "REDUCERS", "WIRE_FORMATS", "register_reducer",
           "make_grad_reducer", "group_leaves_for_buckets", "named_leaves"]

#: every wire format the registry understands ("f32" is the uncompressed
#: reference wire)
WIRE_FORMATS = ("f32", "bf16", "int8", "int8-block", "int4-block")

#: the strategies that wait for ROADMAP.md queue 1 item 13 (the synthesis
#: compiler and the schedule tuner)
_ITEM13 = ("waits for the tuning/synthesis slice of the port (ROADMAP.md "
           "queue 1 item 13)")


def named_leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    """``(key, tensor)`` of a module's parameters (its gradients'
    template), or of a dict's (nested) or a sequence's tensors, in
    order."""
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    if isinstance(tree, torch.Tensor):
        return [("", tree)]
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = enumerate(tree)
    return [(f"[{k!r}]{sub}", t) for k, v in items
            for sub, t in named_leaves(v)]


def group_leaves_for_buckets(leaves, bucket_bytes: int,
                             comm_dtype_of=None, order: str = "emission"
                             ) -> Dict[Tuple[Any, Any], List[List[int]]]:
    """Shared bucket grouping: leaves grouped by (communication dtype,
    device) — only same-typed leaves share a flat buffer — then packed
    greedily (:func:`plan_buckets`) in order (``'emission'``) or largest
    leaf first (``'size'``). Returns ``{(dtype, device): [bucket, ...]}``
    with buckets as lists of leaf indices. (The JAX function also splits
    off leaves that vary on no axis; every leaf here is a rank's own.)"""
    by_type = defaultdict(list)
    for i, leaf in enumerate(leaves):
        cdt = comm_dtype_of(leaf) if comm_dtype_of else leaf.dtype
        by_type[(cdt, leaf.device)].append(i)
    groups = {}
    for key, idxs in by_type.items():
        item = torch.empty((), dtype=key[0]).element_size()
        if order == "size":
            idxs = sorted(idxs, key=lambda i: -leaves[i].numel())
        groups[key] = plan_buckets(
            [(i, leaves[i].numel() * item) for i in idxs], bucket_bytes)
    return groups


class GradReducer:
    """Base strategy: how the gradients become reduced ones.

    Subclasses implement :meth:`reduce` (and, when ``stateful``,
    :meth:`init`). ``op`` is ``'mean'`` (the reference ``allreduce_grad``
    contract) or ``'sum'``::

        grads, state = reducer.reduce(grads, state)

    ``bucket_bytes`` defaults to the communicator's ``dcn_bucket_bytes``,
    else 4 MiB (JAX's default, so that error-feedback residuals have the
    JAX bucket plan's layout; ``allreduce_grad`` alone keeps its 25 MiB).
    """

    name = "base"
    #: True when :meth:`reduce` threads state (error-feedback residuals)
    stateful = False
    #: wire formats this strategy can put on the wire
    wire_formats = ("f32",)

    def __init__(self, comm, op: str = "mean",
                 bucket_bytes: Optional[int] = None,
                 bucket_order: str = "emission"):
        if op not in ("mean", "sum"):
            raise ValueError(f"unsupported grad-reduction op: {op!r}")
        if bucket_order not in ("emission", "size"):
            raise ValueError(f"bucket_order must be 'emission' or 'size', "
                             f"got {bucket_order!r}")
        self.comm = comm
        self.op = op
        self.bucket_bytes = (bucket_bytes if bucket_bytes is not None
                             else (comm._bucket_bytes
                                   or DEFAULT_DCN_BUCKET_BYTES))
        #: 'emission' packs buckets in order; 'size' packs largest-first.
        #: Pure packing: every leaf is still reduced exactly once
        self.bucket_order = bucket_order

    # -- state ----------------------------------------------------------

    def init(self, params):
        """This rank's reducer state for a gradient-shaped tree (the
        parameters work). Stateless strategies return ``()``."""
        return ()

    # -- the hot path ---------------------------------------------------

    def reduce(self, grads, state=()):
        raise NotImplementedError

    def _reduce_buckets(self, grads, allreduce, cast: bool = True):
        """Pack ``grads`` (in place) into buckets of one dtype, reduce
        each flat bucket with ``allreduce`` (flat vector → its sum) and
        write the pieces back. ``cast``: in the communicator's
        ``allreduce_grad_dtype`` where it has one."""
        cdt = self.comm.allreduce_grad_dtype if cast else None
        leaves = grad_tensors(grads)
        groups = group_leaves_for_buckets(
            leaves, self.bucket_bytes,
            comm_dtype_of=(lambda leaf: cdt) if cdt is not None else None,
            order=self.bucket_order)
        for (dtype, _), buckets in groups.items():
            for bucket in buckets:
                red = allreduce(torch.cat(
                    [leaves[i].reshape(-1).to(dtype) for i in bucket]))
                self._write_back(red, leaves, bucket)
        return grads

    def _write_back(self, red: torch.Tensor, leaves, bucket) -> None:
        """Unpack a reduced flat bucket into its leaves, in place
        (``op='mean'`` divides each piece by the size)."""
        n, off = self.comm.size, 0
        for i in bucket:
            g = leaves[i]
            piece = red[off:off + g.numel()].view(g.shape).to(g.dtype)
            off += g.numel()
            g.copy_(piece / n if self.op == "mean" else piece)

    def reduce_scatter_flat(self, g: torch.Tensor, n: Optional[int] = None
                            ) -> torch.Tensor:
        """ZeRO-1/2 hook: mean-reduce-scatter one flat gradient vector
        (length divisible by the size) over the reducer's communicator
        (JAX's hook takes the mesh axis instead) so rank ``r`` holds tile
        ``r``, divided by ``n`` (default: the size). Subclasses that
        decompose or compress override it, keeping the
        tile-``r``-on-rank-``r`` layout."""
        n = self.comm.size if n is None else n
        return self.comm.reduce_scatter_flat(g).div_(n)

    # -- introspection --------------------------------------------------

    def plan(self, tree) -> List[Dict[str, Any]]:
        """Host-side bucket plan for a gradient-shaped tree: one dict per
        bucket with ``bucket``, ``keys``, ``bytes`` (payload),
        ``wire_bytes`` (what this rank hands the collectives) and
        ``algorithm``."""
        sized = [(key, t.numel() * t.element_size())
                 for key, t in named_leaves(tree)]
        if self.bucket_order == "size":
            sized = sorted(sized, key=lambda kv: -kv[1])
        sizes = dict(sized)
        out = []
        for i, bucket in enumerate(plan_buckets(sized, self.bucket_bytes)):
            nb = sum(sizes[k] for k in bucket)
            out.append({"bucket": i, "keys": list(bucket), "bytes": nb,
                        "wire_bytes": self.wire_bytes(nb),
                        "algorithm": self.name})
        return out

    def wire_bytes(self, payload_bytes: int) -> int:
        """Bytes this strategy hands the collectives for a payload (per
        rank, one reduction). Compressing strategies override."""
        return payload_bytes

    def describe_rows(self, rows) -> List[str]:
        """One human line per :meth:`plan` row."""
        out = []
        for b in rows:
            line = (f"bucket {b['bucket']:>3}  {b['algorithm']:>12}  "
                    f"{b['bytes']:>12,} B payload  "
                    f"{b['wire_bytes']:>12,} B wire  {len(b['keys'])} leaves")
            if "est_us" in b:
                line += f"  ~{b['est_us']} us"
            out.append(line)
        return out

    def describe(self, tree) -> str:
        """One human line per bucket."""
        return "\n".join(self.describe_rows(self.plan(tree)))


#: name -> GradReducer subclass (strategies register on import)
REDUCERS: Dict[str, Type[GradReducer]] = {}


def register_reducer(name: str, cls: Type[GradReducer]) -> None:
    REDUCERS[name] = cls


def make_grad_reducer(spec, comm, op: str = "mean", **kwargs
                      ) -> Optional[GradReducer]:
    """Resolve a ``grad_reducer=`` argument: None (no reducer: callers
    keep ``allreduce_grad``), a :class:`GradReducer` (returned as is), or
    a registered name (``'flat' | 'hierarchical' | 'quantized' |
    'auto'``) with ``kwargs`` for its constructor.

    ``wire_format`` (in ``kwargs``, one of :data:`WIRE_FORMATS`):
    ``'f32'``/None keep the uncompressed wire on any strategy; the narrow
    formats go to strategies that can carry them (``quantized``,
    ``auto``) and are refused by strategies whose wire is f32. ``synth``
    (a synthesized per-tier program) waits for queue 1 item 13."""
    if spec is None:
        return None
    if isinstance(spec, GradReducer):
        return spec
    if spec == "synth":
        raise NotImplementedError(f"grad_reducer 'synth' {_ITEM13}")
    try:
        cls = REDUCERS[spec]
    except KeyError:
        raise ValueError(f"unknown grad_reducer {spec!r}; registered "
                         f"strategies: {sorted(REDUCERS)}") from None
    wf = kwargs.pop("wire_format", None)
    if wf is not None:
        if wf not in WIRE_FORMATS:
            raise ValueError(f"unknown wire_format {wf!r}; expected one of "
                             f"{WIRE_FORMATS}")
        if cls.wire_formats != ("f32",):
            kwargs["wire_format"] = wf
        elif wf != "f32":
            raise ValueError(
                f"strategy {spec!r} carries an uncompressed f32 wire; "
                f"wire_format={wf!r} needs 'quantized' (fixed format) or "
                "'auto' (cost model may pick it)")
    return cls(comm, op=op, **kwargs)
