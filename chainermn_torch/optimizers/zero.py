"""ZeRO-1/2 (sharded optimizer state) and ZeRO-3/FSDP (sharded
parameters) over the data axis.

Counterpart of ``chainermn_tpu/optimizers/zero.py``; the ZeRO-1/2 half
(``:40-842``, ``:1243-1265``) first. The parameters are packed, in the flax
tree's leaf order (:func:`~chainermn_torch.models.convert.flax_param_order`),
each in flax's layout (a Dense kernel transposed,
:func:`~chainermn_torch.models.convert.flax_layout_perm`), into flat
vectors padded to a device-count-independent quantum
(:func:`_padded_size`): one vector, or with ``bucket_bytes`` one per
bucket of the JAX plan (:class:`_BucketLayout`). Rank ``r`` keeps tile
``r`` of each vector as its parameter shard and runs the inner optimizer
on those shards alone, so an optimizer's state costs 1/N of the model per
rank. A step:

1. forward and backward of the local batch (ZeRO-2: of each of
   ``n_microbatches`` slices in turn);
2. as soon as a vector's last leaf has its gradient
   (``Tensor.register_post_accumulate_grad_hook``), its gradients are
   packed, mean-reduce-scattered (the reducer's hook, or the
   communicator's ``reduce_scatter_flat`` / N) and freed, and the tile is
   added to that vector's 1/N accumulator; with buckets the whole model's
   gradient never exists at once;
3. the inner optimizer updates the shards with the accumulated tiles
   (ZeRO-2: divided by ``n_microbatches``);
4. ``all_gather_flat`` writes the updated shards of every rank into the
   full vectors, and the model's parameters are views into those
   vectors, so no per-leaf copy follows.

The JAX factories take an optax transform, whose state is functional;
a torch optimizer cannot be built before its shards exist, so the port
takes an **optimizer factory**, ``Callable[[list[Tensor]],
torch.optim.Optimizer]`` (``lambda ps: torch.optim.Adam(ps, lr=1e-3)``).
``step(x, y)`` updates in place and returns ``{"main/loss",
"main/accuracy"}`` averaged over the communicator (JAX's ``pmean``);
``state`` (:class:`ZeroState`) holds the shards, the inner optimizer, the
layout and the error-feedback residuals. ``donate`` is accepted and has no effect: the step updates
in place. The flat vectors hold JAX's numbers in JAX's places: the
element-wise update would not care, but the block-quantized reducers
scale each run of 256 (or fewer) consecutive elements together, so their
blocks, scales and codes follow the layout. A Linear's weight is then a
transposed view (``F.linear`` takes it without a copy).

**FSDP** (``:848-1288``; :func:`make_fsdp_train_step`). JAX annotates
each leaf's sharding and lets XLA insert the collectives; the port does
them itself, on its own communicator: each leaf splits over the ranks
along its first divisible dimension of its shape in flax's layout (too
small a leaf stays whole), rank ``r`` keeping JAX's shard ``r`` (in
flax's layout) as the trainable tensor. A ``torch.autograd.Function``
all-gathers a leaf (or one layer of a stacked leaf) on each use, and its
backward mean-reduce-scatters the gradient into the shard's buffer; a
whole leaf's gradient is mean-all-reduced after the backward. A module's
parameters read their gathers through ``torch.nn.utils.parametrize``; a
tree of tensors (the scanned-stack form) hands its loss function
:class:`FsdpParam` handles, which :func:`full` and
:func:`fsdp_scan_apply` gather. A gathered tensor dies when nothing
holds it, and :class:`FsdpState` counts the bytes alive.
"""

from __future__ import annotations

import copy
import functools
import math
import warnings
import weakref
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from chainermn_torch.collectives.quantized import QUANT_BLOCK
from chainermn_torch.comm.distributed import plan_buckets

__all__ = ["make_zero1_train_step", "make_zero2_train_step", "zero1_params",
           "zero_layout_manifest", "ZeroState", "make_fsdp_train_step",
           "fsdp_shardings", "fsdp_stack_shardings", "fsdp_scan_apply",
           "fsdp_gather_params", "fsdp_layout_manifest"]

#: the padding quantum: any world size dividing it gives the same padded
#: global length (JAX's, so layouts and manifests agree)
QUANTUM = 256

_NOT_ELEMENTWISE = (
    "this optimizer is not element-wise: its update on a parameter "
    "pytree differs from its update run per-shard on the same values "
    "flat-packed, so ZeRO-1/2's flat layouts would silently compute "
    "wrong updates (per-layer trust ratios, masked weight decay, "
    "multi_transform, whole-tree norms like clip_by_global_norm). "
    "Use make_fsdp_train_step instead — FSDP shards per-leaf, keeps "
    "parameter structure intact, and computes tree-wide reductions "
    "globally via XLA's sharding propagation."
)


def _resolve_rs(grad_reducer, comm
                ) -> Tuple[Optional[Callable], Optional[object]]:
    """``(rs, ef_reducer)`` for a ``grad_reducer=`` argument: ``rs`` the
    stateless mean-reduce-scatter of a flat vector (None for the default,
    the communicator's ``reduce_scatter_flat`` / N), ``ef_reducer`` a
    stateful (error-feedback) reducer whose ``reduce_scatter_flat_ef``
    threads this rank's residual, kept in the flat-bucket frame: one
    whole padded vector per bucket. Every strategy keeps tile ``r`` on
    rank ``r``, which the sharded state depends on."""
    from chainermn_torch.collectives import make_grad_reducer

    reducer = make_grad_reducer(grad_reducer, comm, op="mean")
    if reducer is None:
        return None, None
    if reducer.stateful:
        if not hasattr(reducer, "reduce_scatter_flat_ef"):
            raise ValueError(
                f"grad_reducer {reducer.name!r} is stateful but "
                "implements no reduce_scatter_flat_ef — the ZeRO flat "
                "paths cannot thread its per-rank state; pass a "
                "stateless reducer here, or use "
                "make_data_parallel_train_step")
        return None, reducer
    n = comm.size
    return (lambda g: reducer.reduce_scatter_flat(g, n)), None


def _probe_update(opt, tensors, grads) -> torch.Tensor:
    """One ``opt.step()`` on ``tensors`` with ``grads``: the flat update
    it applied."""
    before = [t.clone() for t in tensors]
    for t, g in zip(tensors, grads):
        t.grad = g.clone()
    opt.step()
    return torch.cat([(t - b).reshape(-1) for t, b in zip(tensors, before)])


@torch.no_grad()
def _require_elementwise(optimizer, params: Sequence[torch.Tensor]) -> None:
    """Refuse optimizers the flat layouts would silently mis-train.

    The JAX probe (``zero.py:76``): tensors with the parameters' ranks
    (each dimension 2, distinct per-leaf magnitudes) take two chained
    steps per gradient scale (1 and 1e4; the second step's gradient
    tilted by a positional ramp, so its direction changes), once as the
    whole list and once as two flat shards with independent optimizers,
    split off a leaf boundary; the updates must agree (rtol 1e-5, atol
    1e-8), and a crash on the shard side is the same verdict. The probe
    runs in f64 on the parameters' device, so that the update read back
    as ``after − before`` keeps its digits."""
    dev = params[0].device if len(params) else torch.device("cpu")
    f64 = dict(dtype=torch.float64, device=dev)
    probe, gprobe = [], []
    for i, leaf in enumerate(params):
        shape = (2,) * leaf.ndim
        base = np.linspace(0.1, 0.9, 2 ** leaf.ndim,
                           dtype=np.float32) * (i + 1)
        probe.append(torch.tensor(base.reshape(shape), **f64))
        gprobe.append(torch.tensor((base[::-1] * 0.01 + 0.003).copy()
                                   .reshape(shape), **f64))
    sizes = [t.numel() for t in probe]
    total = sum(sizes)
    padded = total + total % 2
    split = padded // 2
    if split in set(np.cumsum(sizes).tolist()) and padded - split > 1:
        split += 1
    ramp = torch.linspace(0.2, 5.0, total, **f64).split(sizes)
    pad = torch.zeros(padded - total, **f64)
    for gscale in (1.0, 1e4):
        tree = [t.clone() for t in probe]
        opt_tree = optimizer(tree)
        shards = opt_shards = None
        for step_i, mul in enumerate((gscale, 3.0 * gscale)):
            g = [t * mul for t in gprobe]
            if step_i == 1:
                g = [t * r.reshape(t.shape) for t, r in zip(g, ramp)]
            got = _probe_update(opt_tree, tree, g)
            gv = torch.cat([t.reshape(-1) for t in g] + [pad])
            try:
                if shards is None:
                    fv = torch.cat([t.reshape(-1) for t in probe] + [pad])
                    shards = [fv[:split].clone(), fv[split:].clone()]
                    opt_shards = [optimizer([s]) for s in shards]
                want = torch.cat([
                    _probe_update(o, [s], [gs]) for o, s, gs in zip(
                        opt_shards, shards, (gv[:split], gv[split:]))])
            except Exception as e:
                raise ValueError(_NOT_ELEMENTWISE) from e
            if not torch.allclose(got, want[:total], rtol=1e-5, atol=1e-8):
                raise ValueError(_NOT_ELEMENTWISE)


def _padded_size(total: int, n: int) -> int:
    """Flat length after padding for an n-way shard: a multiple of
    :data:`QUANTUM` whenever n divides it, so the padded global length
    does not depend on the device count (JAX's ``zero.py:189``)."""
    q = QUANTUM if QUANTUM % n == 0 else n
    return total + ((-total) % q)


def _leaves(params) -> Tuple[List[torch.Tensor], List[Optional[tuple]]]:
    """The tensors a layout packs and the permutations into their flax
    layout: a module's trainable parameters in the flax tree's order, or
    a sequence of tensors as given (no permutation)."""
    if isinstance(params, nn.Module):
        from chainermn_torch.models.convert import (flax_layout_perm,
                                                    flax_param_order)

        named = flax_param_order(params)
        return ([p for _, p in named],
                [flax_layout_perm(params, k) for k, _ in named])
    params = list(params)
    return params, [None] * len(params)


def _inverse(perm: tuple) -> tuple:
    return tuple(int(i) for i in np.argsort(perm))


class _BucketLayout:
    """The ZeRO layout of a list of leaves (JAX's ``zero.py:207``):
    leaves packed greedily into buckets of at most ``bucket_bytes``
    (:func:`~chainermn_torch.comm.distributed.plan_buckets`, a copy of
    JAX's), each bucket padded (:func:`_padded_size`) and split into
    ``n`` tiles. ``bucket_bytes=None`` is the one-vector layout (one
    bucket of every leaf). ``perms[i]`` puts leaf ``i`` in the packed
    layout (None: as it is). Mixed dtypes are refused."""

    def __init__(self, leaves: Sequence[torch.Tensor], n: int,
                 bucket_bytes: Optional[int],
                 perms: Optional[Sequence[Optional[tuple]]] = None):
        self.perms = list(perms or [None] * len(leaves))
        self.shapes = [tuple(t.permute(p).shape) if p else tuple(t.shape)
                       for t, p in zip(leaves, self.perms)]
        self.sizes = [int(t.numel()) for t in leaves]
        dtypes = {t.dtype for t in leaves}
        if len(dtypes) != 1:
            raise ValueError(
                f"ZeRO flat layouts need a single param dtype, got "
                f"{sorted(str(d).replace('torch.', '') for d in dtypes)}")
        (self.dtype,) = dtypes
        item = torch.empty((), dtype=self.dtype).element_size()
        if bucket_bytes is None:
            self.buckets = [list(range(len(leaves)))]
        else:
            self.buckets = plan_buckets(
                [(i, self.sizes[i] * item) for i in range(len(leaves))],
                bucket_bytes)
        self.totals = [sum(self.sizes[i] for i in b) for b in self.buckets]
        self.padded = [_padded_size(t, n) for t in self.totals]
        self.shard_lens = [p // n for p in self.padded]
        self.n = n
        self.bucket_bytes = bucket_bytes

    def views(self, full: torch.Tensor, b: int) -> List[torch.Tensor]:
        """Bucket ``b``'s leaves as views into its full vector, each in
        its own (torch) layout."""
        out, off = [], 0
        for i in self.buckets[b]:
            v = full[off:off + self.sizes[i]].view(self.shapes[i])
            p = self.perms[i]
            out.append(v.permute(_inverse(p)) if p else v)
            off += self.sizes[i]
        return out

    def flat(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf ``i``'s tensor (a gradient) flattened in the packed
        layout."""
        p = self.perms[i]
        return (t.permute(p) if p else t).reshape(-1)


class ZeroState:
    """A ZeRO step's state on this rank: ``shards`` (this rank's tile of
    each flat vector: JAX's ``param_shard``, one a bucket), ``optimizer``
    (the inner optimizer over the shards: JAX's ``opt_state``),
    ``residuals`` (a stateful reducer's error feedback, one whole padded
    vector per bucket), ``layout``, and the live-gradient accounting of
    the hooks (``grad_bytes_peak``: the most bytes of gradient tensors
    the steps held at once, the leaves' ``.grad`` and the packed
    vectors)."""

    def __init__(self, comm, layout: _BucketLayout, bucketed: bool,
                 fulls, shards, optimizer, residuals):
        self.comm = comm
        self.layout = layout
        self.bucketed = bucketed
        self.fulls = fulls
        self.shards = shards
        self.optimizer = optimizer
        self.residuals = residuals
        self.grad_bytes = 0
        self.grad_bytes_peak = 0

    def optimizer_state_numel(self) -> int:
        """Elements of the inner optimizer's tensor state on this rank."""
        return sum(v.numel() for s in self.optimizer.state.values()
                   for v in s.values()
                   if torch.is_tensor(v) and v.ndim > 0)

    def _track(self, nbytes: int) -> None:
        self.grad_bytes += nbytes
        self.grad_bytes_peak = max(self.grad_bytes_peak, self.grad_bytes)

    @torch.no_grad()
    def refresh(self) -> None:
        """Re-read this rank's shards from the model's parameters, after
        they were loaded in place (``model.load_state_dict``)."""
        r = self.comm.rank
        for shard, full, ln in zip(self.shards, self.fulls,
                                   self.layout.shard_lens):
            shard.copy_(full[r * ln:(r + 1) * ln])

    @torch.no_grad()
    def gather(self) -> None:
        """Every rank's shards into the full vectors (the parameters)."""
        for full, shard in zip(self.fulls, self.shards):
            self.comm.all_gather_flat(shard, out=full)

    def state_dict(self, template: bool = False) -> dict:
        """This rank's part of the state, for the checkpointer: each
        shard as a :class:`~chainermn_torch.extensions.checkpoint.
        ShardedLeaf` (tile ``r`` of its ``(padded,)`` vector), the inner
        optimizer's state with each per-element tensor sharded as its
        parameter, the error-feedback residuals as the world-stacked
        ``(n, padded)`` frame JAX saves (row ``r`` this rank's), and the
        layout's manifest. ``template=True`` (the restoring side's
        ``maybe_load`` template) fills an optimizer that has not stepped
        yet with state of the shapes a step would give it."""
        from chainermn_torch.extensions.checkpoint import ShardedLeaf

        r, n = self.comm.rank, self.comm.size
        params = [ShardedLeaf(s, (p,), ((r * ln, (r + 1) * ln),))
                  for s, p, ln in zip(self.shards, self.layout.padded,
                                      self.layout.shard_lens)]
        return {"params": params,
                "optimizer": _sharded_optimizer_state(
                    self.optimizer, self.shards, params, template),
                "residuals": [ShardedLeaf(e[None], (n, e.numel()),
                                          ((r, r + 1), (0, e.numel())))
                              for e in self.residuals],
                "layout": _manifest(self.layout, self.bucketed,
                                    self.comm.size)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Load :meth:`state_dict` output in place (as saved, or restored
        onto this world by the checkpointer), then gather the
        parameters. A layout other than this step's (another model,
        bucket plan or padding) is refused; the world may differ."""
        want = _manifest(self.layout, self.bucketed, self.comm.size)
        got = state["layout"]
        skip = ("n", "ef_frames")
        if {k: v for k, v in got.items() if k not in skip} != \
                {k: v for k, v in want.items() if k not in skip}:
            raise ValueError(f"the state's layout {got} is not this "
                             f"step's {want}")
        for dst, src in zip(self.shards, state["params"]):
            dst.copy_(_local(src))
        self.optimizer.load_state_dict(_local_tree(state["optimizer"]))
        for dst, src in zip(self.residuals, state["residuals"]):
            dst.copy_(_local(src).reshape(dst.shape))
        self.gather()


def _local(x) -> torch.Tensor:
    """A state entry as this rank's tensor (a sharded leaf's piece)."""
    return torch.as_tensor(getattr(x, "local", x))


def _local_tree(tree):
    """``tree`` with each sharded leaf replaced by its local piece."""
    if isinstance(tree, dict):
        return {k: _local_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_local_tree(v) for v in tree)
    return tree.local if hasattr(tree, "local") else tree


def _sharded_optimizer_state(optimizer, shards, params, template: bool):
    """``optimizer.state_dict()`` with each tensor shaped like its
    parameter's shard marked sharded like the parameter (``params[i]``:
    the parameter's sharded leaf, or a tensor for a replicated one).
    ``template``: an optimizer without state gets the state of one step
    of a copy on zero gradients (its shapes, not its values, matter)."""
    from chainermn_torch.extensions.checkpoint import ShardedLeaf

    opt = optimizer
    if template and len(opt.state) < len(shards):
        opt = copy.deepcopy(optimizer)
        if hasattr(opt, "norm_reduce"):
            opt.norm_reduce = None      # the copy's step is local
        with torch.no_grad():
            for group in opt.param_groups:
                for p in group["params"]:
                    p.grad = torch.zeros_like(p)
            opt.step()
    sd = opt.state_dict()
    if opt is not optimizer:
        sd = copy.deepcopy(sd)
    state = {}
    for i, per in sd["state"].items():
        like = params[i]
        state[i] = {
            k: (ShardedLeaf(v, like.gshape, like.index)
                if isinstance(like, ShardedLeaf) and torch.is_tensor(v)
                and tuple(v.shape) == tuple(shards[i].shape) else v)
            for k, v in per.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def _manifest(layout: _BucketLayout, bucketed: bool, n: int) -> dict:
    if not bucketed:
        total, padded = layout.totals[0], layout.padded[0]
        return {"kind": "zero-flat", "quantum": QUANTUM, "n": n,
                "total": total, "padded": padded,
                "ef_frames": [[n, padded]]}
    return {"kind": "zero-bucketed", "quantum": QUANTUM, "n": n,
            "bucket_bytes": int(layout.bucket_bytes),
            "totals": [int(t) for t in layout.totals],
            "padded": [int(p) for p in layout.padded],
            "ef_frames": [[n, int(p)] for p in layout.padded]}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _on_grad(step_ref, i: int, p: torch.Tensor) -> None:
    """The hook on leaf ``i``. It holds its step weakly: the parameters
    keep their hooks, so a strong reference would keep the step, its
    state and its buffers alive with the model."""
    step = step_ref()
    if step is not None and step.active:
        step.leaf_ready(i, p)


class _ZeroStep:
    """The ZeRO-1 (one micro-batch) and ZeRO-2 step (module docstring);
    ``step(x, y)`` runs it."""

    def __init__(self, model, optimizer, comm, n_microbatches: int,
                 loss_fn, bucket_bytes, grad_reducer):
        from chainermn_torch.links import batch_norm_layers
        from chainermn_torch.training.step import classifier_loss

        if batch_norm_layers(model):
            raise ValueError("ZeRO steps train models without mutable "
                             "collections; a model with batch statistics "
                             "trains through make_data_parallel_train_step")
        comm.axis_name  # raises on a multi-axis communicator (split it)
        self.m = int(n_microbatches)
        if self.m < 1:
            raise ValueError(f"n_microbatches must be >= 1, got {self.m}")
        self.model, self.comm = model, comm
        self.lf = loss_fn or classifier_loss
        self.leaves, perms = _leaves(model)
        n, r = comm.size, comm.rank
        layout = _BucketLayout(self.leaves, n, bucket_bytes, perms)
        _require_elementwise(optimizer, self.leaves)
        self.rs, self.ef = _resolve_rs(grad_reducer, comm)
        if self.rs is None and self.ef is None:
            self.rs = lambda g: comm.reduce_scatter_flat(g).div_(n)
        self.dev, self.dt = self.leaves[0].device, layout.dtype

        # the full vectors; the model's parameters become views into them
        fulls = []
        with torch.no_grad():
            for b, padded in enumerate(layout.padded):
                full = torch.zeros(padded, dtype=self.dt, device=self.dev)
                for i, view in zip(layout.buckets[b], layout.views(full, b)):
                    view.copy_(self.leaves[i])
                    self.leaves[i].data = view
                fulls.append(full)
            shards = [full[r * ln:(r + 1) * ln].clone()
                      for full, ln in zip(fulls, layout.shard_lens)]
        residuals = ([torch.zeros(p, dtype=self.dt, device=self.dev)
                      for p in layout.padded]
                     if self.ef is not None else [])
        self.state = ZeroState(comm, layout, bucket_bytes is not None,
                               fulls, shards, optimizer(shards), residuals)
        self.layout = layout
        self.bucket_of = {i: b for b, bl in enumerate(layout.buckets)
                          for i in bl}
        nb = len(layout.buckets)
        self.ready = [0] * nb         # leaves with a gradient
        self.done = [False] * nb      # scattered this slice
        self.accs: List[Optional[torch.Tensor]] = [None] * nb
        self.active = False
        me = weakref.ref(self)
        for i, leaf in enumerate(self.leaves):
            leaf.register_post_accumulate_grad_hook(
                functools.partial(_on_grad, me, i))

    def leaf_ready(self, i: int, p: torch.Tensor) -> None:
        self.state._track(_nbytes(p.grad))
        b = self.bucket_of[i]
        self.ready[b] += 1
        if self.ready[b] == len(self.layout.buckets[b]):
            self.scatter(b)

    @torch.no_grad()
    def scatter(self, b: int) -> None:
        """Pack bucket ``b``'s gradients, free them, reduce-scatter the
        vector and add its tile to the bucket's accumulator."""
        lay, st, leaves = self.layout, self.state, self.leaves
        idx = lay.buckets[b]
        pad = lay.padded[b] - lay.totals[b]
        g = torch.cat([lay.flat(leaves[i].grad, i) for i in idx]
                      + ([torch.zeros(pad, dtype=self.dt, device=self.dev)]
                         if pad else []))
        st._track(_nbytes(g))
        for i in idx:
            st._track(-_nbytes(leaves[i].grad))
            leaves[i].grad = None
        if self.ef is not None:
            tile, st.residuals[b] = self.ef.reduce_scatter_flat_ef(
                g, st.residuals[b], self.comm.size)
        else:
            tile = self.rs(g)
        acc = self.accs[b]
        self.accs[b] = tile if acc is None else acc.add_(tile)
        st._track(-_nbytes(g))
        self.ready[b], self.done[b] = 0, True

    def finish_slice(self) -> None:
        """Scatter the buckets the backward did not complete, in bucket
        order: a leaf it did not reach has a zero gradient (JAX
        differentiates every leaf)."""
        for b, idx in enumerate(self.layout.buckets):
            if not self.done[b]:
                for i in idx:
                    if self.leaves[i].grad is None:
                        self.leaves[i].grad = torch.zeros_like(
                            self.leaves[i])
                        self.state._track(_nbytes(self.leaves[i]))
                self.scatter(b)
            self.done[b] = False

    def __call__(self, x, y):
        m, st = self.m, self.state
        x = torch.as_tensor(x, device=self.dev)
        y = torch.as_tensor(y, device=self.dev)
        if x.shape[0] % m:
            raise ValueError(f"local batch {x.shape[0]} not divisible by "
                             f"{m} microbatches")
        for leaf in self.leaves:
            leaf.grad = None
        loss_sum = acc_sum = 0.0
        self.active = True
        try:
            for xi, yi in zip(x.chunk(m), y.chunk(m)):
                loss, (a, _) = self.lf(self.model, xi, yi, train=True)
                loss.backward()
                self.finish_slice()
                loss_sum = loss_sum + loss.detach().float()
                acc_sum = acc_sum + a.detach().float()
        finally:
            self.active = False
        with torch.no_grad():
            for shard, acc in zip(st.shards, self.accs):
                shard.grad = acc.div_(m) if m > 1 else acc
            st.optimizer.step()
            for b, shard in enumerate(st.shards):
                shard.grad = None
                self.accs[b] = None
            st.gather()
        met = self.comm.allreduce(torch.stack([loss_sum, acc_sum]) / m,
                                  "mean")
        return {"main/loss": met[0], "main/accuracy": met[1]}


def make_zero1_train_step(model, optimizer, comm, params=None,
                          loss_fn: Optional[Callable] = None,
                          donate: bool = True,
                          bucket_bytes: Optional[int] = None,
                          grad_reducer=None):
    """ZeRO-1: ``(step, state)`` with the optimizer state sharded (module
    docstring); ``metrics = step(x, y)`` on this rank's batch.

    ``optimizer`` is a factory ``list[Tensor] -> torch.optim.Optimizer``
    and must be element-wise (SGD, momentum, Adam, AdamW: construction
    probes it and refuses LARS, LAMB and other per-leaf or whole-tree
    transforms with ``ValueError``). ``params`` (JAX's initial tree) is
    not needed: the step starts from the model's parameters, which should
    agree on every rank (``comm.bcast_data(model)``). The reduction is the
    mean; do not wrap the inner optimizer in
    ``create_multi_node_optimizer``. Restrictions as in JAX: a
    single-axis communicator, one parameter dtype, no batch statistics.
    ``bucket_bytes`` packs the leaves into independently scattered
    buckets (the numbers are the same; the state's layout is not: pass
    the same value to :func:`zero1_params`). ``grad_reducer``: the
    reduce-scatter's strategy (None: the communicator's; a stateful
    reducer keeps its residuals in ``state.residuals``). ``donate`` has
    no effect (the step works in place)."""
    del params, donate
    step = _ZeroStep(model, optimizer, comm, 1, loss_fn, bucket_bytes,
                     grad_reducer)
    return step, step.state


def make_zero2_train_step(model, optimizer, comm, params=None,
                          n_microbatches: int = 1,
                          loss_fn: Optional[Callable] = None,
                          donate: bool = True,
                          bucket_bytes: Optional[int] = None,
                          grad_reducer=None):
    """ZeRO-2: ZeRO-1 with a sharded gradient accumulator. The local
    batch is split into ``n_microbatches`` slices (it must divide them);
    each slice's gradients are reduce-scattered into the 1/N accumulators
    as its backward produces them, error feedback applying per scatter,
    and the update takes the accumulated tiles over ``n_microbatches``.
    The state has ZeRO-1's layout at equal ``bucket_bytes``. Arguments as
    :func:`make_zero1_train_step`."""
    del params, donate
    step = _ZeroStep(model, optimizer, comm, n_microbatches, loss_fn,
                     bucket_bytes, grad_reducer)
    return step, step.state


@torch.no_grad()
def zero1_params(state: ZeroState, like_params, bucket_bytes=None) -> dict:
    """The full parameters re-assembled from a ZeRO-1/2 state (every
    rank's shards, gathered: a collective every rank calls), as ``{name:
    tensor}`` for ``like_params`` (the model), decoded with the state's
    own layout. ``bucket_bytes`` (JAX's state needs it to be decoded)
    must plan the buckets the step was built with; another is
    refused."""
    layout = state.layout
    if bucket_bytes is None:
        if state.bucketed:
            raise ValueError(
                "this state holds a TUPLE of bucket shards — it was "
                "built with bucket_bytes; pass the same bucket_bytes to "
                "zero1_params (stacking the buckets would interleave "
                "their padding and silently corrupt every later leaf)")
    elif not state.bucketed:
        raise ValueError(
            "bucket_bytes given but the state holds a single flat vector "
            "— it was built WITHOUT bucket_bytes; the two layouts are "
            "not interchangeable")
    else:
        item = torch.empty((), dtype=layout.dtype).element_size()
        plan = plan_buckets([(i, n * item) for i, n in
                             enumerate(layout.sizes)], bucket_bytes)
        if plan != layout.buckets:
            raise ValueError(
                f"state has {len(state.shards)} buckets but bucket_bytes="
                f"{bucket_bytes} plans {len(plan)} — pass the "
                "bucket_bytes the step was built with")
    from chainermn_torch.models.convert import flax_param_order

    names = [k for k, _ in flax_param_order(like_params)]
    out = {}
    for b, shard in enumerate(state.shards):
        full = state.comm.all_gather_flat(shard)
        for i, view in zip(layout.buckets[b], layout.views(full, b)):
            out[names[i]] = view.contiguous()
    return out


def zero_layout_manifest(params, comm, bucket_bytes=None) -> dict:
    """The flat-frame geometry of a ZeRO-1/2 state (JAX's
    ``zero.py:1243``): padding quantum, world, per-bucket padded lengths
    and the ``(n, padded)`` error-feedback frames; ``params`` is the
    model (or a list of tensors). Host metadata only."""
    leaves, perms = _leaves(params)
    layout = _BucketLayout(leaves, comm.size, bucket_bytes, perms)
    return _manifest(layout, bucket_bytes is not None, comm.size)




# ---------------------------------------------------------------------------
# ZeRO-3 / FSDP: every parameter sharded, gathered just in time
# ---------------------------------------------------------------------------

_STATEFUL_FSDP = (
    "grad_reducer {name!r} is stateful (error-feedback residuals); the "
    "FSDP step has no per-rank state to thread them through. Pass "
    "QuantizedReducer(ef=False), or use make_data_parallel_train_step "
    "for error feedback.")


def _tree_items(tree, prefix=()):
    """``(path, leaf)`` of a nested dict (keys sorted, as
    ``jax.tree_util`` orders a dict) or list; a leaf is anything else."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_items(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_items(v, prefix + (i,))
    else:
        yield prefix, tree


def _tree_build(pairs):
    """The nested dict of ``(path, value)`` pairs (paths of dict keys)."""
    out: dict = {}
    for path, v in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _module_leaves(model: nn.Module):
    """``(torch name, flax path, perm, parameter)`` of a module's
    trainable parameters in the flax tree's order (any other model: its
    own order and names)."""
    from chainermn_torch.models.convert import (_flax_leaf,
                                                flax_layout_perm,
                                                flax_param_order)
    from chainermn_torch.models.mlp import MLP
    from chainermn_torch.models.transformer import TransformerLM
    from chainermn_torch.models.vit import ViT

    mapped = isinstance(model, (MLP, TransformerLM, ViT))
    out = []
    for name, p in flax_param_order(model):
        owner, _, attr = name.rpartition(".")
        path = (_flax_leaf(model, owner, attr) if mapped
                else tuple(name.split(".")))
        out.append((name, path, flax_layout_perm(model, name), p))
    return out


def _flax_shape(shape, perm) -> tuple:
    shape = tuple(int(d) for d in shape)
    return tuple(shape[i] for i in perm) if perm else shape


def _split_dim(shape, n: int, start_dim: int) -> Optional[int]:
    """The FSDP rule: the first dimension at index >= ``start_dim`` that
    ``n`` divides and that has at least ``n`` rows; None (replicated) for
    a leaf too small to split."""
    for i, d in enumerate(shape):
        if i >= start_dim and d >= n and d % n == 0:
            return i
    return None


def _first_divisible_dim_shardings(params, comm, start_dim: int):
    """The FSDP per-leaf rule (JAX's ``zero.py:848``) on each leaf's
    shape in flax's layout. ``params``: a module (→ ``{parameter name:
    split dimension in torch's layout, or None}``, in the flax tree's
    order: the flax dimension mapped through
    :func:`~chainermn_torch.models.convert.flax_layout_perm`) or a nested
    dict of tensors or arrays in flax's layout (→ the same tree of split
    dimensions)."""
    n = comm.size
    if isinstance(params, nn.Module):
        out = {}
        for name, _, perm, p in _module_leaves(params):
            k = _split_dim(_flax_shape(p.shape, perm), n, start_dim)
            out[name] = None if k is None else (perm[k] if perm else k)
        return out
    return _tree_build(
        (path, _split_dim(tuple(np.shape(leaf)), n, start_dim))
        for path, leaf in _tree_items(params))


def fsdp_shardings(params, comm):
    """Per-leaf split dimensions for fully sharded parameters: each leaf
    splits over the communicator along its first divisible dimension in
    flax's layout (None: replicated). See
    :func:`_first_divisible_dim_shardings` for the forms."""
    return _first_divisible_dim_shardings(params, comm, start_dim=0)


def fsdp_stack_shardings(params, comm):
    """:func:`fsdp_shardings` for trees of scanned layer stacks
    (:func:`fsdp_scan_apply`): the same rule, but dim 0, the layer
    dimension, is never chosen, so that each layer gathers inside its
    own iteration."""
    return _first_divisible_dim_shardings(params, comm, start_dim=1)


def _find_stacked_subtree(params, n):
    """JAX's detector (``zero.py:930``) of a scanned layer stack: a node
    with >= 2 array leaves sharing one leading dim ``L >= 2`` divisible
    by ``n`` (every leaf ndim >= 2, one >= 3), where the default rule
    would shard the layer dim. The node's path, or None."""
    groups: dict = {}
    for path, leaf in _tree_items(params):
        groups.setdefault(tuple(path[:-1]), []).append(
            tuple(np.shape(leaf)))
    for parent, shapes in groups.items():
        if len(shapes) < 2 or not all(len(s) >= 2 for s in shapes):
            continue
        if not any(len(s) >= 3 for s in shapes):
            continue
        heads = {s[0] for s in shapes}
        if len(heads) != 1:
            continue
        L = heads.pop()
        if L >= 2 and L % n == 0:
            return _path_str(parent) or "<root>"
    return None


def _index_of(gshape, dim: Optional[int], n: int, r: int) -> tuple:
    """Rank ``r``'s global ``(start, stop)`` per dimension."""
    idx = [(0, int(d)) for d in gshape]
    if dim is not None:
        ln = gshape[dim] // n
        idx[dim] = (r * ln, (r + 1) * ln)
    return tuple(idx)


class _FsdpLeaf:
    """One parameter of an FSDP step: its flax path and global flax
    shape, its split dimension in flax's layout (None: replicated), the
    permutation into flax's layout of the torch tensor it stands for,
    and ``shard``, this rank's part in flax's layout (the trainable
    tensor)."""

    __slots__ = ("path", "gshape", "dim", "perm", "shard")

    def __init__(self, path, gshape, dim, perm, shard):
        self.path, self.gshape, self.dim = path, gshape, dim
        self.perm, self.shard = perm, shard


#: the profiler span around each FSDP all-gather (dlint's DL204 reads it;
#: ``chainermn_torch/analysis/trace_passes.py`` keeps the same name)
GATHER_SPAN = "fsdp::gather"


class _Gather(torch.autograd.Function):
    """Forward: leaf ``j`` (or its layer ``i``) all-gathered in flax's
    layout. Backward: the full gradient reduced onto this rank's shard,
    into the step's buffer (the shard's own gradient is None: a layer's
    piece of a stack need not become a whole stack's gradient)."""

    @staticmethod
    def forward(ctx, shard, state, j, i):
        ctx.state, ctx.j, ctx.i = state, j, i
        return state._gather(j, i, state.param_wire)

    @staticmethod
    def backward(ctx, g):
        ctx.state._reduce(ctx.j, ctx.i, g)
        return None, None, None, None


class FsdpParam:
    """A tree-form step's parameter as its loss function sees it:
    :meth:`full` gathers the whole leaf, :meth:`layer` one layer of a
    stack (a replicated leaf returns its tensor or a slice of it); each
    call gathers anew, differentiably. ``shape`` is the global one, in
    flax's layout."""

    def __init__(self, state: "FsdpState", j: int):
        self._state, self._j = state, j

    @property
    def shape(self) -> torch.Size:
        return torch.Size(self._state.leaves[self._j].gshape)

    def full(self) -> torch.Tensor:
        leaf = self._state.leaves[self._j]
        if leaf.dim is None:
            return leaf.shard
        return _Gather.apply(leaf.shard, self._state, self._j, None)

    def layer(self, i: int) -> torch.Tensor:
        leaf = self._state.leaves[self._j]
        if leaf.dim is None:
            return leaf.shard[i]
        if leaf.dim == 0:   # a split layer dim: gather the stack, slice
            return self.full()[i]
        return _Gather.apply(leaf.shard, self._state, self._j, i)


def full(x) -> torch.Tensor:
    """An :class:`FsdpParam` gathered, or a tensor as it is."""
    return x.full() if isinstance(x, FsdpParam) else x


class _GatherParametrization(nn.Module):
    """A module-form step's sharded parameter: the module's attribute
    reads the gathered leaf in torch's layout (a view of the flax-layout
    buffer), its registered tensor is the shard."""

    def __init__(self, state: "FsdpState", j: int):
        super().__init__()
        self._fsdp = (state, j)    # a tuple: not a submodule

    def forward(self, original):
        state, j = self._fsdp
        got = _Gather.apply(original, state, j, None)
        perm = state.leaves[j].perm
        return got.permute(_inverse(perm)) if perm else got

    def right_inverse(self, value):
        state, j = self._fsdp
        leaf = state.leaves[j]
        v = value.permute(leaf.perm) if leaf.perm else value
        (a, b) = _index_of(leaf.gshape, leaf.dim, state.n,
                           state.comm.rank)[leaf.dim]
        return v.narrow(leaf.dim, a, b - a).detach().clone()


def _jit_block_quantize(v: torch.Tensor, mode: str, block: int):
    """``block_quantize`` as JAX's compiled step computes it: XLA turns
    the division of a block's maximum by the constant qmax into a
    product with qmax's f32 reciprocal."""
    from chainermn_torch.collectives import quantized as q

    qmax = q._QMAX[mode]
    b = torch.nn.functional.pad(v, (0, (-v.numel()) % block)).reshape(
        -1, block)
    scale = q._scale(b.abs().amax(dim=1), qmax, True).to(b.dtype)
    codes = q._codes(b, scale, qmax).reshape(-1).to(torch.int8)
    if mode == "int4-block":
        return q.pack_int4(codes), scale
    return codes, scale


def _wire_roundtrip(g: torch.Tensor, mode: str) -> torch.Tensor:
    """JAX's ``_wire_roundtrip`` (``zero.py:1186``) of a reduced
    full-leaf gradient in flax's layout, identical on every rank: bf16 a
    cast and back; the block formats in blocks of 256 over the flattened
    leaf; ``int8`` one amax/127 scale for the leaf."""
    from chainermn_torch.collectives.quantized import block_dequantize

    if not g.is_floating_point():
        return g
    if mode == "bf16":
        return g.to(torch.bfloat16).to(g.dtype)
    if mode in ("int8-block", "int4-block"):
        q, s = _jit_block_quantize(g.reshape(-1), mode, QUANT_BLOCK)
        return block_dequantize(q, s, g.numel(), mode, g.dtype).reshape(
            g.shape)
    amax = g.abs().amax()
    scale = torch.where(amax > 0, amax * (1.0 / 127.0),
                        torch.ones_like(amax)).to(g.dtype)
    return torch.clamp(torch.round(g / scale), -127, 127).to(g.dtype) \
        * scale


class FsdpState:
    """An FSDP step's state on this rank: ``leaves`` (each parameter's
    path, global flax shape, split dimension and ``shard``), ``shards``
    (the trainable tensors, in the flax tree's order: JAX's sharded
    ``params``), ``optimizer`` (the inner optimizer over the shards: its
    per-parameter state is sharded as its parameter), and the gathered
    bytes alive now and at most (``gathered_bytes``,
    ``gathered_bytes_peak``: every all-gathered leaf or layer until
    nothing holds it; ``layer_bytes``, ``layer_bytes_peak``: the layers
    of stacks that :func:`fsdp_scan_apply` gathered alone)."""

    def __init__(self, comm, leaves: List[_FsdpLeaf], tree: bool,
                 param_wire: Optional[str], quant_mode: Optional[str]):
        self.comm, self.n = comm, comm.size
        self.leaves = leaves
        self.shards = [leaf.shard for leaf in leaves]
        self.tree = tree
        self.param_wire, self.quant_mode = param_wire, quant_mode
        self.optimizer = None
        self.gathered_bytes = 0
        self.gathered_bytes_peak = 0
        self.layer_bytes = 0
        self.layer_bytes_peak = 0
        self._grads: List[Optional[torch.Tensor]] = [None] * len(leaves)

    # -- gathered bytes -------------------------------------------------

    def _track(self, nbytes: int) -> None:
        self.gathered_bytes += nbytes
        self.gathered_bytes_peak = max(self.gathered_bytes_peak,
                                       self.gathered_bytes)

    def _track_layer(self, nbytes: int) -> None:
        self.layer_bytes += nbytes
        self.layer_bytes_peak = max(self.layer_bytes_peak, self.layer_bytes)

    # -- the collectives ------------------------------------------------

    @torch.no_grad()
    def _gather(self, j: int, i: Optional[int],
                wire: Optional[str]) -> torch.Tensor:
        """Leaf ``j`` (its layer ``i``) all-gathered in flax's layout,
        through ``wire`` (None: uncompressed), inside a profiler span
        (``fsdp::gather``, ``fsdp::gather/layer=i``) whose allocations
        that outlive it are the gathered buffer (dlint's DL204); the
        temporaries die with :meth:`_gathered`'s frame, inside it."""
        span = GATHER_SPAN if i is None else f"{GATHER_SPAN}/layer={i}"
        with torch.profiler.record_function(span):
            out = self._gathered(j, i, wire)
        nbytes = out.numel() * out.element_size()
        self._track(nbytes)
        weakref.finalize(out, self._track, -nbytes)
        if i is not None:
            self._track_layer(nbytes)
            weakref.finalize(out, self._track_layer, -nbytes)
        return out

    def _gathered(self, j: int, i: Optional[int],
                  wire: Optional[str]) -> torch.Tensor:
        leaf = self.leaves[j]
        s = leaf.shard.detach()
        k = leaf.dim
        if i is not None:
            s, k = s[i], k - 1
        n, shape = self.n, tuple(s.shape)
        flat = s.contiguous().reshape(-1)
        # the result must be a tensor of its own, not a view: autograd
        # hands a view on as another tensor object, and the bytes are
        # counted on this one
        if wire is None and k == 0:
            out = torch.empty((n * shape[0], *shape[1:]), dtype=s.dtype,
                              device=s.device)
            self.comm.all_gather_flat(flat, out=out.view(-1))
            parts = None
        elif wire is None:
            parts = self.comm.all_gather_flat(flat).view(n, *shape)
        elif wire == "bf16":
            parts = self.comm.all_gather_flat(
                flat.to(torch.bfloat16)).view(n, *shape).to(s.dtype)
        else:
            from chainermn_torch.collectives.quantized import \
                block_dequantize

            blk = math.gcd(QUANT_BLOCK, flat.numel()) or 1
            q, sc = _jit_block_quantize(flat, wire, blk)
            qs = self.comm.all_gather_flat(q).view(n, -1)
            ss = self.comm.all_gather_flat(sc).view(n, -1)
            parts = torch.stack([
                block_dequantize(qs[r], ss[r], flat.numel(), wire,
                                 s.dtype, blk).view(shape)
                for r in range(n)])
        if parts is not None:
            out = torch.cat(parts.unbind(0), dim=k)
        return out

    @torch.no_grad()
    def _reduce(self, j: int, i: Optional[int], g: torch.Tensor) -> None:
        leaf, n = self.leaves[j], self.n
        k = leaf.dim if i is None else leaf.dim - 1
        if self.quant_mode is not None:
            # the global view: every rank reduces the whole leaf, rounds
            # it through the wire format and keeps its own slice later
            red = self.comm.reduce_flat(g.reshape(-1).clone()).div_(n)
            buf = self._grads[j]
            (buf if i is None else buf[i]).add_(red.view(g.shape))
            return
        flat = (g.reshape(-1) if k == 0 else torch.cat(
            [c.reshape(-1) for c in g.chunk(n, dim=k)]))
        tile = self.comm.reduce_scatter_flat(flat).div_(n)
        buf = self._grads[j]
        dst = buf if i is None else buf[i]
        dst.add_(tile.view(dst.shape))

    def _begin(self) -> None:
        for j, leaf in enumerate(self.leaves):
            leaf.shard.grad = None
            if leaf.dim is None:
                self._grads[j] = None
            elif self.quant_mode is not None:
                self._grads[j] = torch.zeros(
                    leaf.gshape, dtype=leaf.shard.dtype,
                    device=leaf.shard.device)
            else:
                self._grads[j] = torch.zeros_like(leaf.shard)

    @torch.no_grad()
    def _finish(self) -> None:
        """The shards' gradients: replicated leaves' mean-all-reduced in
        one collective; with a quantized reducer every leaf's reduced
        gradient rounded through its wire format, then this rank's
        slice."""
        r, n = self.comm.rank, self.n
        repl = [leaf for leaf in self.leaves if leaf.dim is None]
        if repl:
            gs = [leaf.shard.grad if leaf.shard.grad is not None
                  else torch.zeros_like(leaf.shard) for leaf in repl]
            red = self.comm.reduce_flat(torch.cat(
                [t.reshape(-1) for t in gs])).div_(n)
            off = 0
            for leaf in repl:
                m = leaf.shard.numel()
                g = red[off:off + m].view(leaf.shard.shape)
                off += m
                if self.quant_mode is not None:
                    g = _wire_roundtrip(g, self.quant_mode)
                leaf.shard.grad = g
        for j, leaf in enumerate(self.leaves):
            if leaf.dim is None:
                continue
            g = self._grads[j]
            if self.quant_mode is not None:
                g = _wire_roundtrip(g, self.quant_mode)
                a, b = _index_of(leaf.gshape, leaf.dim, n, r)[leaf.dim]
                g = g.narrow(leaf.dim, a, b - a).contiguous()
            leaf.shard.grad = g
            self._grads[j] = None

    # -- host views -----------------------------------------------------

    def optimizer_state_numel(self) -> int:
        """Elements of the inner optimizer's tensor state on this rank."""
        return sum(v.numel() for s in self.optimizer.state.values()
                   for v in s.values()
                   if torch.is_tensor(v) and v.ndim > 0)

    def _sharded(self, j: int):
        from chainermn_torch.extensions.checkpoint import ShardedLeaf

        leaf = self.leaves[j]
        if leaf.dim is None:
            return leaf.shard
        return ShardedLeaf(leaf.shard, leaf.gshape, _index_of(
            leaf.gshape, leaf.dim, self.n, self.comm.rank))

    def state_dict(self, template: bool = False) -> dict:
        """This rank's part, for the checkpointer: ``params`` (a sharded
        leaf per split parameter, the tensor of a replicated one), the
        inner optimizer's state with each per-element tensor sharded as
        its parameter (JAX matches them by tree-path suffix and shape),
        and the layout's manifest; ``template`` as
        :meth:`ZeroState.state_dict`."""
        params = [self._sharded(j) for j in range(len(self.leaves))]
        return {"params": params,
                "optimizer": _sharded_optimizer_state(
                    self.optimizer, self.shards, params, template),
                "layout": self.manifest()}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Load :meth:`state_dict` output in place (as saved, or restored
        onto this world by the checkpointer). Another model's state is
        refused."""
        want = [(row["path"], row["shape"])
                for row in self.manifest()["leaves"]]
        got = [(row["path"], row["shape"])
               for row in state["layout"]["leaves"]]
        if got != want:
            raise ValueError("the state's leaves (path, shape) are not "
                             "this step's: another model")
        for leaf, src in zip(self.leaves, state["params"]):
            leaf.shard.copy_(_local(src).reshape(leaf.shard.shape))
        self.optimizer.load_state_dict(_local_tree(state["optimizer"]))

    def manifest(self) -> dict:
        """:func:`fsdp_layout_manifest` of this step's layout."""
        ax = self.comm.axis_name
        return {"kind": "fsdp", "n": self.n, "leaves": [
            {"path": _path_str(leaf.path),
             "shape": [int(d) for d in leaf.gshape],
             "spec": ([] if leaf.dim is None
                      else [None] * leaf.dim + [ax])}
            for leaf in self.leaves]}


def _norm_reduce(comm, sharded_ids):
    """LARS/LAMB's hook under FSDP: every leaf's partial squared norm
    (of the parameters, then of the updates) summed over the group in
    one all-reduce, so a shard's trust ratio is its whole leaf's (a
    replicated leaf keeps its own)."""
    def reduce(params, sq):
        mask = torch.tensor([id(p) in sharded_ids for p in params] * 2,
                            device=sq.device)
        return torch.where(mask, comm.allreduce(sq, "sum"), sq)
    return reduce


class _FsdpStep:
    """The FSDP step; ``step(x, y)`` runs it."""

    def __init__(self, model, optimizer, comm, params, loss_fn, remat,
                 param_shardings, grad_reducer, param_wire):
        from chainermn_torch.collectives import make_grad_reducer
        from chainermn_torch.collectives.quantized import QUANT_MODES
        from chainermn_torch.optimizers.large_batch import LAMB, LARS
        from chainermn_torch.training.step import classifier_loss

        comm.axis_name  # raises on a multi-axis communicator (split it)
        tree = params is not None
        if not tree and not isinstance(model, nn.Module):
            raise ValueError("make_fsdp_train_step needs a module, or "
                             "params (a tree) and a loss_fn")
        if not tree:
            from chainermn_torch.links import batch_norm_layers

            if batch_norm_layers(model):
                raise ValueError(
                    "FSDP steps train models without mutable collections;"
                    " a model with batch statistics trains through "
                    "make_data_parallel_train_step")
        reducer = make_grad_reducer(grad_reducer, comm, op="mean")
        if reducer is not None and reducer.stateful:
            raise ValueError(_STATEFUL_FSDP.format(name=reducer.name))
        quant = (getattr(reducer, "mode", None)
                 if reducer is not None and reducer.name == "quantized"
                 else None)
        if param_wire == "f32":
            param_wire = None
        if param_wire is not None and param_wire not in QUANT_MODES:
            raise ValueError(f"unknown param_wire {param_wire!r}; expected "
                             f"one of {('f32',) + QUANT_MODES}")
        if param_wire == "int8":
            param_wire = "int8-block"
        n, r = comm.size, comm.rank
        self.model, self.comm, self.remat = model, comm, remat
        self.lf = loss_fn or classifier_loss
        if tree:
            if param_shardings is None:
                at = _find_stacked_subtree(params, n)
                if at is not None:
                    warnings.warn(
                        f"make_fsdp_train_step: params[{at}] looks like a "
                        "scanned layer stack (>= 2 leaves sharing a "
                        "leading dim divisible by comm.size="
                        f"{n}); the default fsdp_shardings rule will "
                        "shard the LAYER dim, so each layer of "
                        "fsdp_scan_apply gathers the whole stack and "
                        "its per-layer liveness bound is lost. Pass "
                        "param_shardings=fsdp_stack_shardings(params, "
                        "comm) (or a mixed tree) to shard within layers "
                        "instead.", UserWarning, stacklevel=3)
            specs = dict(_tree_items(param_shardings if param_shardings
                                     is not None
                                     else fsdp_shardings(params, comm)))
            items = [(path, None, torch.as_tensor(leaf))
                     for path, leaf in _tree_items(params)]
        else:
            specs = (param_shardings if param_shardings is not None
                     else fsdp_shardings(model, comm))
            items = [(path, perm, p) for _, path, perm, p in
                     _module_leaves(model)]
            names = [name for name, *_ in _module_leaves(model)]
        leaves = []
        for k, (path, perm, t) in enumerate(items):
            tdim = specs[path] if tree else specs[names[k]]
            dim = (None if tdim is None else
                   (perm.index(tdim) if perm else tdim))
            with torch.no_grad():
                flat = t.detach().permute(perm) if perm else t.detach()
                if dim is not None:
                    a, b = _index_of(flat.shape, dim, n, r)[dim]
                    flat = flat.narrow(dim, a, b - a)
                shard = nn.Parameter(flat.contiguous().clone())
            leaves.append(_FsdpLeaf(path, tuple(int(d) for d in
                                                (t.permute(perm).shape
                                                 if perm else t.shape)),
                                    dim, perm, shard))
        state = FsdpState(comm, leaves, tree, param_wire, quant)
        if tree:
            self.params = _tree_build(
                (leaf.path, FsdpParam(state, j))
                for j, leaf in enumerate(leaves))
        else:
            self._wire_module(state, names)
        self.state = state
        opt = optimizer(state.shards)
        if isinstance(opt, (LARS, LAMB)):
            opt.norm_reduce = _norm_reduce(
                comm, {id(leaf.shard) for leaf in leaves
                       if leaf.dim is not None})
        else:
            _require_elementwise(optimizer, state.shards)
        state.optimizer = opt
        self.dev = leaves[0].shard.device if leaves else torch.device(
            "cpu")

    def _wire_module(self, state: FsdpState, names: List[str]) -> None:
        """Replace each parameter of the module by its shard: a sharded
        one through a parametrization that gathers it on every read, a
        replicated one by the state's tensor itself."""
        from torch.nn.utils import parametrize

        for j, (name, leaf) in enumerate(zip(names, state.leaves)):
            owner, _, attr = name.rpartition(".")
            mod = self.model.get_submodule(owner) if owner else self.model
            if leaf.dim is None:
                setattr(mod, attr, leaf.shard)
                continue
            with torch.no_grad():
                parametrize.register_parametrization(
                    mod, attr, _GatherParametrization(state, j),
                    unsafe=True)
            # the registered tensor (right_inverse's shard) is the one
            # the optimizer steps
            orig = getattr(mod.parametrizations, attr).original
            leaf.shard = state.shards[j] = orig

    def _loss(self, x, y):
        if self.state.tree:
            loss, (acc, _) = self.lf(self.model, self.params, x, y,
                                     train=True)
        else:
            loss, (acc, _) = self.lf(self.model, x, y, train=True)
        return loss, acc

    def __call__(self, x, y):
        st = self.state
        x = torch.as_tensor(x, device=self.dev)
        y = torch.as_tensor(y, device=self.dev)
        st._begin()
        if self.remat:
            loss, acc = checkpoint(self._loss, x, y, use_reentrant=False)
        else:
            loss, acc = self._loss(x, y)
        loss.backward()
        st._finish()
        st.optimizer.step()
        for s in st.shards:
            s.grad = None
        met = self.comm.allreduce(
            torch.stack([loss.detach().float(), acc.detach().float()]),
            "mean")
        return {"main/loss": met[0], "main/accuracy": met[1]}


def make_fsdp_train_step(model, optimizer, comm, params=None,
                         loss_fn: Optional[Callable] = None,
                         donate: bool = True, remat=False,
                         param_shardings=None, grad_reducer=None,
                         param_wire: Optional[str] = None):
    """ZeRO-3 (FSDP): parameters and optimizer state sharded over the
    communicator, every use gathered just in time. ``(step, state)``;
    ``step(x, y)`` updates in place and returns ``{"main/loss",
    "main/accuracy"}`` averaged over the communicator; ``state`` is an
    :class:`FsdpState` (module docstring: ``optimizer`` is a factory
    ``list[Tensor] -> torch.optim.Optimizer`` over the shards).

    Two forms. **Module**: ``model`` is the module (its parameters
    should agree on every rank), ``loss_fn(model, x, y, train)`` as the
    data-parallel step's; each split parameter of the module becomes its
    shard, read through a parametrization that all-gathers it on every
    access, and a replicated one stays whole. **Tree**: ``params`` is a
    nested dict of tensors in flax's layout (as :func:`~chainermn_torch.
    models.transformer.stack_lm_blocks` gives) and ``loss_fn(model, p,
    x, y, train)`` reads ``p``'s :class:`FsdpParam` leaves with
    :func:`full` (or :func:`fsdp_scan_apply`, one layer at a time);
    ``model`` is passed through.

    Each leaf splits along its first divisible dimension in flax's
    layout (``param_shardings``: per-leaf split dimensions overriding
    :func:`fsdp_shardings`, in the same form; without it a tree that
    looks like a layer stack warns, as JAX's does), so rank ``r``'s
    shard holds JAX's shard ``r``. The gather's backward
    mean-reduce-scatters the gradient onto the shard; replicated leaves'
    gradients are mean-all-reduced after the backward. ``remat`` runs
    the loss under ``torch.utils.checkpoint``, so the backward gathers
    again. ``grad_reducer``: None, ``'flat'``, ``'hierarchical'`` and
    ``'auto'`` are the identity; a stateless ``QuantizedReducer``
    all-reduces each leaf's whole gradient, rounds it through its wire
    format as JAX's global view does and keeps this rank's slice; a
    stateful one is refused. ``param_wire`` (``'bf16'``,
    ``'int8'``/``'int8-block'``, ``'int4-block'``; ``'f32'``/None
    uncompressed) quantizes each rank's shard in blocks of
    ``gcd(256, shard size)``, all-gathers codes and f32 scales and
    dequantizes; its backward is straight-through. LARS and LAMB get
    their trust ratios' norms summed over the group (one all-reduce a
    step); any other optimizer must be element-wise (the ZeRO probe).
    Models with batch statistics are refused. ``donate`` has no effect.
    """
    del donate
    step = _FsdpStep(model, optimizer, comm, params, loss_fn, remat,
                     param_shardings, grad_reducer, param_wire)
    return step, step.state


def fsdp_scan_apply(block_fn, stacked, h, *, remat: bool = True):
    """Apply ``L`` homogeneous blocks over a stacked tree: a loop over
    the layer dimension in which iteration ``i`` reads only layer ``i``
    (an :class:`FsdpParam` gathers that layer alone; a tensor is
    sliced), calling ``block_fn(p_i, h)``. With ``remat`` (default) each
    iteration runs under ``torch.utils.checkpoint``, so its gathered
    layer dies with the iteration and the backward gathers it again:
    the peak of gathered parameters is one layer, not the model."""
    items = list(_tree_items(stacked))
    if not items:
        return h
    L = items[0][1].shape[0]

    def body(i, h):
        p_i = _tree_build(
            (path, leaf.layer(i) if isinstance(leaf, FsdpParam)
             else leaf[i]) for path, leaf in items)
        return block_fn(p_i, h)

    for i in range(L):
        if remat and torch.is_grad_enabled():
            h = checkpoint(body, i, h, use_reentrant=False)
        else:
            h = body(i, h)
    return h


@torch.no_grad()
def fsdp_gather_params(state: FsdpState) -> dict:
    """The full parameter tree as host numpy in flax's layout (a
    collective every rank calls): JAX's tree for a module-form state,
    the given tree's structure for a tree-form one."""
    out = []
    for j, leaf in enumerate(state.leaves):
        t = (leaf.shard.detach() if leaf.dim is None
             else state._gather(j, None, None))
        out.append((leaf.path, t.cpu().numpy().copy()))
    return _tree_build(out)


def fsdp_layout_manifest(params, comm, param_shardings=None) -> dict:
    """Per-leaf path, global shape and partition spec of an FSDP layout
    (JAX's ``zero.py:1268``, equal to it for the same tree and world):
    ``params`` a module (its flax tree) or a tree in flax's layout;
    ``param_shardings`` as :func:`make_fsdp_train_step` takes it. Host
    metadata only (``checkpointer.set_layout``)."""
    ax, n = comm.axis_name, comm.size
    specs = (param_shardings if param_shardings is not None
             else fsdp_shardings(params, comm))
    rows = []
    if isinstance(params, nn.Module):
        for name, path, perm, p in _module_leaves(params):
            tdim = specs[name]
            rows.append((path, _flax_shape(p.shape, perm),
                         None if tdim is None else
                         (perm.index(tdim) if perm else tdim)))
    else:
        spec_of = dict(_tree_items(specs))
        rows = [(path, tuple(np.shape(leaf)), spec_of[path])
                for path, leaf in _tree_items(params)]
    return {"kind": "fsdp", "n": n, "leaves": [
        {"path": _path_str(path), "shape": [int(d) for d in shape],
         "spec": [] if k is None else [None] * k + [ax]}
        for path, shape, k in rows]}
