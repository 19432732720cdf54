"""ZeRO-1 and ZeRO-2: sharded optimizer state over the data axis.

Counterpart of the ZeRO-1/2 half of ``chainermn_tpu/optimizers/zero.py``
(``:40-842``, ``:1243-1265``). The parameters are packed, in the flax
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

The FSDP half (``make_fsdp_train_step``, ``fsdp_*``,
``fsdp_layout_manifest``) waits for ROADMAP.md queue 1 item 8b.
"""

from __future__ import annotations

import functools
import weakref
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from chainermn_torch.comm.distributed import plan_buckets

__all__ = ["make_zero1_train_step", "make_zero2_train_step", "zero1_params",
           "zero_layout_manifest", "ZeroState", "make_fsdp_train_step",
           "fsdp_shardings", "fsdp_stack_shardings", "fsdp_scan_apply",
           "fsdp_gather_params", "fsdp_layout_manifest"]

#: the padding quantum: any world size dividing it gives the same padded
#: global length (JAX's, so layouts and manifests agree)
QUANTUM = 256

_ITEM8B = ("waits for the FSDP and checkpointing slice of the port "
           "(ROADMAP.md queue 1 item 8b)")

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

    def state_dict(self) -> dict:
        """This rank's shards, the inner optimizer's state, the residuals
        and the layout's manifest."""
        return {"params": list(self.shards),
                "optimizer": self.optimizer.state_dict(),
                "residuals": list(self.residuals),
                "layout": _manifest(self.layout, self.bucketed,
                                    self.comm.size)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Load :meth:`state_dict` output in place, then gather the
        parameters."""
        want = _manifest(self.layout, self.bucketed, self.comm.size)
        if state["layout"] != want:
            raise ValueError(f"the state's layout {state['layout']} is not "
                             f"this step's {want}")
        for dst, src in zip(self.shards, state["params"]):
            dst.copy_(torch.as_tensor(src))
        self.optimizer.load_state_dict(state["optimizer"])
        for dst, src in zip(self.residuals, state["residuals"]):
            dst.copy_(torch.as_tensor(src))
        self.gather()


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


def _later(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"{name} {_ITEM8B}")
    refuse.__name__ = name
    refuse.__doc__ = f"``{name}``: {_ITEM8B}."
    return refuse


make_fsdp_train_step = _later("make_fsdp_train_step")
fsdp_shardings = _later("fsdp_shardings")
fsdp_stack_shardings = _later("fsdp_stack_shardings")
fsdp_scan_apply = _later("fsdp_scan_apply")
fsdp_gather_params = _later("fsdp_gather_params")
fsdp_layout_manifest = _later("fsdp_layout_manifest")
