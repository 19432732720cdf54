"""Heterogeneous pipeline stages over the homogeneous 1F1B schedule.

Counterpart of ``chainermn_tpu/parallel/hetero_pipeline.py``. The 1F1B
schedule (:mod:`chainermn_torch.parallel.pipeline`) moves ONE activation
shape between ranks and runs ONE stage-function form; a real model is
embed → N×block → head, int tokens in, ``[mb, L, D]`` activations between
blocks, ``[mb, L, vocab]`` logits out, with stage parameters of different
structures. This layer compiles the differences away at the edges, as
JAX's does:

* **Activation wire**: every inter-stage edge is encoded into one flat
  ``[W]`` buffer (ravel → cast → zero-pad to the widest edge that
  travels). Decoding slices, casts and reshapes. Every edge goes through
  the wire's cast: an f32 activation that crosses a bf16 wire is
  rounded, and integer inputs (token ids) ride an f32 wire exactly below
  2^24.
* **Final stage in the loss** (``head_in_loss``, default for S ≥ 2): the
  last stage's OUTPUT never travels — it dies in the local loss on its
  own rank, so the wire is sized by the stages' inputs (for an LM
  ``mb·L·d_model``, not ``mb·L·vocab``). The last rank's stage function
  is the identity on the wire and its real compute runs in the
  schedule's loss hook, differentiating that rank's own parameter row.
* **Parameter wire**: each stage's parameter pytree flattens (leaves in
  ``jax.tree_util`` order: dict keys sorted) into an f32 vector padded to
  the widest stage, JAX's ``[S, P]`` stack. A rank holds only its own
  row.
* **Stage dispatch**: each rank runs its own stage, by its rank in the
  communicator (JAX's ``lax.switch`` on ``axis_index``); every stage has
  the uniform form ``([P] f32, [W] wire) -> [W] wire``.

Each stage's activation shapes come from the stage run on meta tensors
(the port's ``jax.eval_shape``), so a stage of another rank needs only
its parameters' shapes and dtypes here: meta tensors will do.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from chainermn_torch.parallel.pipeline import (
    _gpipe, _run_1f1b, _plain_schedule, _stage_act_dtype, eval_shape,
    pipeline_1f1b_value_and_grad, tree_leaves, tree_unflatten)

__all__ = ["HeteroPipeline", "hetero_pipeline_1f1b_value_and_grad",
           "hetero_pipeline_apply", "wire_aval"]


def wire_aval(x) -> torch.Tensor:
    """An activation's shape and dtype as a meta tensor (JAX's
    ``ShapeDtypeStruct``): ``x`` a tensor (any device) or a
    ``(shape, dtype)`` pair."""
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    shape, dtype = x
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _name(dtype: torch.dtype) -> str:
    """A dtype as JAX's messages print it (``float32``, ``bfloat16``)."""
    return str(dtype).replace("torch.", "")


def _is_int(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def _numel(aval) -> int:
    return int(math.prod(aval.shape))


def _check_wire(ring_avals, wire_dtype, int_bound):
    """An integer edge on a float wire is exact only below the mantissa
    bound (f32 → 2^24 covers any real vocab; f16 → 2^11, bf16 → 2^8 do
    not)."""
    for a in ring_avals:
        if _is_int(a.dtype) and wire_dtype.is_floating_point:
            mant = round(-math.log2(torch.finfo(wire_dtype).eps))
            if 2 ** (mant + 1) < int_bound:
                raise ValueError(
                    f"integer activations up to int_bound={int_bound} "
                    f"cannot ride a {_name(wire_dtype)} wire "
                    f"({mant}-bit mantissa: exact only below "
                    f"{2 ** (mant + 1)}); use wire_dtype=torch.float32 "
                    "or declare a smaller int_bound")


def _wire_dtype(ring_avals, wire_dtype):
    if wire_dtype is not None:
        return wire_dtype
    out = ring_avals[0].dtype
    for a in ring_avals[1:]:
        out = torch.promote_types(out, a.dtype)
    return out


class _ParamLayout:
    """Per-stage flat parameter layout: the leaves in ``jax.tree_util``
    order raveled into one vector, padded with zeros to the widest stage
    in the f32 parameter wire."""

    def __init__(self, params: Sequence[Any]):
        self.trees = list(params)
        for p in self.trees:
            for leaf in tree_leaves(p):
                dt = leaf.dtype
                if not dt.is_floating_point or dt.itemsize > 4:
                    raise ValueError(
                        "stage params must be <=32-bit floating-point "
                        f"leaves — the param wire is f32 and would "
                        f"silently truncate {_name(dt)}")
        self.sizes = [sum(leaf.numel() for leaf in tree_leaves(p))
                      for p in self.trees]
        self.param_elems = max(self.sizes, default=1) or 1

    def pack(self, s: int) -> torch.Tensor:
        leaves = tree_leaves(self.trees[s])
        dev = leaves[0].device if leaves else None
        flat = (torch.cat([leaf.detach().reshape(-1).float()
                           for leaf in leaves]) if leaves
                else torch.zeros(0, device=dev))
        return F.pad(flat, (0, self.param_elems - flat.numel()))

    def unflatten(self, s: int, flat: torch.Tensor):
        leaves, at = [], 0
        for leaf in tree_leaves(self.trees[s]):
            n = leaf.numel()
            leaves.append(flat[at:at + n].to(leaf.dtype).reshape(leaf.shape))
            at += n
        return tree_unflatten(self.trees[s], leaves)


class _Codec:
    """The wire discipline both pipelines share: activations ravel, cast
    and pad to ``wire_elems`` of ``wire_dtype``; each stage's parameters
    are one f32 row of ``_layout``."""

    wire_elems: int
    wire_dtype: torch.dtype
    S: int
    _layout: _ParamLayout

    def encode_act(self, x):
        """ravel → cast → pad to the wire width."""
        flat = x.reshape(-1).to(self.wire_dtype)
        return F.pad(flat, (0, self.wire_elems - flat.numel()))

    def decode_act(self, wire, aval):
        n = _numel(aval)
        return wire[:n].to(aval.dtype).reshape(aval.shape)

    def encode_inputs(self, x_microbatches):
        """[M, ...] micro-batches → [M, W] wire buffers (stage 0 feed)."""
        x = torch.as_tensor(x_microbatches)
        flat = x.reshape(x.shape[0], -1).to(self.wire_dtype)
        return F.pad(flat, (0, self.wire_elems - flat.shape[1]))

    def pack_params(self, rank: int = None) -> torch.Tensor:
        """Rank ``rank``'s ``[P]`` f32 row (the stage's parameters raveled
        in ``jax.tree_util`` order and zero-padded), or with no rank JAX's
        ``[S, P]`` stack of every row (every stage's parameters must then
        hold data)."""
        if rank is not None:
            return self._layout.pack(rank)
        return torch.stack([self._layout.pack(s) for s in range(self.S)])

    def _unflatten(self, s: int, flat):
        return self._layout.unflatten(s, flat)

    def unpack_grads(self, flat_grads, rank: int = None) -> List[Any]:
        """``[S, P]`` flat gradient stack → per-stage param-pytree grads;
        with ``rank``, that rank's ``[P]`` row → its stage's pytree.

        The parameter wire is f32, so each leaf's gradient comes back as
        the f32 cotangent of the cast — cast to the leaf dtype here.
        """
        if rank is not None:
            return self._unflatten(rank, flat_grads)
        return [self._unflatten(s, flat_grads[s]) for s in range(self.S)]


class HeteroPipeline(_Codec):
    """Codec + dispatch layer turning per-stage (fn, params) pairs into the
    homogeneous wire-format pipeline the 1F1B schedule requires.

    Args:
      stage_defs: ``[(fn_0, params_0), ..., (fn_{S-1}, params_{S-1})]`` —
        ``fn_s(params_s, x) -> y`` with arbitrary (static) activation
        shapes; stage s+1 consumes stage s's output. Params are pytrees
        of <=32-bit float tensors (they are trained); another rank's
        stage may give meta tensors (only their shapes are read).
      sample_mb: one example micro-batch (a tensor, a meta tensor, or a
        ``(shape, dtype)`` pair) — stage 0's input, e.g. int ``[mb, L]``
        tokens.
      comm: the stage communicator (JAX's ``axis_name``); its size must
        equal ``len(stage_defs)`` when a step runs.
      wire_dtype: activation wire dtype; default = the widest dtype among
        the edges that travel (``torch.promote_types`` over them).
      int_bound: exclusive upper bound the caller guarantees for values on
        integer edges (token ids, …); the wire must represent every value
        below it exactly or construction fails. Default 2^24 — the f32
        mantissa bound, enough for any real vocabulary.
      head_in_loss: run the final stage inside the schedule's loss hook so
        its output edge never needs a wire slot (see module docstring).
        Default: True whenever S ≥ 2. With False (or S = 1) every edge
        including the final output rides the wire.

    ``pack_params(rank)`` gives one rank's flat ``[P]`` f32 row, the only
    parameters that rank trains; ``pack_params()`` gives JAX's whole
    ``[S, P]`` stack, whose row ``r`` holds the same numbers (a caller
    that has every stage's parameters may slice it).
    """

    def __init__(self, stage_defs: Sequence[Tuple[Callable, Any]],
                 sample_mb, comm, wire_dtype=None,
                 int_bound: int = 2 ** 24, head_in_loss: bool = None):
        self.comm = comm
        self.fns = [f for f, _ in stage_defs]
        self.params = [p for _, p in stage_defs]
        self.S = len(stage_defs)
        if self.S < 1:
            raise ValueError("need at least one stage")
        if head_in_loss is None:
            head_in_loss = self.S >= 2
        if head_in_loss and self.S < 2:
            raise ValueError("head_in_loss needs S >= 2 (the ring must "
                             "have at least one non-head stage)")
        self.head_in_loss = head_in_loss

        # ---- activation avals along the chain -------------------------
        avals = [wire_aval(sample_mb)]
        for fn, p in stage_defs:
            out = eval_shape(fn, p, avals[-1])
            if not isinstance(out, torch.Tensor):
                raise ValueError(
                    "each stage must return a single array; got "
                    f"{type(out).__name__}")
            avals.append(out)
        self.in_avals = avals[:-1]   # stage s consumes in_avals[s]
        self.out_avals = avals[1:]   # stage s produces out_avals[s]

        # edges that travel between ranks: with head_in_loss the final
        # output (avals[-1], e.g. logits) is consumed locally on the last
        # rank and never encoded
        ring_avals = avals[:-1] if head_in_loss else avals
        self.wire_elems = max(_numel(a) for a in ring_avals)
        self.wire_dtype = _wire_dtype(ring_avals, wire_dtype)
        _check_wire(ring_avals, self.wire_dtype, int_bound)

        # ---- per-stage flat parameter layout --------------------------
        self._layout = _ParamLayout(self.params)
        self.param_elems = self._layout.param_elems

    # ---- the per-rank pieces ------------------------------------------

    def _check_comm(self):
        n = self.comm.size
        if n != self.S:
            raise ValueError(
                f"HeteroPipeline has {self.S} stages but the stage "
                f"communicator spans {n} ranks — each rank runs the stage "
                "of its own rank")

    def stage_fn(self, flat_params, wire_h):
        """The homogeneous ``(params, h) -> h`` the schedule runs: this
        rank's stage. With ``head_in_loss`` the final stage is the
        identity on the wire — its input flows unchanged to the loss
        hook (forward) and its cotangent unchanged back (backward)."""
        s = self.comm.rank
        if self.head_in_loss and s == self.S - 1:
            return wire_h
        x = self.decode_act(wire_h, self.in_avals[s])
        y = self.fns[s](self._unflatten(s, flat_params), x)
        return self.encode_act(y)

    def wire_loss_fn(self, loss_fn):
        """Wrap ``loss_fn(decoded_final_output, tgt)`` for the schedule.

        head_in_loss: returns ``(head_flat, wire, tgt) -> scalar`` for the
        ``head_params`` hook — decode the wire as the final stage's INPUT,
        apply the final stage from its flat param row, then the user
        loss. Otherwise: ``(wire, tgt) -> scalar`` decoding the final
        output directly.
        """
        if self.head_in_loss:
            def f(head_flat, wire_out, tgt):
                return loss_fn(self.head_apply(head_flat, wire_out), tgt)

            return f

        last = self.out_avals[-1]

        def f(wire_out, tgt):
            return loss_fn(self.decode_act(wire_out, last), tgt)

        return f

    def head_apply(self, flat_params, wire):
        """Final stage's forward from its flat param row, on a decoded
        head-input wire."""
        s = self.S - 1
        x = self.decode_act(wire, self.in_avals[s])
        return self.fns[s](self._unflatten(s, flat_params), x)


def hetero_pipeline_1f1b_value_and_grad(
    pipe: HeteroPipeline,
    loss_fn: Callable,
    packed_params,
    x_microbatches_wire,
    y_microbatches,
):
    """1F1B train step over heterogeneous stages, on every rank of
    ``pipe.comm``.

    Args:
      pipe: the :class:`HeteroPipeline` (built once, the same on every
        rank).
      loss_fn: ``(final_stage_output, target) -> scalar`` on DECODED
        outputs. No collectives over the STAGE ranks (with
        ``head_in_loss`` it runs on the final stage's rank only);
        collectives over orthogonal ranks are fine.
      packed_params: THIS rank's ``[P]`` flat stage parameters
        (``pipe.pack_params(comm.rank)``).
      x_microbatches_wire: ``[M, W]`` wire-encoded inputs
        (``pipe.encode_inputs``), the same on every rank.
      y_microbatches: ``[M, ...]`` targets, the same on every rank.

    Returns ``(loss, flat_grads [P])`` — THIS rank's row; decode with
    ``pipe.unpack_grads(flat_grads, comm.rank)``. With ``head_in_loss`` the
    final stage's gradient (computed through the loss hook) is folded
    into the last rank's row here, so the result is identical in shape
    and meaning either way.
    """
    pipe._check_comm()
    if not pipe.head_in_loss:
        return pipeline_1f1b_value_and_grad(
            pipe.stage_fn, pipe.wire_loss_fn(loss_fn), packed_params,
            x_microbatches_wire, y_microbatches, pipe.comm)

    # the final stage differentiates the last rank's own row through the
    # loss hook; only that rank runs it, so its gradient stays there
    # (JAX's psum of it, masked back onto the owner's slot, is the same
    # numbers)
    comm = pipe.comm
    mb_shape = tuple(x_microbatches_wire.shape[1:])
    act = _stage_act_dtype(pipe.stage_fn, packed_params, mb_shape,
                           x_microbatches_wire.dtype)
    loss, grads, hg, _ = _run_1f1b(
        pipe.stage_fn, pipe.wire_loss_fn(loss_fn), [packed_params],
        x_microbatches_wire, y_microbatches, comm,
        _plain_schedule(comm.size, x_microbatches_wire.shape[0]), act,
        head_params=packed_params, return_input_grads=False,
        replicate_head=False)
    return loss, grads[0] + hg


@torch.no_grad()
def hetero_pipeline_apply(pipe: HeteroPipeline, packed_params,
                          x_microbatches_wire):
    """GPipe-style forward over heterogeneous stages, on every rank.
    Returns DECODED final outputs ``[M, *out_avals[-1].shape]`` (the same
    on every rank). With ``head_in_loss`` the ranks deliver the final
    stage's inputs; its forward then runs on its own rank and the result
    is broadcast."""
    pipe._check_comm()
    comm, n = pipe.comm, pipe.comm.size
    mb_shape = tuple(x_microbatches_wire.shape[1:])
    act = _stage_act_dtype(pipe.stage_fn, packed_params, mb_shape,
                           x_microbatches_wire.dtype)
    outs = _gpipe(pipe.stage_fn, packed_params, x_microbatches_wire, comm,
                  act)
    final = pipe.out_avals[-1]
    ys = None
    if outs is not None:
        if pipe.head_in_loss:
            ys = torch.stack([pipe.head_apply(packed_params, w)
                              for w in outs]).to(final.dtype)
        else:
            ys = torch.stack([pipe.decode_act(w, final) for w in outs])
    if n == 1:
        return ys
    if ys is None:
        ys = torch.zeros((x_microbatches_wire.shape[0],) + tuple(
            final.shape), dtype=final.dtype,
            device=x_microbatches_wire.device)
    return comm.bcast(ys, root=n - 1)
