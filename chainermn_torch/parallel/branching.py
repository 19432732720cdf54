"""Branching (DAG) pipeline: one stage a rank for tree-shaped chain
graphs.

Counterpart of ``chainermn_tpu/parallel/branching.py`` (reference:
chainermn/links/multi_node_chain_list.py — ``add_link(chain, rank_in,
rank_out)`` builds branching graphs: several ``rank_out``, multi-input
stages). The chain list's lowering for graphs the 1F1B pipeline rejects.

* **Topology** (JAX's checks and names): stages form a DAG in
  topological order, stage ``s`` on rank ``s``; ``preds[s]`` names its
  producers. Roots (no preds) consume the global micro-batch; exactly ONE
  sink (the head) feeds the loss. ``depth[s]`` = longest path from a
  root; stages at the same depth compute in the same tick on different
  ranks.
* **Wire format**: HeteroPipeline's codec — activations ravel/cast/pad
  to the widest TRAVELING edge (the head's output never travels: its
  compute runs in the loss phase on its own rank); each stage's
  parameters ravel into an f32 row, and a rank holds only its own.
* **Schedule** (GPipe fill–drain): ``depth[head] + M`` ticks, stage ``s``
  on micro-batch ``t - depth[s]``. At the end of each tick a rank sends
  each edge's micro-batch to its consumers, in one exchange with the
  messages its producers sent it that tick; a message whose consumer
  sits more than one level lower (a skip edge, uneven branches into a
  join) waits in the consumer's inbox until the consumer's depth comes
  (JAX's delay lines). The head then takes the loss over every
  micro-batch.
* **Backward**: the same ticks in reverse. A rank sums the cotangents
  its consumers send back for one micro-batch (fan-out), runs its
  stage's backward (``remat=True`` re-runs the tick's forward from its
  saved inputs; ``remat=False`` keeps the forward's graph) and sends
  each input's cotangent to its producer (fan-in). The messages pair
  inside each tick on every route, NCCL included; the autograd
  point-to-point the chain list's forward uses would order the
  backward's messages by autograd's traversal, which a route that
  matches no tags cannot follow.

The JAX package's gradients here are wrong (docs/known_failures.md
"branching-pipeline-gradient-over-count": a join's cotangent is counted
once per incoming edge plus the skip path). The port's are the
sequential chain's gradient of the mean loss.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from chainermn_torch.parallel.hetero_pipeline import (
    _check_wire, _Codec, _numel, _ParamLayout, _wire_dtype, wire_aval)
from chainermn_torch.parallel.pipeline import (PIPE_TAG, _exchange,
                                               _grads, eval_shape)

__all__ = ["BranchingPipeline", "branching_pipeline_value_and_grad",
           "branching_pipeline_apply"]


def _fwd_tag(k: int) -> int:
    return PIPE_TAG + 2 + 2 * k


def _bwd_tag(k: int) -> int:
    return PIPE_TAG + 3 + 2 * k


class BranchingPipeline(_Codec):
    """Codec + schedule metadata for a DAG of stages (see module doc).

    Args:
      stage_defs: ``[(fn_s, params_s, preds_s), ...]`` in topological
        order. ``fn_s(params_s, *xs) -> y`` (single tensor out);
        ``preds_s`` is a tuple of earlier stage indices whose outputs are
        ``xs`` in order, or ``()`` for a root consuming the global input.
        Another rank's stage may give meta tensors as parameters.
      sample_mb: one example micro-batch (a tensor, a meta tensor or a
        ``(shape, dtype)`` pair) — every root's input.
      comm: the stage communicator (JAX's ``axis_name``); its size must
        equal ``len(stage_defs)`` when a step runs.
      wire_dtype / int_bound: as in HeteroPipeline (the same exact-int
        constraint applies to integer edges riding a float wire).
    """

    def __init__(self, stage_defs: Sequence[Tuple[Callable, Any, Tuple]],
                 sample_mb, comm, wire_dtype=None,
                 int_bound: int = 2 ** 24):
        self.comm = comm
        self.fns = [f for f, _, _ in stage_defs]
        self.params = [p for _, p, _ in stage_defs]
        self.preds: List[Tuple[int, ...]] = [
            tuple(int(i) for i in pr) for _, _, pr in stage_defs]
        self.S = len(stage_defs)
        if self.S < 2:
            raise ValueError("a pipeline needs at least 2 stages")
        for s, pr in enumerate(self.preds):
            for p in pr:
                if not 0 <= p < s:
                    raise ValueError(
                        f"stage {s} consumes stage {p}: predecessors must "
                        "be earlier stages (topological order)")

        consumed = {p for pr in self.preds for p in pr}
        sinks = [s for s in range(self.S) if s not in consumed]
        if len(sinks) != 1:
            raise ValueError(
                f"the DAG must have exactly one output stage (the loss "
                f"consumer); found sinks {sinks}")
        self.head = sinks[0]

        # depth = longest path from a root; same-depth stages overlap
        self.depth = [0] * self.S
        for s in range(self.S):
            if self.preds[s]:
                self.depth[s] = 1 + max(self.depth[p]
                                        for p in self.preds[s])
        if self.depth[self.head] != max(self.depth):
            raise ValueError(
                "the output stage must be the deepest (every stage "
                "must feed it)")
        self.slacks = [
            tuple(self.depth[s] - self.depth[p] for p in self.preds[s])
            for s in range(self.S)
        ]
        # each stage's consumers: (consumer, its input slot)
        self.succs: List[List[Tuple[int, int]]] = [[] for _ in
                                                   range(self.S)]
        for b in range(self.S):
            for k, p in enumerate(self.preds[b]):
                self.succs[p].append((b, k))

        # ---- activation avals via an abstract DAG walk ----------------
        sample = wire_aval(sample_mb)
        self.out_avals: List[torch.Tensor] = []
        for s in range(self.S):
            ins = ([sample] if not self.preds[s]
                   else [self.out_avals[p] for p in self.preds[s]])
            out = eval_shape(self.fns[s], self.params[s], *ins)
            if not isinstance(out, torch.Tensor):
                raise ValueError(
                    "each stage must return a single array; stage "
                    f"{s} returned {type(out).__name__}")
            self.out_avals.append(out)
        self.in_avals = [
            tuple([sample] if not self.preds[s]
                  else [self.out_avals[p] for p in self.preds[s]])
            for s in range(self.S)
        ]
        self.sample_aval = sample

        # wire sized by TRAVELING values: every non-head stage's output,
        # plus the root feed (the head's output dies in the loss phase)
        ring_avals = [sample] + [self.out_avals[s] for s in range(self.S)
                                 if s != self.head]
        self.wire_elems = max(_numel(a) for a in ring_avals)
        self.wire_dtype = _wire_dtype(ring_avals, wire_dtype)
        _check_wire(ring_avals, self.wire_dtype, int_bound)

        # ---- flat param layout (identical to HeteroPipeline) ----------
        self._layout = _ParamLayout(self.params)
        self.param_elems = self._layout.param_elems

    # ---- the per-rank pieces ------------------------------------------

    def _check_comm(self):
        n = self.comm.size
        if n != self.S:
            raise ValueError(
                f"BranchingPipeline has {self.S} stages but the stage "
                f"communicator spans {n} ranks")

    def stage_apply(self, s: int, flat_params, wires):
        """Stage ``s``'s forward on its input wires (the feed for a
        root), encoded for the wire."""
        xs = [self.decode_act(w, a) for w, a in zip(wires,
                                                     self.in_avals[s])]
        return self.encode_act(self.fns[s](self._unflatten(s, flat_params),
                                           *xs))

    def head_apply(self, flat_params, inbox):
        """Head forward from its flat param row on its stacked inbox
        (``[K_head, W]``, or a list of its input wires)."""
        xs = [self.decode_act(inbox[k], self.in_avals[self.head][k])
              for k in range(len(self.preds[self.head]))]
        return self.fns[self.head](
            self._unflatten(self.head, flat_params), *xs)

    def _forward_ticks(self, flat, x_wire, keep):
        """The scheduled forward on this rank. Returns ``{mu: (input
        wires, output wire)}``: the inputs always (the head's are its
        inbox), the output where ``keep`` asked for the forward's graph
        (``flat`` then requires grad)."""
        s, m = self.comm.rank, x_wire.shape[0]
        ticks = self.depth[self.head] + m
        inbox: Dict = {}
        saved: Dict[int, Any] = {}
        loop: Dict = {}
        for t in range(ticks):
            mu = t - self.depth[s]
            sends = []
            if 0 <= mu < m:
                if not self.preds[s]:
                    ins = [x_wire[mu]]
                else:
                    ins = [inbox.pop((k, mu))
                           for k in range(len(self.preds[s]))]
                if s == self.head:
                    saved[mu] = (ins, None)
                else:
                    with torch.set_grad_enabled(keep):
                        if keep:
                            ins = [w.detach().requires_grad_(
                                w.is_floating_point() and bool(
                                    self.preds[s])) for w in ins]
                        y = self.stage_apply(s, flat, ins)
                    saved[mu] = (ins, y if keep else None)
                    sends = [(b, _fwd_tag(k), y.detach())
                             for b, k in self.succs[s]]
            # the messages each producer sends this rank this tick
            recvs, keys = [], []
            for k, p in enumerate(self.preds[s]):
                mp = t - self.depth[p]
                if 0 <= mp < m:
                    recvs.append((p, _fwd_tag(k)))
                    keys.append((k, mp))
            for key, w in zip(keys, _exchange(self.comm, sends, recvs,
                                              loop)):
                inbox[key] = w
        return saved


def _sum_into(acc: Dict, key, value):
    acc[key] = value if key not in acc else acc[key] + value


def branching_pipeline_value_and_grad(
    pipe: BranchingPipeline,
    loss_fn: Callable,
    packed_params,
    x_microbatches_wire,
    y_microbatches,
    remat: bool = True,
):
    """DAG-pipeline train step, on every rank of ``pipe.comm``.

    Args:
      pipe: the :class:`BranchingPipeline` (built once, the same on every
        rank).
      loss_fn: ``(head_output, target) -> scalar`` on DECODED outputs; no
        STAGE-rank collectives (it runs on the head's rank).
      packed_params: THIS rank's ``[P]`` flat stage parameters
        (``pipe.pack_params(comm.rank)``).
      x_microbatches_wire: ``[M, W]`` wire-encoded root inputs
        (``pipe.encode_inputs``), the same on every rank.
      y_microbatches: ``[M, ...]`` targets, the same on every rank.
      remat: re-run each tick's forward in the backward from its saved
        inputs (GPipe memory); False keeps every tick's graph.

    Returns ``(loss, flat_grads [P])`` — loss is the mean over
    micro-batches (the same on every rank), ``flat_grads`` THIS rank's
    row of its gradient (decode with ``pipe.unpack_grads(g, rank)``).
    """
    pipe._check_comm()
    comm, s = pipe.comm, pipe.comm.rank
    m = x_microbatches_wire.shape[0]
    flat = packed_params.detach().requires_grad_(True)
    saved = pipe._forward_ticks(flat, x_microbatches_wire, keep=not remat)
    grad = torch.zeros_like(packed_params)
    loss = torch.zeros((), dtype=torch.float32,
                       device=packed_params.device)
    gout: Dict[int, torch.Tensor] = {}     # this stage's output cotangent
    gin: Dict[int, List] = {}              # its inputs' cotangents
    if s == pipe.head:
        # the loss phase: the mean over micro-batches (each micro-batch's
        # cotangent is 1/M, the mean's)
        for mu in range(m):
            ins = [w.detach().requires_grad_(w.is_floating_point())
                   for w in saved[mu][0]]
            with torch.enable_grad():
                lj = loss_fn(pipe.head_apply(flat, ins), y_microbatches[mu])
                g = _grads(lj, [flat] + ins, torch.full_like(lj, 1.0 / m))
            loss = loss + lj.detach().float()
            grad = grad + g[0]
            gin[mu] = g[1:]
        loss = loss / m
    ticks = pipe.depth[pipe.head] + m
    loop: Dict = {}
    for t in reversed(range(ticks)):
        mu = t - pipe.depth[s]
        sends = []
        if 0 <= mu < m:
            if s != pipe.head:
                ins, y = saved.pop(mu)
                if y is None:     # remat: the tick's forward again
                    with torch.enable_grad():
                        ins = [w.detach().requires_grad_(
                            w.is_floating_point() and bool(pipe.preds[s]))
                            for w in ins]
                        y = pipe.stage_apply(s, flat, ins)
                targets = [flat] + [w for w in ins if w.requires_grad]
                g = _grads(y, targets, gout.pop(mu).to(y.dtype))
                grad = grad + g[0]
                gin[mu] = g[1:]
            cot = gin.pop(mu)
            sends = [(p, _bwd_tag(k), cot[k].to(pipe.wire_dtype))
                     for k, p in enumerate(pipe.preds[s])]
        # the cotangents each consumer sends this rank this tick
        recvs, keys = [], []
        for b, k in pipe.succs[s]:
            mb_ = t - pipe.depth[b]
            if 0 <= mb_ < m:
                recvs.append((b, _bwd_tag(k)))
                keys.append(mb_)
        for key, g_ in zip(keys, _exchange(comm, sends, recvs, loop)):
            _sum_into(gout, key, g_)
    loss = comm.bcast(loss.reshape(1), root=pipe.head)[0]
    return loss, grad


@torch.no_grad()
def branching_pipeline_apply(pipe: BranchingPipeline, packed_params,
                             x_microbatches_wire):
    """Forward pass over the DAG schedule, on every rank. Returns DECODED
    head outputs ``[M, *head_aval.shape]`` (the same on every rank)."""
    pipe._check_comm()
    comm = pipe.comm
    saved = pipe._forward_ticks(packed_params, x_microbatches_wire,
                                keep=False)
    final = pipe.out_avals[pipe.head]
    m = x_microbatches_wire.shape[0]
    if comm.rank == pipe.head:
        ys = torch.stack([pipe.head_apply(packed_params, saved[mu][0])
                          for mu in range(m)]).to(final.dtype)
    else:
        ys = torch.zeros((m,) + tuple(final.shape), dtype=final.dtype,
                         device=x_microbatches_wire.device)
    return comm.bcast(ys, root=pipe.head)
