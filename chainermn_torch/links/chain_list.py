"""MultiNodeChainList: model parallelism over ranks by a stage graph.

Counterpart of ``chainermn_tpu/links/chain_list.py`` (reference:
chainermn/links/multi_node_chain_list.py). Every rank declares the whole
graph in the same order, ``add_link(module, rank=, rank_in=, rank_out=)``
naming each stage's owner, as the JAX package does; each rank then keeps
and runs only the stages it owns, in declaration order, as the
reference's processes did. An edge to another rank is a differentiable
send on the owner and a receive on the destination
(:mod:`chainermn_torch.functions.eager_p2p`); bystanders skip it. The
output of each output stage (``rank_out=None``) reaches every rank, as
the JAX package's ``comm.bcast(y, root=owner)`` makes it replicated
(here as point-to-point messages from the owner).

Gradients: every rank computes the same loss from the replicated output
and runs backward on it. The owner of an output stage takes its own
output gradient as is, and the other ranks pass none back: summing the
ranks' copies would hand the owner N times the gradient of the one loss.
Every send a rank made is tied into its output (``pseudo_connect``), so
that rank's backward receives the gradient of each value it sent; each
receive hangs off an anchor that requires a gradient, so the receiving
rank's backward sends it. Each edge rides its own tag.

The JAX package's replicated-parameter budget guards its SPMD executor,
where every device holds every stage's parameters. Here each rank holds
only its own stages, so there is nothing for the budget to guard: the
constructor keeps the argument and checks nothing (ROADMAP.md queue 3).
The pipeline lowerings give each rank only its own stage's parameters
under a micro-batched schedule: ``to_hetero_pipeline`` (a linear chain,
1F1B) and ``to_branching_pipeline`` (a DAG), over the chain list's
communicator. They need every stage's activation shapes, so the chain
list keeps, for a stage this rank does not own, a copy of the declared
module on the meta device (shapes and dtypes only, no data, not
registered): the module the caller passed is left as it is and may be
freed.
"""

from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch import nn

from chainermn_torch.functions.eager_p2p import eager_send, recv_tree
from chainermn_torch.functions.point_to_point import anchor, pseudo_connect

__all__ = ["MultiNodeChainList"]

#: the chain list's edge channels: tag CHAIN_TAG + stage index
CHAIN_TAG = 1 << 20


def _as_tuple(x) -> Tuple[int, ...]:
    if x is None:
        return ()
    if isinstance(x, (list, tuple)):
        return tuple(int(v) for v in x)
    return (int(x),)


def _meta_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module`` whose parameters and buffers are meta tensors
    of the same shapes and dtypes (none of the data is copied)."""
    memo = {}
    for t in itertools.chain(module.parameters(), module.buffers()):
        m = t.detach().to("meta")
        memo[id(t)] = (nn.Parameter(m, t.requires_grad)
                       if isinstance(t, nn.Parameter) else m)
    return copy.deepcopy(module, memo)


@dataclass
class _Stage:
    module: Optional[nn.Module]      # None on ranks that do not own it
    rank: int                        # owner rank
    rank_in: Tuple[int, ...]         # () → consumes the global input
    rank_out: Tuple[int, ...]        # () → produces a model output
    shapes: Any = None               # the module, or its meta copy


class _Replicate(torch.autograd.Function):
    """The owner's value on every rank: point-to-point messages from the
    owner, whose headers tell the others its shape. Backward: the owner
    keeps its own output gradient (every rank holds the same loss), the
    others pass none."""

    @staticmethod
    def forward(ctx, comm, root, tag, y):
        me = comm.rank
        if me == root:
            sends = [(r, tag, y) for r in range(comm.size) if r != root]
            if sends:
                comm.exchange(sends=sends)
            return y.clone()
        return comm.exchange(recvs=[(root, tag)])[0]

    @staticmethod
    def backward(ctx, g):
        return None, None, None, g


class MultiNodeChainList(nn.Module):
    """Sub-modules placed on ranks, composed into one model.

    Usage (the same lines on every rank)::

        chain = MultiNodeChainList(comm)
        chain.add_link(Part0(), rank=0, rank_in=None, rank_out=1)
        chain.add_link(Part1(), rank=1, rank_in=0, rank_out=None)
        y = chain(x)            # every rank gets the output stage's y
        loss_fn(y).backward()   # every rank; gradients reach each stage

    Stage ``i`` owned by this rank is registered as ``stage{i}``, so
    ``chain.parameters()`` are this rank's stages' parameters.
    """

    def __init__(self, comm, replicated_param_budget_bytes: int = None):
        super().__init__()
        self.comm = comm
        self._stages: List[_Stage] = []
        # kept for the JAX package's signature; see the module docstring
        self.replicated_param_budget_bytes = replicated_param_budget_bytes

    def add_link(self, module, rank: Optional[int] = None,
                 rank_in=None, rank_out=None):
        if rank is None:
            raise ValueError(
                "every rank declares the whole graph: name the owning "
                "rank explicitly, add_link(m, rank=..., ...)")
        i = len(self._stages)
        mine = int(rank) == self.comm.rank
        if mine:
            self.add_module(f"stage{i}", module)
        self._stages.append(_Stage(module if mine else None, int(rank),
                                   _as_tuple(rank_in), _as_tuple(rank_out),
                                   module if mine else _meta_copy(module)))

    def _stage_inputs(self, st: _Stage, x, messages):
        if not st.rank_in:
            return (x,)
        inputs = []
        for src in st.rank_in:
            key = (src, st.rank)
            if key not in messages:
                raise ValueError(
                    f"stage on rank {st.rank} expects input from rank {src}, "
                    f"but no earlier stage sent to it — check rank_in/rank_out "
                    "wiring and declaration order")
            inputs.append(messages.pop(key))
        return tuple(inputs)

    def _check_wiring(self) -> None:
        """Walk the graph without data: a wiring error raises on every
        rank before any message is sent."""
        messages = {}
        for st in self._stages:
            self._stage_inputs(st, None, messages)
            for dst in st.rank_out:
                messages[(st.rank, dst)] = None
        if all(st.rank_out for st in self._stages):
            raise ValueError("no output stage (every stage has rank_out)")

    def forward(self, x):
        self._check_wiring()
        me = self.comm.rank
        messages = {}
        outputs, tokens = [], []
        for i, st in enumerate(self._stages):
            inputs = self._stage_inputs(st, x, messages)
            y = st.module(*inputs) if st.rank == me else None
            for dst in st.rank_out:
                key = (st.rank, dst)
                if st.rank == me and dst == me:
                    messages[key] = y
                elif st.rank == me:
                    tokens.append(eager_send(y, self.comm, dst,
                                             tag=CHAIN_TAG + i))
                    messages[key] = None
                elif dst == me:
                    messages[key] = recv_tree(self.comm, st.rank, anchor(),
                                              tag=CHAIN_TAG + i)
                else:
                    messages[key] = None
            if not st.rank_out:
                outputs.append(_Replicate.apply(self.comm, st.rank,
                                                CHAIN_TAG + i, y))
        if tokens:
            token = torch.stack([t.to(outputs[0].device) for t in tokens])
            outputs = [pseudo_connect(token, y) for y in outputs]
        return outputs[0] if len(outputs) == 1 else tuple(outputs)

    # ------------------------------------------------------------------

    def _check_linear(self):
        """The chain must be rank 0 → 1 → … → S-1 with no branching."""
        S = len(self._stages)
        for i, st in enumerate(self._stages):
            ok = (st.rank == i
                  and st.rank_in == (() if i == 0 else (i - 1,))
                  and st.rank_out == (() if i == S - 1 else (i + 1,)))
            if not ok:
                raise ValueError(
                    f"stage {i} (rank={st.rank}, rank_in={st.rank_in}, "
                    f"rank_out={st.rank_out}) breaks the linear chain "
                    "0→1→…→S-1; branching/reordered graphs run on the "
                    "SPMD apply() executor instead"
                )

    def _stage_params(self, params):
        """Each stage's parameter dict: ``params[i]`` where given, else
        this rank's own stages' parameters and the others' meta tensors
        (never read: the lowering runs them on meta)."""
        return [params[i] if params is not None and params[i] is not None
                else dict(st.shapes.named_parameters())
                for i, st in enumerate(self._stages)]

    def to_hetero_pipeline(self, params: Optional[Sequence[Any]] = None,
                           sample_mb=None, **pipe_kwargs):
        """Lower a LINEAR chain onto the 1F1B pipeline (memory scaling).

        Args:
          params: each stage's parameters (a dict of name → tensor, the
            module's ``named_parameters()``), or None for the stages' own:
            this rank's stage holds data, the others' are meta tensors.
          sample_mb: one micro-batch example (a tensor, a meta tensor or a
            ``(shape, dtype)`` pair) of the chain's input — a MICRO-batch:
            the 1F1B caller splits its global batch into ``[M, mb, ...]``.
          pipe_kwargs: forwarded to :class:`HeteroPipeline`
            (``wire_dtype``, ``int_bound``, ``head_in_loss``). By
            default (``head_in_loss=True``) the final stage and the
            caller's ``loss_fn`` run on the last rank only — so
            ``loss_fn`` must not contain collectives over these ranks;
            pass ``head_in_loss=False`` (the full-width wire format) if
            it does.

        Returns the :class:`~chainermn_torch.parallel.HeteroPipeline` over
        the chain list's communicator: ``pack_params(comm.rank)`` gives
        this rank's flat row and
        :func:`~chainermn_torch.parallel.hetero_pipeline_1f1b_value_and_grad`
        runs the training step. Each rank then holds ONLY its own stage's
        parameters.
        """
        from torch.func import functional_call

        from chainermn_torch.parallel import HeteroPipeline

        self._check_linear()

        def stage_fn(module):
            return lambda p, h: functional_call(module, p, (h,))

        stage_defs = [(stage_fn(st.shapes), p) for st, p in
                      zip(self._stages, self._stage_params(params))]
        return HeteroPipeline(stage_defs, sample_mb, self.comm,
                              **pipe_kwargs)

    def to_branching_pipeline(self, params: Optional[Sequence[Any]] = None,
                              sample_mb=None, **pipe_kwargs):
        """Lower a BRANCHING (DAG) chain graph onto the scheduled
        pipeline executor — a rank a stage, each holding only its own
        parameters — for the graphs ``to_hetero_pipeline`` rejects.

        Requirements (checked): stage ``i`` declared with ``rank=i``
        (rank ``i`` runs stage ``i``; relabel if needed — the declaration
        order is already topological because producers come first);
        exactly one output stage (``rank_out=()``) — its output feeds the
        caller's ``loss_fn``; a multi-input stage's module takes its
        inputs in ``rank_in`` order.

        Returns a :class:`~chainermn_torch.parallel.BranchingPipeline`
        over the chain list's communicator: ``pack_params(comm.rank)`` and
        :func:`~chainermn_torch.parallel.branching_pipeline_value_and_grad`
        on every rank (reference: branching MultiNodeChainList graphs,
        chainermn/links/multi_node_chain_list.py).
        """
        from torch.func import functional_call

        from chainermn_torch.parallel import BranchingPipeline

        for i, st in enumerate(self._stages):
            if st.rank != i:
                raise ValueError(
                    f"stage {i} declared rank {st.rank}: the pipeline "
                    "lowering places stage i on device i — relabel ranks "
                    "to the declaration order")
        rank_to_idx = {st.rank: i for i, st in enumerate(self._stages)}
        preds = [tuple(rank_to_idx[r] for r in st.rank_in)
                 for st in self._stages]

        def stage_fn(module):
            return lambda p, *xs: functional_call(module, p, xs)

        stage_defs = [
            (stage_fn(st.shapes), p, pr)
            for st, p, pr in zip(self._stages, self._stage_params(params),
                                 preds)
        ]
        return BranchingPipeline(stage_defs, sample_mb, self.comm,
                                 **pipe_kwargs)
