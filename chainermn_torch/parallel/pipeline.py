"""Micro-batched pipeline parallelism over the ranks of a communicator.

Counterpart of ``chainermn_tpu/parallel/pipeline.py``. Each rank of the
stage communicator (``comm.over_mesh(mesh, axes=("stage",))``, the
counterpart of JAX's ``stage`` mesh axis) is one process holding only its
own stage's parameters; stage ``s`` runs on rank ``s`` (interleaved:
logical stage ``v·S + d`` on rank ``d``).

JAX compiles each schedule into one SPMD loop over ticks in which every
device moves in lockstep: a ``ppermute`` per hop, the stage function run
on zero-filled buffers during bubble ticks and masked away, ``cond``
branches that build zeros, and ``match_vma`` casts so the loop carries
type-check. The port keeps the schedules, their tick tables, the
numbers they compute and JAX's names, argument order and return
contracts (the stage function's ``(params, h) -> h`` form, the
``head_params`` loss hook, ``input_grads``), and drops what exists only
for XLA's SPMD typing. A rank computes only on ticks its table marks
valid, and at the end of each tick makes one
:meth:`~chainermn_torch.comm.DistributedCommunicator.exchange` holding
the messages its neighbours' tables say will land: the forward
activation first, then the backward cotangent, on every rank. Both
sides read one static schedule, so sends and receives pair up inside the
tick, which NCCL (it matches no tags: a receiver takes one sender's
messages in send order) needs: at ``S = 2`` the next and the previous
rank are the same rank, and the interleaved ring wraps from stage
``S-1``'s chunk ``v`` to rank 0's chunk ``v+1``.

In-stage remat stays: a stage keeps only its input activation (a ring of
``2·(S−1)`` slots, or the interleaved schedule's depths), runs the
forward under ``torch.no_grad`` and, at backward time, re-runs it under
``torch.enable_grad`` and takes ``torch.autograd.grad`` for its
parameters and its input. So every stage runs its forward twice and its
backward once per micro-batch, as JAX's ``vjp`` does. Gradients
accumulate in order and are divided by ``M``; the loss, ``head_grads`` and
``input_grads`` come back equal on every stage rank (JAX's ``psum`` of
one owner's values is a broadcast from that owner here).

A stage's activation dtype comes from the stage itself, run on meta
tensors (the port's ``jax.eval_shape``; the communicator's all-reduce
and the flash wrapper pass meta tensors through, so a tensor-parallel
stage runs there too); a stage that changes the activation shape is
refused there, before any message. The stages share one structure (the
homogeneous contract), so every rank comes to the same verdict.

:func:`pipeline_apply` is the GPipe forward; it runs under
``torch.no_grad`` (JAX differentiates it by tracing the whole loop, a
multi-process port cannot): training goes through the 1F1B functions,
whose backward is scheduled.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple

import numpy as np
import torch

from chainermn_torch.comm.p2p import MAX_TAG

__all__ = ["pipeline_apply", "stack_stage_params",
           "pipeline_1f1b_value_and_grad", "InterleavedSchedule",
           "build_interleaved_schedule",
           "pipeline_interleaved_1f1b_value_and_grad"]

#: the pipelines' channels: activations forward, cotangents back (below
#: the ring attention's two at the top of the tag space); the branching
#: pipeline's slot k uses PIPE_TAG + 2 + 2k and PIPE_TAG + 3 + 2k
PIPE_TAG = 2 * MAX_TAG - 1024
_FWD, _BWD = PIPE_TAG, PIPE_TAG + 1


# ---------------------------------------------------------------------------
# pytrees: nested dicts (keys sorted, as jax.tree_util orders them), lists
# and tuples of tensors
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves``' order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure holding ``leaves`` (in :func:`tree_leaves`'
    order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            vals = [build(v) for v in node]
            if isinstance(node, list):
                return vals
            return (type(node)(*vals) if hasattr(node, "_fields")
                    else tuple(vals))
        return None if node is None else next(it)

    return build(tree)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of trees of its
    structure)."""
    cols = [tree_leaves(t) for t in (tree, *rest)]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*cols)])


# ---------------------------------------------------------------------------
# shapes: the stage run on meta tensors
# ---------------------------------------------------------------------------

def _meta(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("meta")
    return tree_map(lambda t: t.detach().to("meta"), x)


def eval_shape(fn, *args):
    """``fn(*args)`` on meta copies of ``args`` (tensors or pytrees of
    them): the output's shapes and dtypes, no data and no launch (the
    port's ``jax.eval_shape``)."""
    with torch.no_grad():
        return fn(*[_meta(a) for a in args])


def _stage_act_dtype(stage_fn, stage_params, mb_shape, in_dtype):
    """Activation dtype of one stage; rejects non-shape-preserving stages
    (the homogeneous-pipeline contract both schedules rely on)."""
    out = eval_shape(stage_fn, stage_params,
                     torch.empty(mb_shape, dtype=in_dtype, device="meta"))
    if tuple(out.shape) != tuple(mb_shape):
        raise ValueError(
            f"pipeline stages must preserve the activation shape "
            f"(homogeneous pipeline); stage maps {tuple(mb_shape)} -> "
            f"{tuple(out.shape)}"
        )
    return out.dtype


def stack_stage_params(params_list):
    """Stack per-stage param pytrees on a leading axis (rank ``s`` keeps
    row ``s``; the interleaved schedule's ``[V, S, ...]`` arrangement is
    a reshape of the ``[N, ...]`` stack)."""
    return tree_map(lambda *ls: torch.stack(ls), *params_list)


# ---------------------------------------------------------------------------
# the forward (GPipe)
# ---------------------------------------------------------------------------

def _exchange(comm, sends, recvs, loop):
    """One tick's messages: ``sends`` of ``(dest, tag, tensor)``,
    ``recvs`` of ``(src, tag)``. A message to this rank itself (one
    stage rank, or the interleaved ring's wrap at S = 1) stays local."""
    me = comm.rank
    for dest, tag, t in sends:
        if dest == me:
            loop[tag] = t
    out_sends = [s for s in sends if s[0] != me]
    out_recvs = [r for r in recvs if r[0] != me]
    got = iter(comm.exchange(sends=out_sends, recvs=out_recvs)
               if out_sends or out_recvs else [])
    return [loop.pop(tag) if src == me else next(got) for src, tag in recvs]


def _gpipe(stage_fn, stage_params, x_microbatches, comm, act_dtype):
    """The GPipe forward: S + M − 1 ticks, stage s on micro-batch t − s.
    Returns the last stage's outputs ``[M, mb, ...]`` on the last rank,
    None elsewhere."""
    n, my = comm.size, comm.rank
    m = x_microbatches.shape[0]
    outs, h_next, loop = [], None, {}
    for t in range(n + m - 1):
        j = t - my
        y = None
        if 0 <= j < m:
            h = h_next
            if my == 0:
                h = x_microbatches[j].to(act_dtype)
            y = stage_fn(stage_params, h)
            if my == n - 1:
                outs.append(y)
        sends = [(my + 1, _FWD, y)] if y is not None and my < n - 1 else []
        recvs = ([(my - 1, _FWD)] if my > 0 and 0 <= t + 1 - my < m
                 else [])
        got = _exchange(comm, sends, recvs, loop)
        h_next = got[0] if got else None
    return torch.stack(outs) if my == n - 1 else None


@torch.no_grad()
def pipeline_apply(stage_fn: Callable, stage_params: Any, x_microbatches,
                   comm):
    """Run the pipeline forward over the ranks of ``comm``.

    Args:
      stage_fn: ``(params, h) -> h`` — one stage's compute. All stages share
        this structure (homogeneous pipeline); per-stage behavior comes from
        each rank's ``stage_params``.
      stage_params: THIS rank's stage parameters (pytree).
      x_microbatches: [M, mb, ...] micro-batches, the same on every rank;
        stage 0 feeds them in, the last stage's outputs are collected.
      comm: the stage communicator (JAX's ``axis_name``).

    Returns stacked outputs [M, mb, ...] (the same on every rank).
    """
    n = comm.size
    mb_shape = tuple(x_microbatches.shape[1:])
    act_dtype = _stage_act_dtype(stage_fn, stage_params, mb_shape,
                                 x_microbatches.dtype)
    outs = _gpipe(stage_fn, stage_params, x_microbatches, comm, act_dtype)
    if n == 1:
        return outs
    if outs is None:
        outs = torch.zeros(x_microbatches.shape, dtype=act_dtype,
                           device=x_microbatches.device)
    return comm.bcast(outs, root=n - 1)


# ---------------------------------------------------------------------------
# the 1F1B schedules
# ---------------------------------------------------------------------------

class InterleavedSchedule(NamedTuple):
    """Static tick tables for the interleaved 1F1B schedule (all shapes
    [S, T], int32; invalid entries hold 0 with the valid flag 0)."""

    S: int
    V: int
    M: int
    T: int
    depth_act: int     # saved-activation ring-buffer depth per chunk
    depth_fin: int     # forward-inbox depth per chunk
    depth_bin: int     # backward-inbox depth per chunk
    f_valid: np.ndarray
    f_chunk: np.ndarray
    f_mb: np.ndarray
    b_valid: np.ndarray
    b_chunk: np.ndarray
    b_mb: np.ndarray
    fr_valid: np.ndarray   # forward-activation receive → inbox write
    fr_chunk: np.ndarray
    fr_mb: np.ndarray
    br_valid: np.ndarray   # backward-cotangent receive → inbox write
    br_chunk: np.ndarray
    br_mb: np.ndarray


def build_interleaved_schedule(S: int, V: int, M: int) -> InterleavedSchedule:
    """Event-simulate the interleaved (virtual-chunk) 1F1B schedule.

    Device ``d`` owns logical stages ``{v*S + d : v < V}`` (round-robin, the
    interleaved placement); every logical hop k→k+1 is a +1 ring transfer.
    Each synchronized tick a device runs at most ONE forward unit and ONE
    backward unit; transfers land one tick after the producer. Forward order
    is the virtual-micro-batch numbering (groups of S micro-batches per
    chunk, chunks cycled); backward mirrors it with chunks reversed; a
    device may run ahead of its backward stream by at most the interleaved
    warmup bound ``(S-d-1)*2 + (V-1)*S``. Greedy list-scheduling under
    those dependencies reproduces the classic 1F1B tick count exactly at
    V=1 (T = 2(S-1)+M) and keeps devices busy with other chunks during
    what a fused-stage pipeline would spend as bubble.

    All tables are static numpy (a copy of the JAX package's simulation:
    the same tables, ``T`` and depths); each rank reads its own row.
    """
    if M % S != 0:
        raise ValueError(
            f"interleaved schedule needs M % S == 0 (M={M}, S={S})")
    if V < 1:
        raise ValueError("V must be >= 1")
    N = S * V
    MV = M * V

    order_f = []
    order_b = []
    for q in range(MV):
        mb = (q // N) * S + (q % S)
        order_f.append(((q % N) // S, mb))
        order_b.append((V - 1 - (q % N) // S, mb))
    warm = [min((S - d - 1) * 2 + (V - 1) * S, MV) for d in range(S)]

    f_done: Dict = {}
    b_done: Dict = {}
    fi = [0] * S
    bi = [0] * S
    events = []  # (tick, device, op, chunk, mb)

    t = 0
    limit = 20 * (MV + N) + 64
    while any(b < MV for b in bi):
        if t >= limit:
            raise RuntimeError("interleaved schedule did not converge")
        staged = []
        for d in range(S):
            did_f = did_b = None
            if fi[d] < MV and fi[d] - bi[d] < warm[d] + 1:
                v, j = order_f[fi[d]]
                k = v * S + d
                if k == 0 or f_done.get((k - 1, j), limit) + 1 <= t:
                    did_f = (v, j)
            if bi[d] < MV:
                v, j = order_b[bi[d]]
                k = v * S + d
                if k == N - 1:
                    ft = f_done.get((k, j))
                    if (ft is not None and ft <= t) or did_f == (v, j):
                        did_b = (v, j)
                elif b_done.get((k + 1, j), limit) + 1 <= t:
                    did_b = (v, j)
            staged.append((did_f, did_b))
        for d, (did_f, did_b) in enumerate(staged):
            if did_f:
                v, j = did_f
                f_done[(v * S + d, j)] = t
                fi[d] += 1
                events.append((t, d, "F", v, j))
            if did_b:
                v, j = did_b
                b_done[(v * S + d, j)] = t
                bi[d] += 1
                events.append((t, d, "B", v, j))
        t += 1
    T = t

    def tab():
        return (np.zeros((S, T), np.int32), np.zeros((S, T), np.int32),
                np.zeros((S, T), np.int32))

    f_valid, f_chunk, f_mb = tab()
    b_valid, b_chunk, b_mb = tab()
    fr_valid, fr_chunk, fr_mb = tab()
    br_valid, br_chunk, br_mb = tab()

    for (tk, d, op, v, j) in events:
        if op == "F":
            f_valid[d, tk], f_chunk[d, tk], f_mb[d, tk] = 1, v, j
            k = v * S + d
            if k != N - 1 and tk + 1 < T:
                # output arrives at device (d+1)%S next tick; at the wrap
                # (d == S-1) the consumer is the next chunk on device 0
                rd = (d + 1) % S
                rv = v + 1 if d == S - 1 else v
                fr_valid[rd, tk + 1] = 1
                fr_chunk[rd, tk + 1] = rv
                fr_mb[rd, tk + 1] = j
        else:
            b_valid[d, tk], b_chunk[d, tk], b_mb[d, tk] = 1, v, j
            k = v * S + d
            if k != 0 and tk + 1 < T:
                rd = (d - 1) % S
                rv = v - 1 if d == 0 else v
                br_valid[rd, tk + 1] = 1
                br_chunk[rd, tk + 1] = rv
                br_mb[rd, tk + 1] = j

    def max_overlap(intervals):
        pts = []
        for (a, b) in intervals:
            pts.append((a, 1))
            pts.append((b + 1, -1))
        peak = cur = 0
        for _, delta in sorted(pts):
            cur += delta
            peak = max(peak, cur)
        return max(peak, 1)

    # ring-buffer depths from the simulated lifetimes (FIFO per chunk, so
    # mb % depth is collision-free at depth >= max overlap)
    acts, fins, bins_ = [], [], []
    for d in range(S):
        for v in range(V):
            k = v * S + d
            acts.append(max_overlap(
                [(f_done[(k, j)], b_done[(k, j)]) for j in range(M)]))
            if k != 0:
                fins.append(max_overlap(
                    [(f_done[(k - 1, j)] + 1, f_done[(k, j)])
                     for j in range(M)]))
            bins_.append(max_overlap(
                [((f_done[(k, j)] if k == N - 1
                   else b_done[(k + 1, j)] + 1), b_done[(k, j)])
                 for j in range(M)]))
    return InterleavedSchedule(
        S=S, V=V, M=M, T=T,
        depth_act=max(acts), depth_fin=max(fins or [1]),
        depth_bin=max(bins_),
        f_valid=f_valid, f_chunk=f_chunk, f_mb=f_mb,
        b_valid=b_valid, b_chunk=b_chunk, b_mb=b_mb,
        fr_valid=fr_valid, fr_chunk=fr_chunk, fr_mb=fr_mb,
        br_valid=br_valid, br_chunk=br_chunk, br_mb=br_mb,
    )


def _plain_schedule(S: int, M: int) -> InterleavedSchedule:
    """The classic 1F1B's tables in the interleaved form (V = 1): T =
    2·(S−1) + M ticks, stage s forward on micro-batch t − s and backward
    on t − (2·(S−1) − s); an arrival is consumed the tick it lands, and
    the saved activations ring over 2·(S−1) slots."""
    T = 2 * (S - 1) + M
    t = np.arange(T)[None, :]
    s = np.arange(S)[:, None]
    mb_f, mb_b = t - s, t - (2 * (S - 1) - s)
    f_valid = ((mb_f >= 0) & (mb_f < M)).astype(np.int32)
    b_valid = ((mb_b >= 0) & (mb_b < M)).astype(np.int32)
    zero = np.zeros((S, T), np.int32)
    mb_f = np.where(f_valid == 1, mb_f, 0).astype(np.int32)
    mb_b = np.where(b_valid == 1, mb_b, 0).astype(np.int32)
    return InterleavedSchedule(
        S=S, V=1, M=M, T=T, depth_act=max(1, 2 * (S - 1)), depth_fin=1,
        depth_bin=1, f_valid=f_valid, f_chunk=zero, f_mb=mb_f,
        b_valid=b_valid, b_chunk=zero, b_mb=mb_b,
        fr_valid=f_valid * (s > 0), fr_chunk=zero, fr_mb=mb_f,
        br_valid=b_valid * (s < S - 1), br_chunk=zero, br_mb=mb_b)


class _Ring:
    """Per-chunk ring buffers of ``depth`` slots, micro-batch ``j`` in
    slot ``j % depth``; a write to a live slot or a read of an empty one
    raises (the schedule's depths make neither happen)."""

    def __init__(self, n_chunks: int, depth: int, what: str):
        self.depth, self.what = depth, what
        self.slots = [[None] * depth for _ in range(n_chunks)]

    def put(self, chunk: int, mb: int, value) -> None:
        row = self.slots[chunk]
        if row[mb % self.depth] is not None:
            raise RuntimeError(f"{self.what} slot {mb % self.depth} of "
                               f"chunk {chunk} still holds micro-batch "
                               f"{row[mb % self.depth][0]}")
        row[mb % self.depth] = (mb, value)

    def pop(self, chunk: int, mb: int):
        row = self.slots[chunk]
        got = row[mb % self.depth]
        if got is None or got[0] != mb:
            raise RuntimeError(f"{self.what} of chunk {chunk} has no "
                               f"micro-batch {mb}")
        row[mb % self.depth] = None
        return got[1]


def _req(leaves):
    """Leaves that autograd differentiates: detached, requiring grad."""
    return [t.detach().requires_grad_(True) for t in leaves]


def _grads(out, inputs, cotangent):
    """``d out / d inputs`` against ``cotangent`` (zeros for an input the
    output does not depend on)."""
    if not out.requires_grad:
        return [torch.zeros_like(x) for x in inputs]
    got = torch.autograd.grad(out, inputs, grad_outputs=cotangent,
                              allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(inputs, got)]


def _head_loss_grads(loss_fn, head_tree, head_leaves, y, tgt):
    """The last logical stage's loss and cotangents: ``(loss (f32),
    d loss / d y, d loss / d head_params)``. ``loss_fn(head, out, tgt)``
    (or ``loss_fn(out, tgt)`` without a head) may hold collectives over
    ranks orthogonal to the stage ranks (a vocabulary-parallel head): the
    whole model column of the last stage runs it on the same ticks."""
    with torch.enable_grad():
        yv = y.detach().requires_grad_(True)
        if head_tree is None:
            lj = loss_fn(yv, tgt)
            hl = []
        else:
            hl = _req(head_leaves)
            lj = loss_fn(tree_unflatten(head_tree, hl), yv, tgt)
        g = _grads(lj, [yv] + hl, torch.ones_like(lj))
    return lj.detach().float(), g[0], g[1:]


def _run_1f1b(stage_fn, loss_fn, chunk_params, x_microbatches,
              y_microbatches, comm, sched: InterleavedSchedule, act_dtype,
              head_params, return_input_grads, replicate_head=True):
    """Run one rank's row of a 1F1B schedule. ``chunk_params[v]`` is
    chunk v's parameter pytree. Returns ``(loss (replicated), [chunk
    grads], head grads or None, input grads or None)``; the head grads
    are replicated with ``replicate_head`` and this rank's own (zeros
    off the last rank) without."""
    S, V, my = sched.S, sched.V, comm.rank
    if comm.size != S:
        raise ValueError(f"the schedule has {S} stages, the communicator "
                         f"{comm.size} ranks")
    N = S * V
    m = x_microbatches.shape[0]
    mb_shape = tuple(x_microbatches.shape[1:])
    dev = x_microbatches.device
    row = {k: getattr(sched, k)[my].tolist() for k in (
        "f_valid", "f_chunk", "f_mb", "b_valid", "b_chunk", "b_mb",
        "fr_valid", "fr_chunk", "fr_mb", "br_valid", "br_chunk", "br_mb")}
    trees = chunk_params
    leaves = [_req(tree_leaves(p)) for p in trees]
    gacc = [[torch.zeros_like(t) for t in ls] for ls in leaves]
    head_tree = head_params
    head_leaves = tree_leaves(head_params) if head_params is not None else []
    hacc = [torch.zeros_like(t) for t in head_leaves]
    lacc = torch.zeros((), dtype=torch.float32, device=dev)
    dxs = (torch.zeros((m,) + mb_shape, dtype=torch.float32, device=dev)
           if return_input_grads else None)
    act = _Ring(V, sched.depth_act, "saved activation")
    fin = _Ring(V, sched.depth_fin, "forward inbox")
    bin_ = _Ring(V, sched.depth_bin, "backward inbox")
    loop: Dict = {}

    for t in range(sched.T):
        fv, fc, fm = row["f_valid"][t], row["f_chunk"][t], row["f_mb"][t]
        bv, bc, bm = row["b_valid"][t], row["b_chunk"][t], row["b_mb"][t]
        k_f, k_b = fc * S + my, bc * S + my
        same = bool(bv and fv and k_b == N - 1 and k_f == N - 1
                    and bm == fm)
        # read the backward's activation before this tick's forward
        # writes: the slot being retired may be the one about to be reused
        h_b = act.pop(bc, bm) if bv and not same else None
        y = None
        if fv:
            h_in = (x_microbatches[fm].to(act_dtype) if k_f == 0
                    else fin.pop(fc, fm))
            with torch.no_grad():
                y = stage_fn(trees[fc], h_in)
            if same:
                h_b = h_in
            else:
                act.put(fc, fm, h_in)
            if k_f == N - 1:
                lj, dldy, dhp = _head_loss_grads(
                    loss_fn, head_tree, head_leaves, y, y_microbatches[fm])
                lacc = lacc + lj
                hacc = [a + g for a, g in zip(hacc, dhp)]
                # the last logical stage's cotangent is produced locally
                bin_.put(V - 1, fm, dldy.to(act_dtype))
        gh = None
        if bv:
            g_in = bin_.pop(bc, bm)
            need_x = (k_b != 0 or return_input_grads) and (
                h_b.is_floating_point())
            with torch.enable_grad():
                hv = h_b.detach().requires_grad_(need_x)
                out = stage_fn(tree_unflatten(trees[bc], leaves[bc]), hv)
                g = _grads(out, leaves[bc] + ([hv] if need_x else []),
                           g_in.to(out.dtype))
            gacc[bc] = [a + d for a, d in zip(gacc[bc], g)]
            gh = g[-1] if need_x else None
            if k_b == 0 and return_input_grads:
                dxs[bm] = gh.float()
        # this tick's transfers: the forward activation, then the backward
        # cotangent, on every rank (see the module docstring)
        sends, recvs, slots = [], [], []
        if fv and k_f != N - 1:
            sends.append(((my + 1) % S, _FWD, y))
        if bv and k_b != 0:
            sends.append(((my - 1) % S, _BWD, gh.to(act_dtype)))
        if t + 1 < sched.T:
            if row["fr_valid"][t + 1]:
                recvs.append(((my - 1) % S, _FWD))
                slots.append((fin, row["fr_chunk"][t + 1],
                              row["fr_mb"][t + 1]))
            if row["br_valid"][t + 1]:
                recvs.append(((my + 1) % S, _BWD))
                slots.append((bin_, row["br_chunk"][t + 1],
                              row["br_mb"][t + 1]))
        for (ring, c, j), val in zip(slots, _exchange(comm, sends, recvs,
                                                      loop)):
            ring.put(c, j, val)

    # JAX's psum of one owner's values: a broadcast from the owner (the
    # last logical stage lives on rank S-1, the first on rank 0)
    vec = lacc.reshape(1)
    if replicate_head and hacc:
        vec = torch.cat([vec] + [h.float().reshape(-1) for h in hacc])
    if S > 1:
        vec = comm.bcast(vec, root=S - 1)
        if dxs is not None:
            dxs = comm.bcast(dxs, root=0)
    loss = vec[0] / m
    head_grads = None
    if head_params is not None:
        if replicate_head:
            parts, at = [], 1
            for h in hacc:
                parts.append(vec[at:at + h.numel()].reshape(h.shape)
                             .to(h.dtype))
                at += h.numel()
            hacc = parts
        head_grads = tree_unflatten(head_params, [h / m for h in hacc])
    input_grads = (dxs / m).to(x_microbatches.dtype) if dxs is not None \
        else None
    grads = [tree_unflatten(trees[v], [g / m for g in gacc[v]])
             for v in range(V)]
    return loss, grads, head_grads, input_grads


def _returns(loss, grads, head_grads, input_grads, head_params,
             return_input_grads):
    if head_params is None and not return_input_grads:
        return loss, grads
    aux = {}
    if head_params is not None:
        aux["head_grads"] = head_grads
    if return_input_grads:
        aux["input_grads"] = input_grads
    return loss, grads, aux


def pipeline_1f1b_value_and_grad(
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params: Any,
    x_microbatches,
    y_microbatches,
    comm,
    head_params: Any = None,
    return_input_grads: bool = False,
):
    """1F1B-scheduled pipeline training step (loss + per-stage grads).

    The one-forward-one-backward schedule: backward for micro-batch j
    starts as soon as j leaves the last stage, so stage s only keeps
    activations for its in-flight window — a ring of 2·(S−1) slots,
    independent of M. The backward cotangent travels one tick behind
    schedule, and each stage re-runs its forward at backward time
    (in-stage remat).

    Schedule (S stages, M micro-batches, T = 2·(S−1)+M ticks): stage s runs
    forward for micro-batch t−s and backward for micro-batch
    t−(2·(S−1)−s) when those indices are in [0, M). The last stage's forward
    and backward for a micro-batch land on the same tick, where the loss
    cotangent is computed locally from ``loss_fn``. With S = 1 it is plain
    gradient accumulation, with no exchange.

    Args:
      stage_fn: ``(params, h) -> h`` — one stage's compute, shape-preserving
        (homogeneous pipeline, as ``pipeline_apply``).
      loss_fn: ``(out, target) -> scalar`` — applied to the last stage's
        output per micro-batch; the objective is its mean over micro-batches.
      stage_params: THIS rank's stage parameters.
      x_microbatches: [M, mb, ...] inputs, the same on every rank.
      y_microbatches: [M, ...] per-micro-batch targets, the same on every
        rank.
      comm: the stage communicator (JAX's ``axis_name``).
      head_params / return_input_grads: the same composition hooks as
        :func:`pipeline_interleaved_1f1b_value_and_grad` — a loss-side
        trainable pytree (``loss_fn(head_params, out, tgt)``; no
        collectives over the STAGE ranks, but collectives over orthogonal
        ranks are supported — e.g. a column-parallel head with
        vocab-parallel cross-entropy) and the stage-0 input cotangents.

    Returns ``(loss, grads)``, plus an ``aux`` dict (``head_grads``,
    ``input_grads``) when either hook is set: the mean loss (the same on
    every rank) and the gradient of it w.r.t. THIS rank's
    ``stage_params``.
    """
    S = comm.size
    mb_shape = tuple(x_microbatches.shape[1:])
    act_dtype = _stage_act_dtype(stage_fn, stage_params, mb_shape,
                                 x_microbatches.dtype)
    loss, grads, hg, ig = _run_1f1b(
        stage_fn, loss_fn, [stage_params], x_microbatches, y_microbatches,
        comm, _plain_schedule(S, x_microbatches.shape[0]), act_dtype,
        head_params, return_input_grads)
    return _returns(loss, grads[0], hg, ig, head_params, return_input_grads)


def pipeline_interleaved_1f1b_value_and_grad(
    stage_fn: Callable,
    loss_fn: Callable,
    stage_params: Any,
    x_microbatches,
    y_microbatches,
    comm,
    n_chunks: int,
    head_params: Any = None,
    return_input_grads: bool = False,
):
    """Interleaved-1F1B pipeline training step (virtual stages).

    Each rank owns ``n_chunks`` (V) non-adjacent pipeline stages —
    logical stage ``v*S + d`` lives on rank ``d`` — so during a plain
    pipeline's fill/drain bubble a rank works on its other chunks. Per
    tick a rank runs at most one sub-stage forward and one backward
    (in-stage remat, like :func:`pipeline_1f1b_value_and_grad`); the
    schedule is the static tick table from
    :func:`build_interleaved_schedule`. Activation cost: three ring
    buffers per chunk (saved activations + two transfer inboxes) sized by
    the schedule's in-flight maxima — deeper than non-interleaved 1F1B's
    2(S−1), the known memory-for-bubble trade of interleaving.

    Args:
      stage_fn: ``(params, h) -> h`` — ONE sub-stage's compute
        (shape-preserving, homogeneous pipeline).
      loss_fn: ``(out, target) -> scalar`` per micro-batch.
      stage_params: THIS rank's chunk parameters, each leaf stacked on a
        leading ``V`` axis (rank d holds rows ``v*S+d`` of the global
        [N, ...] logical-stage stack arranged as ``[V, S, ...]``).
      x_microbatches: [M, mb, ...] inputs, the same on every rank
        (M % S == 0).
      y_microbatches: [M, ...] targets, the same on every rank.
      comm: the stage communicator (JAX's ``axis_name``).
      n_chunks: V, virtual stages per rank.
      head_params: optional pytree of loss-side trainable parameters (an
        LM head / classifier). When given, ``loss_fn`` is called as
        ``loss_fn(head_params, out, target)`` and their gradient is
        returned — the head runs on the last logical stage's rank and its
        grads come back on every rank.
      return_input_grads: also return d(loss)/d(x_microbatches) — the
        cotangents leaving logical stage 0 — so the caller can backprop
        into whatever produced the inputs (an embedding). Composition
        contract: embed outside → pipeline → head inside ``loss_fn``.

    Returns ``(loss, grads)``, or ``(loss, grads, aux)`` when
    ``head_params``/``return_input_grads`` is set, with
    ``aux['head_grads']`` and/or ``aux['input_grads']`` ([M, mb, ...]),
    both the same on every rank. ``loss`` is the micro-batch mean (the same
    on every rank); ``grads`` is w.r.t. THIS rank's ``stage_params``
    (same [V, ...] stacking).
    """
    S, V = comm.size, n_chunks
    mb_shape = tuple(x_microbatches.shape[1:])
    chunks = [tree_map(lambda p, v=v: p[v], stage_params) for v in range(V)]
    act_dtype = _stage_act_dtype(stage_fn, chunks[0], mb_shape,
                                 x_microbatches.dtype)
    sched = build_interleaved_schedule(S, V, x_microbatches.shape[0])
    loss, grads, hg, ig = _run_1f1b(
        stage_fn, loss_fn, chunks, x_microbatches, y_microbatches, comm,
        sched, act_dtype, head_params, return_input_grads)
    return _returns(loss, stack_stage_params(grads), hg, ig, head_params,
                    return_input_grads)


def schedule_idle_share(sched: InterleavedSchedule) -> float:
    """The share of a schedule's tick slots (one forward and one backward
    unit per rank and tick) that hold no work: its bubble."""
    busy = int(sched.f_valid.sum()) + int(sched.b_valid.sum())
    return 1.0 - busy / (2.0 * sched.S * sched.T)
