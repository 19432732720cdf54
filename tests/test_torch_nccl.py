"""Card-only test of the NCCL point-to-point route: four NCCL ranks, one
GPU each (NCCL refuses two ranks on one GPU, so one card cannot run it;
without four GPUs it skips).

This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_nccl.py

Each rank of a 4-rank world checks, on its own GPU: array ``send``/
``recv`` of a structure; that a receive taken out of send order raises
(NCCL matches no tags) and the in-order one then returns its own data;
the array collectives; a two-way ``transfer`` and an eager send with
their gradients; ``MultiNodeChainList`` (a linear and a branching graph)
against the unsplit model built on the same rank from the same seed.
Transfers are exact; the chain list at 1e-5 (the same f32 products on
another GPU of the same kind).

A second 4-rank world checks the sub-communicators and the reducers over
NCCL subgroups: ``split`` in block and stride form, the communicators
over a ``DeviceMesh`` ``("dcn", "ici")`` = (2, 2) and its axes, the
hierarchical reducer in both modes (``intra=2`` on the world; the mesh's
axes) bitwise against ``flat`` on integer-valued floats, and two steps of
``int8-block`` with error feedback against the same arithmetic done on
each rank from every rank's gradient and residual (bitwise: the same
scales and int32 code sums; the residual exactly input − local
dequantization).

A third 4-rank world takes the first training steps across cards: a small
f32 TransformerLM (vocab 256, d_model 64, 2 layers, seq 64, on the flash
kernels, ``lm_loss_with_aux``, SGD 0.1 with momentum 0.9) trains 2 steps,
each rank on its own batch of 2, through ``make_data_parallel_train_step``
with each reducer (flat, hierarchical with ``intra=2``, auto, and
quantized int8-block with error feedback) and through ZeRO-1 and ZeRO-2
(``n_microbatches=2``), flat and bucketed (16 KiB), and through FSDP
(the model's parameters sharded; with SGD and with LAMB, whose trust
ratios take the whole leaves' norms) and FSDP over the scanned stack
(``make_lm_fsdp_scan_loss``: the fused CE kernels, each block recomputed
in the backward); each is held against the same model on the same rank
fed all four batches at once (the mean loss of the concatenated batch,
whose gradient is the ranks' mean; LAMB against LAMB, where one
parameter in a thousand may differ by up to 2 lr a step: LAMB's
update, like Adam's, moves a weight whose gradient sits at the sums'
noise by about lr with whichever sign the last bits give). The
unquantized runs: losses at rtol 1e-5 and parameters at rtol 1e-4, atol
1e-6 (the same f32 sums in another order and on another card). The
int8-block run: the first loss at rtol 1e-5 (no update has happened yet)
and the first update within lr · mean_r max|g_r| / 254 of the reference's
an element (rank r's code rounds by at most half a step of its block's
scale, which is at most max|g_r| / 127, and the reduced gradient is the
mean of the four ranks'). ``WORLD_DEVICE=cpu`` runs the same world on gloo
(a check before the card).

A fourth 4-rank world runs the TransformerLM's intra-layer parallelism
over NCCL at a small width (vocab 256, d_model 64, 2 layers, seq 64, f32,
TF32 off): ring_flash and Ulysses attention with the sequence split over
the cards, Megatron TP with ``lm_head_tp`` and ``tp_lm_loss``, and the
expert-parallel step (8 experts, top-2), each held on every rank to one
rank (``PARALLEL_WORKER``; ``WORLD_DEVICE=cpu`` too).
"""

import pytest
import torch

from tests.test_torch_mp import assert_ranks_ok, run_world

pytestmark = pytest.mark.cuda

_WORKER = r'''
import torch
import torch.distributed as dist
from torch import nn
from chainermn_torch import functions as F
from chainermn_torch.comm import create_communicator
from chainermn_torch.links import MultiNodeChainList

comm = create_communicator("pure_nccl")
r, dev = comm.rank, comm.device
assert dev.index == r and comm.name == "pure_nccl"
g = torch.Generator().manual_seed(0)
xs = [torch.randn(4, 3, generator=g) for _ in range(4)]


def same(a, b):
    return torch.equal(a.cpu(), b.cpu())


# a structure, and two tags received in send order
if r == 0:
    comm.send({"a": xs[0].to(dev), "i": torch.arange(5, device=dev)}, 1,
              tag=0)
    comm.send(xs[1].to(dev), 1, tag=1)
elif r == 1:
    a = comm.recv(0, tag=0)
    b = comm.recv(0, tag=1)
    assert same(a["a"], xs[0]) and same(a["i"], torch.arange(5))
    assert same(b, xs[1]) and b.device == dev

# a receive out of send order raises; the in-order one gets its own data
if r == 2:
    comm.send(xs[2].to(dev), 3, tag=0)
    comm.send(xs[3][:2].to(dev), 3, tag=1)
elif r == 3:
    try:
        comm.recv(2, tag=1)
        raise AssertionError("an out-of-order NCCL receive returned")
    except RuntimeError as e:
        assert "out-of-order receive" in str(e), e
    assert same(comm.recv(2, tag=0), xs[2])
    # the refused message's payload is still on the wire: take it, and
    # count its header as received
    buf = torch.empty(2, 3, device=dev)
    for w in dist.batch_isend_irecv([dist.P2POp(dist.irecv, buf, 2)]):
        w.wait()
    assert same(buf, xs[3][:2])
    comm._channels._received[2] += 1

# the array collectives
mine = xs[r].to(dev)
assert same(comm.allgather(mine), torch.stack(xs))
assert same(comm.bcast(mine, root=2), xs[2])
assert same(comm.alltoall(mine), torch.stack([x[r] for x in xs]))
got = comm.gather(mine, root=1)
assert (got is None) == (r != 1) and (got is None or same(got, torch.stack(xs)))
assert same(comm.scatter(torch.stack(xs).to(dev) if r == 0 else None, 0),
            xs[r])

# a two-way transfer and its gradient
x = xs[r].to(dev, copy=True).requires_grad_()
y = F.transfer(x, comm, [(0, 1), (1, 0)])
(y * (r + 1)).sum().backward()
want_y = {0: xs[1], 1: xs[0]}.get(r, torch.zeros(4, 3))
want_g = {0: 2.0, 1: 1.0}.get(r, 0.0) * torch.ones(4, 3)
assert same(y.detach(), want_y) and same(x.grad, want_g)

# an eager send, 0 -> 2, and the gradient back
w = (xs[r] + 1).to(dev, copy=True).requires_grad_()
if r == 0:
    F.eager_send(w * 3.0, comm, 2).backward()
    assert torch.allclose(w.grad.cpu(), 3.0 * (xs[2] + 1))
elif r == 2:
    h = F.eager_recv(comm, 0, shape=(4, 3), dtype=torch.float32, anchor=w)
    (h * w).sum().backward()
    assert same(h.detach(), 3.0 * (xs[0] + 1))

# the chain list against the unsplit model
for graph in ("linear", "branching"):
    torch.manual_seed(0)
    if graph == "linear":
        mods = [nn.Linear(3, 8), nn.Linear(8, 8), nn.Linear(8, 8),
                nn.Linear(8, 5)]
        wiring = [(None, 1), (0, 2), (1, 3), (2, None)]
    else:
        mods = [nn.Linear(3, 8), nn.Linear(8, 6), nn.Linear(8, 6),
                nn.Linear(12, 5)]
        wiring = [(None, [1, 2]), (0, 3), (0, 3), ([1, 2], None)]
    ref = [nn.Linear(m.in_features, m.out_features) for m in mods]
    for a, b in zip(ref, mods):
        a.load_state_dict(b.state_dict())

    class Join(nn.Module):
        def __init__(self, lin):
            super().__init__()
            self.lin = lin

        def forward(self, a, b):
            return self.lin(torch.cat([a, b], -1))

    chain = MultiNodeChainList(comm)
    for s, (m, (rin, rout)) in enumerate(zip(mods, wiring)):
        if graph == "branching" and s == 3:
            m = Join(m)
        chain.add_link(m, rank=s, rank_in=rin, rank_out=rout)
    chain.to(dev)
    x = xs[0].to(dev)
    y = chain(x)
    c = torch.linspace(-1, 1, y.numel()).reshape(y.shape)
    (y * c.to(dev)).sum().backward()
    if graph == "linear":
        yr = x.cpu()
        for m in ref:
            yr = m(yr)
    else:
        h = ref[0](x.cpu())
        yr = ref[3](torch.cat([ref[1](h), ref[2](h)], -1))
    (yr * c).sum().backward()
    assert torch.allclose(y.detach().cpu(), yr.detach(), atol=1e-5,
                          rtol=1e-5), graph
    own = [p for p in chain.parameters()]
    assert len(own) == 2
    for p, q in zip(own, ref[r].parameters()):
        assert torch.allclose(p.grad.cpu(), q.grad, atol=1e-5,
                              rtol=1e-5), graph

comm.barrier()
comm.finalize()
print(f"RANK{r} OK", flush=True)
'''


def _four_cards():
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four GPUs: one NCCL rank each")


def test_nccl_point_to_point_across_four_cards():
    _four_cards()
    assert_ranks_ok(run_world(_WORKER, 4, timeout=240))


_REDUCER_WORKER = r"""
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import init_device_mesh
from chainermn_torch.collectives import (HierarchicalReducer,
                                         QuantizedReducer, make_grad_reducer)
from chainermn_torch.comm import create_communicator

comm = create_communicator("pure_nccl")
r, dev = comm.rank, comm.device
g = torch.Generator().manual_seed(0)
ints = [torch.randint(-8, 8, (4, 1001), generator=g).float()
        for _ in range(2)]
reals = [torch.randn(4, 1500, generator=g) * 10.0 ** (i - 2)
         for i in range(3)]


def mine(leaves):
    return [t[r].to(dev, copy=True) for t in leaves]


# split: block and stride groups, over NCCL subgroups
for form, colour in ((("block", 2), [0, 0, 1, 1]),
                     (("stride", 2), [0, 1, 0, 1])):
    sub = comm.split(form)
    assert sub.members == tuple(m for m in range(4)
                                if colour[m] == colour[r])
    x = torch.tensor([float(r)], device=dev)
    assert sub.allreduce(x).item() == sum(sub.members)
    assert sub.allgather(x).reshape(-1).tolist() == [
        float(m) for m in sub.members]
    sub.finalize()

# a DeviceMesh and its axes
mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("dcn", "ici"))
mc = create_communicator("pure_nccl", mesh=mesh)
ici = create_communicator("pure_nccl", mesh=mesh, axes=("ici",))
dcn = create_communicator("pure_nccl", mesh=mesh, axes=("dcn",))
assert mc.members == (0, 1, 2, 3) and mc.axis_names == ("dcn", "ici")
assert ici.members == (r // 2 * 2, r // 2 * 2 + 1)
assert dcn.members == (r % 2, r % 2 + 2)
assert ici.allreduce(torch.ones(1, device=dev)).item() == 2.0

# hierarchical (both modes) bitwise against flat on integer floats
flat = make_grad_reducer("flat", comm).reduce(mine(ints))[0]
for red in (HierarchicalReducer(comm, intra=2), HierarchicalReducer(mc)):
    assert (red.topology.intra, red.topology.inter) == (2, 2)
    got = red.reduce(mine(ints))[0]
    assert all(torch.equal(a, b) for a, b in zip(got, flat))
    assert all(torch.equal(a.cpu(), t.sum(0) / 4) for a, t in zip(got, ints))
    v = ints[0][:, :1000]
    tiles = red.reduce_scatter_flat(v[r].to(dev), 1)
    assert torch.equal(tiles.cpu(), v.sum(0).reshape(4, -1)[r])

# int8-block with error feedback, two steps, against the plain arithmetic
q = QuantizedReducer(comm, mode="int8-block", bucket_bytes=8192)
state = q.init(mine(reals))
for step in range(2):
    leaves = [t * (step + 1) for t in reals]
    every = comm.allgather_obj([e.cpu() for e in state])
    before = comm.collective_bytes
    got, state = q.reduce(mine(leaves), state)
    assert comm.collective_bytes - before == sum(
        row["wire_bytes"] for row in q.plan(mine(leaves)))
    for bi, (_, _, bucket) in enumerate(q._plan(mine(leaves))):
        v = torch.cat([leaves[i] for i in bucket], 1) + torch.stack(
            [e[bi] for e in every])
        n = v.shape[1]
        b = F.pad(v, (0, (-n) % 256)).reshape(4, -1, 256)
        amax = b.abs().amax(2).amax(0)
        scale = torch.where(amax > 0, amax * (1.0 / 127.0),
                            torch.ones_like(amax))
        codes = torch.clamp(torch.round(b / scale[None, :, None]), -127,
                            127).to(torch.int32)
        want = (codes.sum(0).float() * scale[:, None]).reshape(-1)[:n] / 4
        out = torch.cat([got[i].reshape(-1).cpu() for i in bucket])
        assert torch.equal(out, want), (step, bi)
        local = (codes[r].float() * scale[:, None]).reshape(-1)[:n]
        assert torch.equal(state[bi].cpu(), v[r] - local), (step, bi)

for c in (ici, dcn, mc):
    c.finalize()
comm.barrier()
comm.finalize()
print(f"RANK{r} OK", flush=True)
"""


def test_nccl_subgroups_and_reducers_across_four_cards():
    _four_cards()
    assert_ranks_ok(run_world(_REDUCER_WORKER, 4, timeout=240))


TRAIN_WORKER = r"""
import copy, os, sys
import torch
from chainermn_torch.collectives import HierarchicalReducer, make_grad_reducer
from chainermn_torch.comm import create_communicator
from chainermn_torch.models.transformer import TransformerLM, lm_loss_with_aux
from chainermn_torch.models.convert import flax_params, params_from_flax
from chainermn_torch.models.transformer import (make_lm_fsdp_scan_loss,
                                                stack_lm_blocks,
                                                unstack_lm_blocks)
from chainermn_torch.optimizers import (LAMB, create_multi_node_optimizer,
                                        fsdp_gather_params, fsdp_shardings,
                                        fsdp_stack_shardings,
                                        make_fsdp_train_step,
                                        make_zero1_train_step,
                                        make_zero2_train_step, zero1_params)
from chainermn_torch.training import make_data_parallel_train_step

DEV = os.environ.get("WORLD_DEVICE", "cuda")
comm = create_communicator("pure_nccl", device=DEV)
r, dev, n = comm.rank, comm.device, comm.size
LR, STEPS, B, L, V = 0.1, 2, 2, 64, 256
g = torch.Generator().manual_seed(1)
toks = torch.randint(0, V, (STEPS, n, B, L + 1), generator=g).to(dev)


def lm():
    torch.manual_seed(0)
    return TransformerLM(vocab=V, d_model=64, n_heads=4, n_layers=2,
                         d_ff=128, max_len=L, device=dev)


def sgd(params):
    return torch.optim.SGD(params, lr=LR, momentum=0.9)


# one rank fed every batch: the reference, on this rank alone
ref = lm()
ref_opt = sgd(ref.parameters())
ref_losses, ref_first = [], None
start = {k: v.detach().clone() for k, v in ref.named_parameters()}
# each rank's own first gradient: the scale of its int8 codes
gmax = 0.0
for k in range(n):
    ref.zero_grad()
    lm_loss_with_aux(ref, toks[0, k, :, :-1], toks[0, k, :, 1:])[0].backward()
    gmax += max(p.grad.abs().max().item() for p in ref.parameters()) / n
for s in range(STEPS):
    x, y = toks[s, ..., :-1].reshape(n * B, L), toks[s, ..., 1:].reshape(
        n * B, L)
    ref_opt.zero_grad()
    loss = lm_loss_with_aux(ref, x, y)[0]
    loss.backward()
    ref_opt.step()
    ref_losses.append(loss.item())
    if s == 0:
        ref_first = {k: v.detach().clone() for k, v in ref.named_parameters()}
ref_final = {k: v.detach() for k, v in ref.named_parameters()}


def close(a, b, rtol, atol, what):
    assert torch.allclose(a, b, rtol=rtol, atol=atol), (
        what, (a - b).abs().max().item())


def reference(make):
    # one rank fed every batch, with optimizer make: losses, parameters
    ref = lm()
    opt = make(ref.parameters())
    losses = []
    for s in range(STEPS):
        x, y = toks[s, ..., :-1].reshape(n * B, L), toks[s, ..., 1:].reshape(
            n * B, L)
        opt.zero_grad()
        loss = lm_loss_with_aux(ref, x, y)[0]
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses, {k: v.detach() for k, v in ref.named_parameters()}


def check(name, step, params_of, quantized=False, ref=None,
          normalized_lr=None):
    ref_l, ref_p = ref or (ref_losses, ref_final)
    losses = []
    for s in range(STEPS):
        m = step(toks[s, r, :, :-1], toks[s, r, :, 1:])
        losses.append(m["main/loss"].item())
        if quantized and s == 0:
            got = params_of()
            bound = LR * gmax / 254 * (1 + 1e-3) + 1e-6
            for k, v in got.items():
                close(v - start[k], ref_first[k] - start[k], 0, bound,
                      (name, k))
    if quantized:
        close(torch.tensor(losses[0]), torch.tensor(ref_losses[0]), 1e-5,
              0, (name, "loss"))
        return
    close(torch.tensor(losses), torch.tensor(ref_l), 1e-5, 0,
          (name, "losses"))
    for k, v in params_of().items():
        if normalized_lr is None:
            close(v, ref_p[k], 1e-4, 1e-6, (name, k))
            continue
        # an Adam-normalized update moves a weight whose gradient is at
        # the sums' noise by up to lr a step, whichever sign the last
        # bits give: one weight in a thousand may take that bound instead
        d = (v - ref_p[k]).abs()
        off = d > 1e-6 + 1e-4 * ref_p[k].abs()
        assert off.sum().item() <= max(1, v.numel() // 1000), (name, k)
        assert d.max().item() <= 2 * normalized_lr * STEPS, (name, k)
    print(f"RANK{r} {name} losses {losses}", flush=True)


for name in ("flat", "hierarchical", "auto", "int8-block"):
    model = lm()
    comm.bcast_data(model)
    if name == "hierarchical":
        red = HierarchicalReducer(comm, intra=2)
    elif name == "int8-block":
        red = make_grad_reducer("quantized", comm, wire_format="int8-block")
    else:
        red = make_grad_reducer(name, comm)
    opt = create_multi_node_optimizer(sgd(model.parameters()), comm,
                                      grad_reducer=red)
    step = make_data_parallel_train_step(model, opt, comm,
                                         loss_fn=lm_loss_with_aux)
    check(f"dp-{name}", step,
          lambda: {k: v.detach() for k, v in model.named_parameters()},
          quantized=name == "int8-block")

for stage in (1, 2):
    for bb in (None, 16384):
        model = lm()
        comm.bcast_data(model)
        if stage == 1:
            step, state = make_zero1_train_step(
                model, sgd, comm, loss_fn=lm_loss_with_aux, bucket_bytes=bb)
        else:
            step, state = make_zero2_train_step(
                model, sgd, comm, n_microbatches=2,
                loss_fn=lm_loss_with_aux, bucket_bytes=bb)
        check(f"zero{stage}-{'bucketed' if bb else 'flat'}", step,
              lambda: zero1_params(state, model, bb))
        assert state.optimizer_state_numel() == sum(state.layout.padded) // n


def fsdp_params(state, scan):
    tree = fsdp_gather_params(state)
    if scan:
        tree = unstack_lm_blocks(tree)
    return {k: v.to(dev) for k, v in params_from_flax(lm(), tree).items()}


def lamb(params):
    return LAMB(params, 1e-2, weight_decay=1e-4)


for name, make, ref, lr in (("fsdp", sgd, None, None),
                            ("fsdp-lamb", lamb, reference(lamb), 1e-2)):
    model = lm()
    comm.bcast_data(model)
    step, state = make_fsdp_train_step(model, make, comm,
                                       loss_fn=lm_loss_with_aux)
    check(name, step, lambda: fsdp_params(state, False), ref=ref,
          normalized_lr=lr)
model = lm()
comm.bcast_data(model)
packed = stack_lm_blocks(flax_params(model))
sh = dict(fsdp_shardings(packed, comm),
          blocks=fsdp_stack_shardings(packed, comm)["blocks"])
step, state = make_fsdp_train_step(None, sgd, comm, packed,
                                   loss_fn=make_lm_fsdp_scan_loss(model),
                                   param_shardings=sh)
check("fsdp-scan", step, lambda: fsdp_params(state, True))
assert state.gathered_bytes == 0

comm.barrier()
comm.finalize()
print(f"RANK{r} OK", flush=True)
"""


def test_training_steps_across_four_cards():
    """The data-parallel step with every reducer, ZeRO-1/2 (flat and
    bucketed) and FSDP (plain, LAMB, the scanned stack) on four NCCL
    ranks against one rank fed every batch (module docstring)."""
    _four_cards()
    assert_ranks_ok(run_world(TRAIN_WORKER, 4, timeout=400))


PARALLEL_WORKER = r"""
import os
import torch
import torch.nn.functional as F
from chainermn_torch.comm import create_communicator
from chainermn_torch.models.convert import (dense_params_from_ranks,
                                            rank_params_from_dense)
from chainermn_torch.models.transformer import (TransformerLM,
                                                lm_loss_with_aux, tp_lm_loss)
from chainermn_torch.training import (init_expert_parallel_state,
                                      make_expert_parallel_train_step)

torch.backends.cuda.matmul.allow_tf32 = False
DEV = os.environ.get("WORLD_DEVICE", "cuda")
comm = create_communicator("pure_nccl", device=DEV)
r, dev, n = comm.rank, comm.device, comm.size
solo = comm.split(("block", 1))          # this rank alone: the oracles
TOL = 1e-4
L, V = 64, 256
ll = L // n
mine = slice(r * ll, (r + 1) * ll)
CFG = dict(vocab=V, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           max_len=L, pos_emb="rope", device=dev)
g = torch.Generator().manual_seed(1)
toks = torch.randint(0, V, (1, L + 1), generator=g).to(dev)
x, y = toks[:, :-1], toks[:, 1:]


def lm(**kw):
    torch.manual_seed(0)
    return TransformerLM(**CFG, **kw)


def close(got, want, what):
    for k, w in want.items():
        e = ((got[k].float() - w.float()).norm()
             / w.float().norm().clamp_min(1e-30)).item()
        assert e <= TOL, (what, k, e)


def ce(logits, targets):
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


# the one-rank model on the whole sequence
ref = lm()
base = {k: v.clone() for k, v in ref.state_dict().items()}
logits = ref(x)
ref_loss = ce(logits, y)
ref_loss.backward()
ref_logits = logits.detach()[:, mine]
ref_grads = {k: p.grad for k, p in ref.named_parameters()}

# ring_flash and Ulysses: the sequence split over the four cards
for impl in ("ring_flash", "ulysses"):
    model = lm(attention=impl, seq_axis="sp", comms={"sp": comm})
    model.load_state_dict(base)
    out = model(x[:, mine], pos_offset=r * ll)
    loss = ce(out, y[:, mine])
    (loss / n).backward()
    comm.allreduce_grad([p.grad for p in model.parameters()], "sum")
    close({"logits": out.detach()}, {"logits": ref_logits}, impl)
    total = comm.allreduce(loss.detach(), "mean")
    assert abs(total.item() - ref_loss.item()) <= TOL * ref_loss.item()
    close({k: p.grad for k, p in model.named_parameters()}, ref_grads,
          impl)

# tensor parallelism: the dense weights cut over the four cards
tp = lm(tp_axis="tp", lm_head_tp=True, comms={"tp": comm})
tp.load_state_dict(rank_params_from_dense(tp, base, r, n))
loss, _ = tp_lm_loss(tp, x, y)
loss.backward()
assert abs(loss.item() - ref_loss.item()) <= TOL * ref_loss.item()
names = [k for k, _ in tp.named_parameters()]
stacks = [comm.allgather(p.grad) for _, p in tp.named_parameters()]
got = dense_params_from_ranks(lm(), [dict(zip(names, (s[i] for s in stacks)))
                                     for i in range(n)])
close(got, ref_grads, "tp")

# the expert-parallel step (8 experts over the four cards) against the
# one-process oracle on this card: each rank's tokens run apart
moe_kw = dict(expert_axis="e", capacity_factor=2.0, moe_top_k=2)
model = lm(moe_experts_per_device=2, comms={"e": comm}, **moe_kw)
specs = init_expert_parallel_state(model, comm, seed=0)
own = [q for q, e in specs.items() if e]
sd = model.state_dict()
tables = [comm.allgather(sd[q]) for q in own]
sd0 = {q: v.clone() for q, v in sd.items()}
gm = torch.Generator().manual_seed(10 + r)
mt = torch.randint(0, V, (1, L + 1), generator=gm).to(dev)
allx = comm.allgather(mt)
step = make_expert_parallel_train_step(
    model, torch.optim.SGD(model.parameters(), lr=0.0), comm, specs,
    loss_fn=lm_loss_with_aux)
m = step(mt[:, :-1], mt[:, 1:])
oracle = lm(moe_experts_per_device=2 * n, comms={"e": solo}, **moe_kw)
oracle.load_state_dict(dense_params_from_ranks(
    oracle, [dict(sd0, **{q: t[i] for q, t in zip(own, tables)})
             for i in range(n)]))
total = 0.0
for i in range(n):
    part, _ = lm_loss_with_aux(oracle, allx[i][:, :-1], allx[i][:, 1:])
    (part / n).backward()
    total += part.item() / n
assert abs(m["main/loss"].item() - total) <= TOL * total
grads = {q: p.grad for q, p in model.named_parameters()}
want = {q: (p.grad.chunk(n)[r] if specs[q] else p.grad)
        for q, p in oracle.named_parameters()}
close(grads, want, "moe")

comm.barrier()
solo.finalize()
comm.finalize()
print(f"RANK{r} OK", flush=True)
"""


def test_parallel_forms_across_four_cards():
    """ring_flash and Ulysses attention, Megatron TP with the
    vocabulary-parallel loss, and the expert-parallel step (top-2, 8
    experts) on four NCCL ranks at a small width (f32, TF32 off), each
    held on every rank to one rank: the one-rank model on the whole
    sequence, the dense model's gradients, and the one-process MoE
    oracle; relative L2 error 1e-4 (the same f32 sums split over cards
    and merged in another order)."""
    _four_cards()
    assert_ranks_ok(run_world(PARALLEL_WORKER, 4, timeout=300))
