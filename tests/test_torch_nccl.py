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


@pytest.mark.skipif(torch.cuda.device_count() < 4,
                    reason="needs four GPUs: one NCCL rank each")
def test_nccl_point_to_point_across_four_cards():
    assert_ranks_ok(run_world(_WORKER, 4, timeout=240))
