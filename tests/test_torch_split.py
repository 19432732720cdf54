"""The port's sub-communicators against the JAX package's: ``split``
(closed forms, colour sequences, irregular colours, reordering keys, the
reference's per-rank colour, a split of a split) and the communicators
over a mesh's axes (``create_communicator(mesh=, axes=)`` with a
``DeviceMesh``, and the ``hierarchical`` name's ``("dcn", "ici")`` mesh).

The port runs in one 4-rank gloo world (two ranks a node) that writes each
rank's groups and collective results; the JAX side splits an
``XlaCommunicator`` over 4 CPU devices (``tests/comm_tests/
test_communicator.py``'s cases at 4 ranks) and reads each rank's group
off its sub-mesh: the same members in the same order
(``MPI_Comm_split``'s ``(key, rank)``). Collective results are exact
(sums of small integers; gathers copy).
"""

import pickle

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from chainermn_tpu.comm.xla import XlaCommunicator
from tests.test_torch_mp import assert_ranks_ok, run_world

N = 4
REV = [3, 2, 1, 0]
#: name → (colour, key) as the port's split takes them (every rank's)
CASES = {"block": (("block", 2), None),
         "stride": (("stride", 2), None),
         "block_list": ([0, 0, 1, 1], None),
         "irregular": ([0, 0, 0, 1], None),
         "irregular_rev": ([0, 0, 0, 1], REV),
         "block_rev": ([0, 0, 1, 1], REV),
         "stride_rev": ([0, 1, 0, 1], REV)}

_WORKER = r'''
import os, pickle, sys
import torch
from torch.distributed.device_mesh import init_device_mesh
from chainermn_torch.comm import create_communicator

CASES = %r
comm = create_communicator("pure_nccl", device="cpu")
r = comm.rank
res = {}


def probe(sub):
    x = torch.tensor([10.0 * comm.rank])
    out = {"members": sub.members, "rank": sub.rank, "size": sub.size,
           "sum": sub.allreduce(x).item(),
           "gather": sub.allgather(x).reshape(-1).tolist(),
           "bcast": sub.bcast(x, root=0).item(),
           "objs": sub.allgather_obj(comm.rank),
           "alltoall": sub.alltoall(torch.arange(sub.size) * 1.0
                                    + 100 * comm.rank).tolist(),
           "tiles": sub.reduce_scatter_flat(
               torch.arange(2.0 * sub.size) * (comm.rank + 1)).tolist(),
           "node": (sub.intra_rank, sub.intra_size, sub.inter_rank,
                    sub.inter_size)}
    g = sub.gather(x, root=sub.size - 1)
    out["gathered"] = None if g is None else g.reshape(-1).tolist()
    out["scatter"] = sub.scatter(
        torch.arange(sub.size) * 1.0 + 7 if sub.rank == 0 else None,
        0).item()
    if sub.size > 1:
        if sub.rank == 0:
            sub.send(torch.tensor([float(comm.rank)]), 1, tag=3)
            sub.send_obj({"from": comm.rank}, 1)
        elif sub.rank == 1:
            out["p2p"] = (sub.recv(0, tag=3).item(), sub.recv_obj(0))
    sub.barrier()
    return out


for name, (color, key) in CASES.items():
    sub = comm.split(color, key)
    res[name] = probe(sub)
    sub.finalize()
# the reference's form: each rank passes its own colour and key
res["per_rank"] = probe(comm.split(r %% 2, key=-r))
# a split of a split: {0, 1, 2}, {3} -> by parity
irr = comm.split([0, 0, 0, 1])
res["nested"] = probe(irr.split(r %% 2))
try:
    comm.split(("block", 2), rank=(r + 1) %% 4)
    res["other_rank"] = "returned"
except ValueError as e:
    res["other_rank"] = str(e)
# axes of a DeviceMesh, and the hierarchical name's mesh
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("dcn", "ici"))
for ax in ("ici", "dcn"):
    res["mesh_" + ax] = probe(create_communicator("pure_nccl", device="cpu",
                                                  mesh=mesh, axes=(ax,)))
both = create_communicator("pure_nccl", device="cpu", mesh=mesh)
res["mesh_both"] = (both.members, both.axis_names, both.mesh is mesh,
                    both.size)
h = create_communicator("hierarchical", device="cpu")
res["hierarchical"] = (h.axis_names, h.mesh_shape, h.members,
                       h._bucket_bytes, h.grad_bucket_bytes,
                       h.mesh.mesh.tolist(), h.mesh.mesh_dim_names)
with open(os.path.join(sys.argv[1], f"rank{r}.pkl"), "wb") as f:
    pickle.dump(res, f)
h.finalize()
comm.finalize()
print(f"RANK{r} OK", flush=True)
''' % (CASES,)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("split")
    assert_ranks_ok(run_world(_WORKER, N, timeout=180, args=[str(d)],
                              local=2))
    return [pickle.loads((d / f"rank{r}.pkl").read_bytes())
            for r in range(N)]


@pytest.fixture(scope="module")
def jcomm():
    return XlaCommunicator(Mesh(np.array(jax.devices()[:N]), ("r",)))


def _jax_groups(jcomm, color, key):
    """Each rank's group (ranks in sub-communicator order) from JAX's
    split: the row of the sub-mesh, along the sub-communicator's axes,
    that holds the rank's device."""
    devs = list(jcomm.mesh.devices.reshape(-1))
    if isinstance(color, tuple):
        n, k = N, color[1]
        color = ([r // k for r in range(n)] if color[0] == "block"
                 else [r % (n // k) for r in range(n)])
    regular = color in ([r // 2 for r in range(N)], [r % 2 for r in range(N)])
    out = []
    for r in range(N):
        sub = jcomm.split(color, key=key, rank=None if regular else r)
        names = sub.mesh.axis_names
        axes = [names.index(a) for a in sub.axis_names]
        others = [i for i in range(len(names)) if i not in axes]
        rows = np.transpose(sub.mesh.devices, others + axes).reshape(
            -1, sub.size)
        row = next(rw for rw in rows if devs[r] in list(rw))
        out.append(tuple(devs.index(d) for d in row))
    return out


def _check_collectives(world, name, groups):
    for r, w in enumerate(world):
        got = w[name]
        members = groups[r]
        i = members.index(r)
        assert got["members"] == members and got["rank"] == i
        assert got["size"] == len(members)
        assert got["sum"] == sum(10.0 * m for m in members)
        assert got["gather"] == [10.0 * m for m in members]
        assert got["objs"] == list(members)
        assert got["bcast"] == 10.0 * members[0]
        assert got["alltoall"] == [100.0 * m + i for m in members]
        k = len(members)
        assert got["tiles"] == [sum(float(j) * (m + 1) for m in members)
                                for j in range(2 * i, 2 * i + 2)]
        assert got["gathered"] == (
            [10.0 * m for m in members] if i == k - 1 else None)
        assert got["scatter"] == 7.0 + i
        if i == 1:
            assert got["p2p"] == (float(members[0]), {"from": members[0]})


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_groups_and_order_match_jax(world, jcomm, name):
    """Each rank's group and its order equal JAX's split of the same
    colours and keys, and the sub-communicator's collectives (all-reduce,
    all-gather, broadcast, object all-gather, all-to-all, reduce-scatter
    tiles, gather, scatter, send/recv) follow that order."""
    color, key = CASES[name]
    _check_collectives(world, name, _jax_groups(jcomm, color, key))


def test_per_rank_colour_and_nested_split(world):
    """The reference's form (each rank its own colour ``r % 2`` and key
    ``-r``: groups ordered by key) and a split of the irregular
    {0, 1, 2}, {3} by parity: {0, 2}, {1}, {3}. Node-local counts come
    from the members (two ranks a node)."""
    _check_collectives(world, "per_rank", [(2, 0), (3, 1), (2, 0), (3, 1)])
    _check_collectives(world, "nested", [(0, 2), (1,), (0, 2), (3,)])
    assert world[0]["per_rank"]["node"] == (0, 1, 0, 2)
    assert world[2]["nested"]["node"] == (0, 1, 1, 2)
    for w in world:
        assert "its own group" in w["other_rank"]


def test_mesh_axes_and_the_hierarchical_mesh(world):
    """A ``DeviceMesh`` (2, 2) ``("dcn", "ici")``: ``axes=("ici",)``
    groups the rows, ``("dcn",)`` the columns, both axes the world in
    row-major order; the ``hierarchical`` name builds nodes × local ranks
    with a 4 MiB bucket."""
    _check_collectives(world, "mesh_ici", [(0, 1), (0, 1), (2, 3), (2, 3)])
    _check_collectives(world, "mesh_dcn", [(0, 2), (1, 3), (0, 2), (1, 3)])
    for w in world:
        assert w["mesh_both"] == ((0, 1, 2, 3), ("dcn", "ici"), True, 4)
        assert w["hierarchical"] == (
            ("dcn", "ici"), {"dcn": 2, "ici": 2}, (0, 1, 2, 3), 4 << 20,
            4 << 20, [[0, 1], [2, 3]], ("dcn", "ici"))
