"""The port's point-to-point and collective communication against the JAX
package's: ``comm`` array ``send``/``recv`` (pytrees, interleaved tags,
the NCCL sequence guard), ``alltoall``/``gather``/``scatter``, the
``functions`` (``send``/``recv``/``transfer``/``pseudo_connect``, the six
collectives with their backwards, ``eager_send``/``eager_recv``).

The port runs in one 4-rank gloo world (``run_world``) that writes each
rank's results; the JAX side runs the same numpy inputs (made from seeds)
through the JAX functions under ``shard_map`` on a 4-device mesh of the
virtual CPU devices, each device one rank. The total loss is the sum of
the ranks' losses, as under ``shard_map``.

Tolerances: transfers and the copying collectives exact (they copy
bits); all-reduced values and gradients ≤ 1e-6 absolute (sums of at most
four f32 values of size ~1-10, in another order).
"""

import collections
import inspect
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu import functions as JF
from chainermn_tpu.comm.xla import XlaCommunicator
from chainermn_torch import functions as F
from chainermn_torch.comm import p2p
from chainermn_torch.comm.distributed import duplicate_devices
from tests.test_torch_mp import assert_ranks_ok, run_world

N = 4
TOL_GRAD = 1e-6


Pair = collections.namedtuple("Pair", "x y")


def inputs():
    """Each rank's x [4, 3] and loss weights c [4, 3], allgather's C
    [4, 4, 3], scatter's stacked root input [4, 3], a pytree's leaves (the
    workers run this function's source, so they need not import JAX)."""
    rs = np.random.RandomState(0)
    return {"x": rs.randn(4, 4, 3).astype(np.float32),
            "c": rs.randn(4, 4, 3).astype(np.float32),
            "C": rs.randn(4, 4, 4, 3).astype(np.float32),
            "s": rs.randn(4, 4, 3).astype(np.float32),
            "a": rs.randn(4, 2).astype(np.float32),
            "b": rs.randn(4, 3, 2).astype(np.float32)}


_WORKER = r'''
import os, pickle, sys
import numpy as np
import torch
import torch.distributed as dist
from chainermn_torch.comm import create_communicator, p2p
from chainermn_torch import functions as F
''' + inspect.getsource(inputs) + r'''

out = sys.argv[1]
comm = create_communicator("pure_nccl", device="cpu")
r = comm.rank
d = inputs()
res = {}

def leaf(name):
    return torch.tensor(d[name][r], requires_grad=True)

def grad_of(t):
    return None if t.grad is None else t.grad.numpy()

# -- comm: pytrees and interleaved tags (gloo matches tags) ---------------
if r == 0:
    comm.send({"a": torch.tensor(d["a"][0]),
               "b": [torch.tensor(d["b"][0]), None],
               "i": torch.arange(5)}, 1, tag=0)
    comm.send(torch.tensor(d["x"][0]), 1, tag=1)
elif r == 1:
    second = comm.recv(0, tag=1)
    first = comm.recv(0, tag=0)
    res["tree"] = {"a": first["a"].numpy(), "b0": first["b"][0].numpy(),
                   "b1": first["b"][1], "i": first["i"].numpy(),
                   "x": second.numpy()}
# -- the NCCL route's sequence guard, forced on this gloo world -----------
if r == 2:
    comm.send(torch.tensor(d["a"][2]), 3, tag=0)
    comm.send(torch.tensor(d["b"][2]), 3, tag=1)
elif r == 3:
    comm._channels.ordered = True
    try:
        comm.recv(2, tag=1)
        res["guard"] = "returned"
    except RuntimeError as e:
        res["guard"] = str(e)
    res["after"] = comm.recv(2, tag=0).numpy()    # seq 0: in order
    # the refused message's payload is still on the wire: drain it
    buf = torch.empty(3, 2)
    dist.recv(buf, 2, group=comm._p2p, tag=p2p.wire_tags(1)[1])
    comm._channels.ordered = False
# -- comm collectives -----------------------------------------------------
res["alltoall"] = comm.alltoall(torch.tensor(d["x"][r])).numpy()
g = comm.gather(torch.tensor(d["a"][r]), root=2)
res["gather"] = None if g is None else g.numpy()
res["scatter"] = comm.scatter(torch.tensor(d["s"]) if r == 1 else None,
                              root=1).numpy()
# -- functions: send/recv ---------------------------------------------------
x = leaf("x")
phi = F.send(x, comm, 1, self_rank=0)
res["sendrecv"] = F.recv(comm, 0, delegate_variable=phi).detach().numpy()
x = leaf("x")
phi = F.send(x * 3.0, comm, 1, self_rank=0)
got = F.recv(comm, 0, delegate_variable=phi)
(got * (1.0 if r == 1 else 0.0)).sum().backward()
res["sendrecv_grad"] = grad_of(x)
x = leaf("x")
ex = F.transfer(x, comm, [(0, 1), (1, 0)])
res["exchange"] = ex.detach().numpy()
(ex * torch.tensor(d["c"][r])).sum().backward()
res["exchange_grad"] = grad_of(x)
x = leaf("x")
phi = F.send(x, comm, 1, self_rank=0)
y = F.pseudo_connect(phi, x * 2.0)
res["pseudo"] = y.detach().numpy()
y.sum().backward()
res["pseudo_grad"] = grad_of(x)
a, b = leaf("a"), leaf("b")
ring = F.transfer({"a": a, "b": b}, comm, [(i, (i + 1) % 4) for i in range(4)])
((ring["a"] * torch.tensor(d["a"][r] + 1)).sum()
 + (ring["b"] ** 2).sum()).backward()
res["ring"] = {k: v.detach().numpy() for k, v in ring.items()}
res["ring_grad"] = {"a": grad_of(a), "b": grad_of(b)}
# -- functions: the collectives -----------------------------------------------
c = torch.tensor(d["c"][r])
for name, fn in (("allreduce", lambda t: F.allreduce(comm, t)),
                 ("bcast", lambda t: F.bcast(comm, t, root=2)),
                 ("alltoall_f", lambda t: F.alltoall(comm, t))):
    x = leaf("x")
    y = fn(x)
    (y * c).sum().backward()
    res[name] = (y.detach().numpy(), grad_of(x))
x = leaf("x")
y = F.allgather(comm, x)
(y * torch.tensor(d["C"][r])).sum().backward()
res["allgather"] = (y.detach().numpy(), grad_of(x))
x = leaf("x")
y = F.gather(comm, x, root=3)
(y * torch.tensor(d["C"][r]) if r == 3 else y).sum().backward()
res["gather_f"] = (y.detach().numpy(), grad_of(x))
s = torch.tensor(d["s"], requires_grad=True) if r == 1 else None
y = F.scatter(comm, s, root=1)
(y * c).sum().backward()
res["scatter_f"] = (y.detach().numpy(), grad_of(s) if r == 1 else None)
# -- eager send/recv: rank 0 → rank 2 and the gradient back -------------------
w = torch.tensor(d["c"][r], requires_grad=True)
if r == 0:
    x = leaf("x")
    F.eager_send(torch.tanh(x) * w, comm, 2, tag=5).backward()
    res["eager"] = (grad_of(x), grad_of(w))
elif r == 2:
    h = F.eager_recv(comm, 0, shape=(4, 3), dtype=np.float32, anchor=w,
                     tag=5)
    (h * w).sum().backward()
    res["eager"] = (h.detach().numpy(), grad_of(w))
comm.barrier()
with open(os.path.join(out, f"rank{r}.pkl"), "wb") as f:
    pickle.dump(res, f)
comm.finalize()
print(f"RANK{r} OK", flush=True)
'''


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Each rank's results of the 4-rank world (one world for every
    case)."""
    out = tmp_path_factory.mktemp("p2p")
    assert_ranks_ok(run_world(_WORKER, N, timeout=120, args=[str(out)]))
    ranks = []
    for r in range(N):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@pytest.fixture(scope="module")
def jcomm():
    return XlaCommunicator(Mesh(np.array(jax.devices()[:N]), ("r",)))


def _shard(jcomm, fn, *xs, in_specs=None):
    spec = P("r")
    return jax.jit(shard_map(fn, mesh=jcomm.mesh,
                             in_specs=in_specs or (spec,) * len(xs),
                             out_specs=spec))(*xs)


def _value_and_grads(jcomm, f, x, c, in_specs=None):
    """Per-rank outputs of ``f`` and the gradient of the sum over ranks
    of ``sum(f(x_r) * c_r)`` with respect to ``x``."""
    def out(x, c):
        return _shard(jcomm, lambda x, c: f(x[0], c[0])[0][None], x, c,
                      in_specs=in_specs)

    def loss(x, c):
        return jnp.sum(_shard(jcomm, lambda x, c: f(x[0], c[0])[1][None],
                              x, c, in_specs=in_specs))

    return (np.asarray(out(x, c)),
            np.asarray(jax.grad(loss)(jnp.asarray(x), jnp.asarray(c))))


# -- header logic and helpers (no world) -----------------------------------


def test_sequence_guard_refuses_out_of_order_receives_on_an_ordered_route():
    """One (sender, receiver) pair's headers carry consecutive numbers
    over every tag; an ordered (NCCL) receiver that takes tag 1 before
    tag 0 raises instead of pairing tag 1's header with tag 0's payload.
    A gloo receiver (tags matched) takes them in any order."""
    t = [torch.zeros(2)]
    sender = p2p.Channels(ordered=True)
    h0 = sender.header(1, 0, None, t)
    h1 = sender.header(1, 1, None, t)
    other = sender.header(2, 0, None, t)
    assert (h0["seq"], h1["seq"], other["seq"]) == (0, 1, 0)
    nccl = p2p.Channels(ordered=True)
    with pytest.raises(RuntimeError, match="out-of-order receive"):
        nccl.accept(0, 1, h1)
    assert nccl.accept(0, 0, h0) == [((2,), torch.float32)]
    assert nccl.accept(0, 1, h1) == [((2,), torch.float32)]
    with pytest.raises(RuntimeError, match="carries tag 0"):
        nccl.accept(0, 1, h0)
    gloo = p2p.Channels(ordered=False)
    gloo.accept(0, 1, h1)
    gloo.accept(0, 0, h0)


def test_flatten_round_trips_nested_structures():
    tree = {"a": torch.ones(2), "b": [Pair(torch.zeros(1), None),
                                      (np.arange(3),)]}
    leaves, spec = p2p.flatten(tree)
    assert len(leaves) == 3
    spec = pickle.loads(pickle.dumps(spec))
    back = p2p.unflatten(spec, leaves)
    assert isinstance(back["b"][0], Pair) and back["b"][0].y is None
    assert torch.equal(back["b"][1][0], torch.arange(3))
    assert p2p.parse_dtype(str(torch.bfloat16)) == torch.bfloat16
    with pytest.raises(ValueError, match="tag"):
        p2p.check_tag(-1)


def test_duplicate_devices_groups_ranks_sharing_a_gpu():
    ids = [("h", "gpu0"), ("h", "gpu1"), ("h", "gpu0"), ("g", "gpu0")]
    assert duplicate_devices(ids) == [[0, 2]]
    assert duplicate_devices(ids[:2]) == []


def test_functions_refuse_what_the_jax_package_refuses():
    with pytest.raises(ValueError, match="self_rank"):
        F.send(torch.ones(3), None, 1)
    with pytest.raises(ValueError, match="DelegateVariable"):
        F.recv(None, 0)
    with pytest.raises(ValueError, match="does not match"):
        F.recv(None, 0, delegate_variable=F.DelegateVariable(
            torch.ones(3), src=2, dest=3))
    with pytest.raises(ValueError, match="aval"):
        F.eager_recv(None, 0)
    with pytest.raises(ValueError, match="aval"):
        F.eager_recv(None, 0, shape=(2,))


# -- comm-level messages ---------------------------------------------------


def test_comm_send_recv_carries_pytrees_on_tagged_channels(port):
    """Rank 1 takes tag 1 before tag 0: over gloo each tag is its own
    channel, and the structure, shapes and dtypes come with the
    message."""
    d = inputs()
    got = port[1]["tree"]
    np.testing.assert_array_equal(got["a"], d["a"][0])
    np.testing.assert_array_equal(got["b0"], d["b"][0])
    assert got["b1"] is None and got["i"].dtype == np.int64
    np.testing.assert_array_equal(got["i"], np.arange(5))
    np.testing.assert_array_equal(got["x"], d["x"][0])


def test_comm_sequence_guard_refuses_in_a_world(port):
    """The guard on a live world: the out-of-order receive raises, the
    in-order one then returns its own message."""
    assert "out-of-order receive from rank 2" in port[3]["guard"]
    np.testing.assert_array_equal(port[3]["after"], inputs()["a"][2])


def test_comm_alltoall_gather_scatter(port):
    """Rank r's chunk s lands in rank s's slot r; the root of a gather
    gets the rank-ordered stack, the others None; a scatter gives each
    rank its slice of the root's stack."""
    d = inputs()
    for r in range(N):
        np.testing.assert_array_equal(port[r]["alltoall"], d["x"][:, r])
        if r == 2:
            np.testing.assert_array_equal(port[r]["gather"], d["a"])
        else:
            assert port[r]["gather"] is None
        np.testing.assert_array_equal(port[r]["scatter"], d["s"][r])


# -- functions against the JAX functions -----------------------------------


def test_send_recv_forward(port, jcomm):
    d = inputs()

    def f(v):
        phi = JF.send(v[0], jcomm, 1, self_rank=0)
        return JF.recv(jcomm, 0, delegate_variable=phi)[None]

    want = np.asarray(_shard(jcomm, f, d["x"]))
    for r in range(N):
        np.testing.assert_array_equal(port[r]["sendrecv"], want[r])


def test_send_recv_gradient(port, jcomm):
    """The loss lives on rank 1; the gradient arrives back at rank 0's
    input through the ×3."""
    d = inputs()

    def loss(v_all):
        def f(v):
            phi = JF.send(v[0] * 3.0, jcomm, 1, self_rank=0)
            got = JF.recv(jcomm, 0, delegate_variable=phi)
            sel = (jcomm.axis_index() == 1).astype(got.dtype)
            return jnp.sum(got * sel)[None]
        return jnp.sum(_shard(jcomm, f, v_all))

    want = np.asarray(jax.grad(loss)(jnp.asarray(d["x"])))
    for r in range(N):
        np.testing.assert_allclose(port[r]["sendrecv_grad"], want[r],
                                   atol=TOL_GRAD, rtol=0)


def test_bidirectional_exchange_and_its_gradient(port, jcomm):
    d = inputs()
    out, grads = _value_and_grads(
        jcomm, lambda x, c: (lambda y: (y, jnp.sum(y * c)))(
            JF.transfer(x, jcomm, [(0, 1), (1, 0)])), d["x"], d["c"])
    for r in range(N):
        np.testing.assert_array_equal(port[r]["exchange"], out[r])
        np.testing.assert_allclose(port[r]["exchange_grad"], grads[r],
                                   atol=TOL_GRAD, rtol=0)


def test_pseudo_connect(port, jcomm):
    d = inputs()

    def f(x, c):
        y = JF.pseudo_connect(JF.send(x, jcomm, 1, self_rank=0), x * 2.0)
        return y, jnp.sum(y)

    out, grads = _value_and_grads(jcomm, f, d["x"], d["c"])
    for r in range(N):
        np.testing.assert_array_equal(port[r]["pseudo"], out[r])
        np.testing.assert_allclose(port[r]["pseudo_grad"], grads[r],
                                   atol=TOL_GRAD, rtol=0)


def test_transfer_of_a_pytree_around_a_ring(port, jcomm):
    d = inputs()
    ring = [(i, (i + 1) % N) for i in range(N)]

    def per_rank(a, b, w):
        moved = JF.transfer({"a": a[0], "b": b[0]}, jcomm, ring)
        return moved, jnp.sum(moved["a"] * w[0]) + jnp.sum(moved["b"] ** 2)

    spec = P("r")
    wts = d["a"] + 1

    def run(which):
        return jax.jit(shard_map(
            lambda a, b, w: jax.tree_util.tree_map(
                lambda v: v[None], per_rank(a, b, w)[which]),
            mesh=jcomm.mesh, in_specs=(spec,) * 3, out_specs=spec))

    moved = run(0)(d["a"], d["b"], wts)
    ga, gb = jax.grad(lambda a, b: jnp.sum(run(1)(a, b, wts)),
                      argnums=(0, 1))(jnp.asarray(d["a"]),
                                      jnp.asarray(d["b"]))
    for r in range(N):
        for k in ("a", "b"):
            np.testing.assert_array_equal(port[r]["ring"][k],
                                          np.asarray(moved[k])[r])
        np.testing.assert_allclose(port[r]["ring_grad"]["a"],
                                   np.asarray(ga)[r], atol=TOL_GRAD, rtol=0)
        np.testing.assert_allclose(port[r]["ring_grad"]["b"],
                                   np.asarray(gb)[r], atol=TOL_GRAD, rtol=0)


_COLLECTIVES = {
    "allreduce": (lambda c, x: JF.allreduce(c, x), "c"),
    "bcast": (lambda c, x: JF.bcast(c, x, root=2), "c"),
    "alltoall_f": (lambda c, x: JF.alltoall(c, x), "c"),
    "allgather": (lambda c, x: JF.allgather(c, x), "C"),
}


@pytest.mark.parametrize("name", sorted(_COLLECTIVES))
def test_collective_forward_and_backward(port, jcomm, name):
    """allreduce ↔ allreduce, bcast → the sum at the root, alltoall ↔
    alltoall, allgather ↔ reduce-scatter."""
    fn, cname = _COLLECTIVES[name]
    d = inputs()
    out, grads = _value_and_grads(
        jcomm, lambda x, c: (lambda y: (y, jnp.sum(y * c)))(fn(jcomm, x)),
        d["x"], d[cname])
    for r in range(N):
        y, g = port[r][name]
        if name == "allreduce":
            np.testing.assert_allclose(y, out[r], atol=TOL_GRAD, rtol=0)
        else:
            np.testing.assert_array_equal(y, out[r])
        np.testing.assert_allclose(g, grads[r], atol=TOL_GRAD, rtol=0)


def test_gather_gives_the_root_the_stack_and_scatters_its_gradient(port,
                                                                   jcomm):
    """The JAX gather materialises the stack on every shard; only the
    root's enters the loss, as only the root holds it in the port."""
    d = inputs()

    def f(x, c):
        y = JF.gather(jcomm, x, root=3)
        sel = (jcomm.axis_index() == 3).astype(y.dtype)
        return y, jnp.sum(y * c) * sel

    out, grads = _value_and_grads(jcomm, f, d["x"], d["C"])
    for r in range(N):
        y, g = port[r]["gather_f"]
        if r == 3:
            np.testing.assert_array_equal(y, out[r])
        else:
            assert y.shape == () and y == 0.0
        np.testing.assert_allclose(g, grads[r], atol=TOL_GRAD, rtol=0)


def test_scatter_gives_each_rank_its_slice_and_gathers_the_gradient(port,
                                                                    jcomm):
    d = inputs()

    def per(s, c):
        y = JF.scatter(jcomm, s, root=1)
        return y[None], jnp.sum(y * c[0])[None]

    def run(which):
        return jax.jit(shard_map(lambda s, c: per(s, c)[which],
                                 mesh=jcomm.mesh, in_specs=(P(), P("r")),
                                 out_specs=P("r")))

    out = np.asarray(run(0)(d["s"], d["c"]))
    grad = np.asarray(jax.grad(lambda s: jnp.sum(run(1)(s, d["c"])))(
        jnp.asarray(d["s"])))
    for r in range(N):
        y, g = port[r]["scatter_f"]
        np.testing.assert_array_equal(y, out[r])
        if r == 1:
            np.testing.assert_allclose(g, grad, atol=TOL_GRAD, rtol=0)


def test_eager_send_recv_gradient_round_trip(port):
    """Rank 0 eager-sends tanh(x)·w to rank 2, whose loss is Σ h·w₂; the
    gradient of x arrives back through the send token: (1 − tanh²x)·w₀·w₂
    (the eager functions have no JAX counterpart in one process; the
    reference is the analytic gradient of the unsplit loss)."""
    d = inputs()
    x, w0, w2 = d["x"][0], d["c"][0], d["c"][2]
    h, gw2 = port[2]["eager"]
    # torch's tanh against numpy's: a few ulps
    np.testing.assert_allclose(h, np.tanh(x) * w0, atol=TOL_GRAD, rtol=0)
    np.testing.assert_allclose(gw2, np.tanh(x) * w0, atol=TOL_GRAD, rtol=0)
    gx, gw0 = port[0]["eager"]
    np.testing.assert_allclose(gx, (1 - np.tanh(x) ** 2) * w0 * w2,
                               atol=TOL_GRAD, rtol=0)
    np.testing.assert_allclose(gw0, np.tanh(x) * w2, atol=TOL_GRAD, rtol=0)
