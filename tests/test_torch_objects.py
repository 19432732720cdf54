"""The port's object collectives (``bcast_obj``, ``gather_obj``,
``allgather_obj``, ``allreduce_obj``, ``scatter_obj``, ``send_obj``,
``recv_obj``) in real gloo worlds of 2 and 3 processes, and
``allreduce_obj`` held to ``XlaCommunicator.allreduce_obj`` on the same
per-rank objects. Objects are compared exactly: they are pickled, not
computed on."""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import pickle
import types

import numpy as np
import pytest

import chainermn_tpu
from chainermn_torch.comm import create_communicator
from tests.test_torch_mp import assert_ranks_ok, run_world

OPS = ("sum", "mean", "max", "min")

_TWO = r'''
import os, pickle, sys
import numpy as np
from chainermn_torch.comm import create_communicator

out = sys.argv[1]
comm = create_communicator("naive", device="cpu")
r = comm.rank
assert comm.size == 2

# bcast_obj from either root, any picklable object
big = np.arange(300_000, dtype=np.float64)          # 2.4 MB
got = comm.bcast_obj({"x": big, "s": "root0"} if r == 0 else None)
assert got["s"] == "root0" and np.array_equal(got["x"], big)
assert comm.bcast_obj(("from", 1) if r == 1 else "ignored", root=1) == (
    "from", 1)

# gather_obj: the list on the root only; allgather_obj: everywhere
g = comm.gather_obj({"rank": r}, root=1)
assert g == ([{"rank": 0}, {"rank": 1}] if r == 1 else None), g
assert comm.allgather_obj([r, str(r)]) == [[0, "0"], [1, "1"]]

# allreduce_obj over nested dicts, lists and tuples
obj = {"a": r + 1, "b": [r * 2.5, (r, 3)], "c": {"d": -r, "e": 7 - 4 * r}}
res = {op: comm.allreduce_obj(obj, op) for op in
       ("sum", "mean", "max", "min")}
gathered = comm.allgather_obj(obj)
for bad, err in ((lambda: comm.allreduce_obj(obj, "prod"), ValueError),):
    try:
        bad()
        raise AssertionError("no error")
    except err:
        pass
try:   # structures differ across ranks: both ranks raise
    comm.allreduce_obj({"a": 1} if r == 0 else {"b": 1})
    raise AssertionError("no error")
except ValueError:
    pass

# scatter_obj from root 1
assert comm.scatter_obj(["zero", {"one": 1}] if r == 1 else None,
                        root=1) == (["zero", {"one": 1}][r])
if r == 0:
    try:
        comm.scatter_obj([1], root=0)     # one object for two ranks
        raise AssertionError("no error")
    except ValueError:
        pass

# send_obj / recv_obj: tags are matched, messages of a tag in order (a
# send returns once the peer posted the matching receive, as MPI's may)
if r == 0:
    comm.send_obj("first-7", dest=1, tag=7)
    comm.send_obj(big, dest=1, tag=9)
    comm.send_obj({"second": 7}, dest=1, tag=7)
    assert comm.recv_obj(src=1, tag=3) == "reply"
else:
    assert comm.recv_obj(src=0, tag=7) == "first-7"
    assert np.array_equal(comm.recv_obj(src=0, tag=9), big)
    assert comm.recv_obj(src=0, tag=7) == {"second": 7}
    comm.send_obj("reply", dest=0, tag=3)
try:
    comm.send_obj(1, dest=r)
    raise AssertionError("no error")
except ValueError:
    pass
with open(os.path.join(out, f"rank{r}.pkl"), "wb") as f:
    pickle.dump({"res": res, "gathered": gathered}, f)
comm.finalize()
print(f"RANK{r} OK", flush=True)
'''

_THREE = r'''
import numpy as np
from chainermn_torch.comm import create_communicator

comm = create_communicator("pure_nccl", device="cpu")
r = comm.rank
assert comm.size == 3 and comm.inter_size == 1
# uneven: objects of very different sizes, from a non-zero root
objs = [list(range(10)), "x", {"k": np.arange(50_000)}]
got = comm.scatter_obj(objs if r == 2 else None, root=2)
if r == 2:
    assert got is objs[2]
else:
    assert got == objs[r], (r, got)
assert comm.gather_obj(r * r, root=0) == ([0, 1, 4] if r == 0 else None)
assert comm.allgather_obj(r) == [0, 1, 2]
assert comm.bcast_obj(r, root=2) == 2
assert comm.allreduce_obj({"n": r, "f": [float(r)]}, "mean") == {
    "n": 1.0, "f": [1.0]}
assert comm.allreduce_obj((r, -r), "max") == (2, 0)
comm.finalize()
print(f"RANK{r} OK", flush=True)
'''


def _jax_allreduce_obj(objs, op):
    """``XlaCommunicator.allreduce_obj`` on these per-rank objects: its
    object plane's ``allgather_obj`` is replaced on this instance by one
    that returns them."""
    comm = chainermn_tpu.create_communicator("xla")
    comm._obj = types.SimpleNamespace(allgather_obj=lambda obj: objs)
    return comm.allreduce_obj(objs[0], op)


def test_two_rank_object_collectives(tmp_path):
    """bcast_obj (both roots, a 2.4 MB array), gather_obj, allgather_obj,
    allreduce_obj (four ops on nested containers, a bad op and unequal
    structures refused), scatter_obj, tagged send_obj/recv_obj; then
    each rank's allreduce_obj results equal JAX's reduction of the same
    gathered objects."""
    assert_ranks_ok(run_world(_TWO, 2, timeout=90, args=[str(tmp_path)]))
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            got = pickle.load(f)
        for op in OPS:
            want = _jax_allreduce_obj(got["gathered"], op)
            assert got["res"][op] == want, (r, op, got["res"][op], want)
            assert type(got["res"][op]["b"][1]) is tuple


def test_three_rank_uneven_scatter_obj():
    """scatter_obj of unequal objects from root 2, gather_obj,
    allgather_obj, bcast_obj and allreduce_obj in a 3-rank world."""
    assert_ranks_ok(run_world(_THREE, 3, timeout=90))


@pytest.mark.parametrize("op", OPS)
def test_allreduce_obj_reduction_is_jaxs(op):
    """The port's ``allreduce_obj`` and ``XlaCommunicator.allreduce_obj``
    reduce the same three ranks' objects (each communicator's gather is
    replaced on its instance by one returning them) to the same result:
    containers kept, None an empty node, ints becoming floats under
    ``mean``, arrays summed (max/min of arrays is ambiguous in both)."""
    objs = [{"loss": 0.5 * r, "n": r + 1, "xs": [r, (2.0 * r, -r)],
             "none": None} for r in range(3)]
    if op in ("sum", "mean"):
        for r, o in enumerate(objs):
            o["arr"] = np.full(3, float(r))
    comm = create_communicator("naive", device="cpu")
    try:
        comm.allgather_obj = lambda obj: objs
        got = comm.allreduce_obj(objs[0], op)
    finally:
        comm.finalize()
    np.testing.assert_equal(got, _jax_allreduce_obj(objs, op))
    assert type(got["xs"][1]) is tuple and got["none"] is None
    if op == "mean":
        assert isinstance(got["n"], float) and got["n"] == 2.0
