"""The port's store-backed object plane (``chainermn_torch/comm/
object_plane.py``) against the JAX package's (``chainermn_tpu/comm/
object_plane.py``).

The abort key is JAX's, and a fake store reads it as JAX's fake clients
do (``tests/resilience_tests/test_abort_key.py``). The file-backed plane
is a copy, so a message one package writes the other reads. Then the
plane in gloo worlds (``run_world``): the object collectives,
point-to-point around a ring (a put never waits for its receiver), a
bounded receive that keeps its slot, chunked puts, ``host_barrier``, the
abort key turning a peer's wait into ``JobAbortedError`` within one
probe slice, the except hook posting it, and a dead store host failing
the survivors' waits at once.
"""

import os
import subprocess
import sys

import pytest

from chainermn_tpu.comm import object_plane as jplane
from chainermn_torch.comm import object_plane as plane
from tests.test_torch_mp import REPO, run_world


class _FakeStore:
    """A ``torch.distributed`` store in a dict."""

    def __init__(self, kv=None):
        self.kv = {} if kv is None else kv

    def set(self, k, v):
        self.kv[k] = v.encode() if isinstance(v, str) else bytes(v)

    def get(self, k):
        return self.kv[k]

    def check(self, keys):
        return all(k in self.kv for k in keys)


class _TryGetClient:
    """JAX's newer coordinator client over the same dict."""

    def __init__(self, kv):
        self.kv = kv

    def key_value_try_get(self, key):
        v = self.kv[key]
        return v.decode() if isinstance(v, bytes) else v


class _BrokenStore:
    def check(self, keys):
        raise RuntimeError("store gone")


def test_the_keys_are_jaxs():
    assert (plane._ABORT_KEY, plane._ABORT_FLAG, plane._ALIVE_KEY) == (
        jplane._ABORT_KEY, jplane._ABORT_FLAG, jplane._ALIVE_KEY)


def test_a_fake_store_reads_the_abort_key_as_jaxs_client_does():
    kv = {}
    store, client = _FakeStore(kv), _TryGetClient(kv)
    assert plane._read_abort(store) is None is jplane._read_abort(client)
    plane.post_abort("peer 1 died", store=store)
    assert plane._read_abort(store) == jplane._read_abort(client) \
        == "peer 1 died"
    kv.clear()
    kv["og/abortive/other"] = b"not an abort"
    assert plane._read_abort(store) is None is jplane._read_abort(client)
    assert plane._read_abort(_BrokenStore()) is None
    assert plane._read_abort(None) is None


def test_a_posted_abort_fails_a_guarded_wait(monkeypatch):
    from chainermn_torch.resilience.policy import RpcPolicy, set_policy

    prev = set_policy(RpcPolicy(timeout_ms=5000, probe_ms=50))
    try:
        store = _FakeStore()
        plane.post_abort("rank 3 crashed", store=store)
        with pytest.raises(plane.JobAbortedError, match="rank 3 crashed"):
            plane._wait_key("never", 5000, store=store)
        with pytest.raises(TimeoutError):
            plane._wait_key("never", 30, store=_FakeStore())
    finally:
        set_policy(prev)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_file_plane_messages_cross_the_packages(tmp_path, writer, reader):
    """The file-backed plane is a copy: one package's messages, GC mark
    and sequence numbers are the other's."""
    mods = {"jax": jplane.FsObjectPlane, "port": plane.FsObjectPlane}
    tx = mods[writer](str(tmp_path), 0, 2)
    rx = mods[reader](str(tmp_path), 1, 2)
    for i in range(3):
        tx.send_obj({"i": i}, 1, tag=61)
    assert [rx.recv_obj(0, tag=61) for _ in range(2)] == [{"i": 0}, {"i": 1}]
    assert rx.gc(0, tag=61) == 2
    with pytest.raises(TimeoutError):
        rx.try_recv_obj(0, tag=62, timeout_ms=10)
    reborn = mods[reader](str(tmp_path), 1, 2)
    assert reborn.recv_obj(0, tag=61) == {"i": 2}
    tx2 = mods[writer](str(tmp_path), 0, 2)
    tx2.send_obj("next", 1, tag=61)
    assert reborn.recv_obj(0, tag=61) == "next"


_WORLD = r'''
import os, sys, time
import torch
from chainermn_torch import create_communicator
from chainermn_torch.comm import object_plane
from chainermn_torch.comm.object_plane import JobAbortedError

object_plane._KV_CHUNK = 1000            # several chunks a message
comm = create_communicator("naive", device="cpu")
r, n = comm.rank, comm.size
op = comm.object_plane
assert op.allgather_obj(("a", r)) == [("a", i) for i in range(n)]
assert op.bcast_obj({"root": r} if r == 1 else None, root=1) == {"root": 1}
g = op.gather_obj(r * 10, root=2)
assert g == ([0, 10, 20] if r == 2 else None), g
assert op.scatter_obj([f"s{i}" for i in range(n)] if r == 0 else None) \
    == f"s{r}"
# around the ring: every rank sends before it receives
big = bytes(range(256)) * 20
op.send_obj((r, big), (r + 1) % n, tag=3)
src, data = op.recv_obj((r - 1) % n, tag=3)
assert src == (r - 1) % n and data == big
# a bounded receive that misses keeps its slot
try:
    op.try_recv_obj((r - 1) % n, tag=9, timeout_ms=50)
    raise AssertionError("nothing was sent")
except TimeoutError:
    pass
comm.host_barrier()         # every rank's miss is behind it
op.send_obj("late", (r + 1) % n, tag=9)
assert op.try_recv_obj((r - 1) % n, tag=9, timeout_ms=20000) == "late"
# a sub-communicator's plane has keys of its own
sub = comm.split(r % 2, r)
assert sub.object_plane.allgather_obj(r) == [i for i in range(n)
                                            if i % 2 == r % 2]
sub.host_barrier()
comm.host_barrier()
t0 = time.monotonic()
if r == 1:
    # rank 1 gives up instead of reaching the barrier
    object_plane.post_abort("rank 1 gives up")
    print(f"RANK{r} OK", flush=True)
    os._exit(0)
try:
    comm.host_barrier(timeout_ms=60000)
    raise AssertionError("the barrier passed without rank 1")
except JobAbortedError as e:
    took = time.monotonic() - t0
    assert "rank 1 gives up" in str(e) and took < 5, (took, e)
    print(f"RANK{r} OK abort seen after {took:.2f} s", flush=True)
# rank 0 hosts the store: it leaves after rank 2 has read the abort
store = object_plane._client()
if r == 2:
    store.set("rank2/done", "1")
else:
    import datetime
    store.wait(["rank2/done"], datetime.timedelta(seconds=30))
os._exit(0)
'''


def test_the_plane_in_a_three_rank_world():
    os.environ["CHAINERMN_TPU_RPC_PROBE_MS"] = "200"
    try:
        res = run_world(_WORLD, 3, 60)
    finally:
        del os.environ["CHAINERMN_TPU_RPC_PROBE_MS"]
    for rank, (rc, out) in enumerate(res):
        assert f"RANK{rank} OK" in out, f"rank {rank} exited {rc}:\n" + \
            out[-3000:]
    assert res[0][0] == 0 and res[2][0] == 0


_STORE_HOST_DIES = r'''
import os, time
from chainermn_torch import create_communicator

comm = create_communicator("naive", device="cpu")
comm.host_barrier()
if comm.rank == 0:
    os._exit(0)             # the store's host is gone
t0 = time.monotonic()
try:
    comm.host_barrier()
except RuntimeError as e:
    took = time.monotonic() - t0
    assert "unreachable" in str(e) and took < 10, (took, e)
    print(f"RANK1 OK store loss raised after {took:.2f} s", flush=True)
os._exit(0)
'''


def test_a_dead_store_host_fails_the_survivors_waits():
    (_, out0), (rc1, out1) = run_world(_STORE_HOST_DIES, 2, 40)
    assert rc1 == 0 and "RANK1 OK" in out1, out1[-3000:]


_STORE_HOST_DIES_MID_ADD = r'''
import os, time
from chainermn_torch import create_communicator

comm = create_communicator("naive", device="cpu")
comm.host_barrier()
if comm.rank == 0:
    os._exit(0)             # the store's host is gone
# the barrier's first store call (its add) waits until the host is
# surely gone: the race the raw transport error came from, every time
os.environ["CHAINERMN_TPU_CHAOS"] = "delay_rpc@op=barrier,ms=1500"
t0 = time.monotonic()
try:
    comm.host_barrier()
except RuntimeError as e:
    took = time.monotonic() - t0
    assert "unreachable" in str(e) and took < 10, (took, type(e), e)
    print(f"RANK1 OK store loss raised after {took:.2f} s", flush=True)
os._exit(0)
'''


def test_a_store_lost_inside_the_barriers_add_raises_the_planes_error():
    """Rank 1 reaches ``_barrier``'s ``add`` only after rank 0 (the
    store's host) has exited: the plane's "store unreachable" error, not
    the transport's, within 10 s."""
    (_, out0), (rc1, out1) = run_world(_STORE_HOST_DIES_MID_ADD, 2, 40)
    assert rc1 == 0 and "RANK1 OK" in out1, out1[-3000:]


_HOOK = r'''
import os, sys, time
from chainermn_torch import create_communicator
from chainermn_torch.comm.object_plane import JobAbortedError
from chainermn_torch.extensions import install_global_except_hook

comm = create_communicator("naive", device="cpu")
install_global_except_hook(comm)
comm.host_barrier()
if comm.rank == 1:
    raise RuntimeError("boom on rank 1")
try:
    comm.object_plane.recv_obj(1, tag=1)
except JobAbortedError as e:
    assert "boom on rank 1" in str(e), e
    print("RANK0 OK", flush=True)
os._exit(0)
'''


def test_the_except_hook_posts_the_abort_key():
    os.environ["CHAINERMN_TPU_RPC_PROBE_MS"] = "200"
    try:
        (rc0, out0), (rc1, out1) = run_world(_HOOK, 2, 40)
    finally:
        del os.environ["CHAINERMN_TPU_RPC_PROBE_MS"]
    assert rc1 == 13 and "aborting job" in out1, out1[-3000:]
    assert rc0 == 0 and "RANK0 OK" in out0, out0[-3000:]


def test_one_rank_needs_no_store():
    code = ("from chainermn_torch.comm.object_plane import ObjectPlane\n"
            "p = ObjectPlane()\n"
            "assert p.allgather_obj(5) == [5] and p.bcast_obj(1) == 1\n"
            "p.barrier()\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]
