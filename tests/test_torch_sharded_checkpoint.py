"""Sharded checkpoints of the port (``chainermn_torch/extensions/
checkpoint.py``'s sharded leaves, ``chainermn_torch/checkpointing/``)
against the JAX package's.

* Save and reshard: a 4-rank gloo world trains the MLP (784-16-16-10)
  for 2 steps through FSDP (Adam), ZeRO-1 flat with int8-block error
  feedback (Adam) and ZeRO-1 bucketed (SGD with momentum) and saves each
  state through ``MultiNodeCheckpointer`` (one file a rank, its own
  pieces only, ``set_layout`` manifests); the same world restores them
  into fresh steps, a 2-rank world and one process restore them through
  ``reshard_state``. Every restored leaf, assembled from the ranks'
  pieces by global index, equals the saved one bit for bit; the
  error-feedback frame regroups from 4 rows to 2 and 1 as
  ``ef_frame_regroup`` does (pairs averaged), its mean kept. A state of
  another model is refused; a sharded leaf without a template comes back
  as its own piece on the saving world and is refused on another.
* The helpers equal JAX's on the same arrays: ``ef_frame_regroup``,
  ``default_leaf_resharder``, ``leaf_coverage`` (on the 4 ranks' files).
* The asynchronous plane: its files equal a synchronous save's bit for
  bit; ``skip`` drops and counts a save while the queue is full,
  ``block`` stalls until the writer frees it; ``drain`` honours its
  deadline; a writer's error surfaces on ``flush``; ``CheckpointReport``
  puts JAX's ``ckpt/*`` keys.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import os
import pickle
import threading
import time
import types

import numpy as np
import pytest
import torch

from chainermn_torch.checkpointing import AsyncSnapshotPlane
from chainermn_torch.checkpointing import reshard as tr
from chainermn_torch.comm import create_communicator
from chainermn_torch.extensions import (ShardedLeaf,
                                        create_multi_node_checkpointer,
                                        read_manifest)
from chainermn_torch.extensions.checkpoint import _flatten
from chainermn_torch.training import CheckpointReport
from tests.test_torch_mp import assert_ranks_ok, run_world

UNITS, STEPS, BATCH = 16, 2, 8
KINDS = ("fsdp", "zero-flat-ef", "zero-bucketed")


def batches():
    rs = np.random.RandomState(7)
    return [(rs.rand(BATCH, 784).astype(np.float32),
             rs.randint(0, 10, size=BATCH).astype(np.int32))
            for _ in range(STEPS)]


def build(kind, comm):
    """A fresh step of ``kind`` on ``comm`` (the same seeded model on
    every rank): ``(step, state, layout manifest)``."""
    from chainermn_torch.collectives import QuantizedReducer
    from chainermn_torch.models import MLP
    from chainermn_torch.optimizers import (fsdp_layout_manifest,
                                            make_fsdp_train_step,
                                            make_zero1_train_step,
                                            zero_layout_manifest)

    torch.manual_seed(0)
    model = MLP(n_units=UNITS, device="cpu")
    adam = lambda ps: torch.optim.Adam(ps, lr=1e-3)  # noqa: E731
    if kind == "fsdp":
        manifest = fsdp_layout_manifest(model, comm)
        step, state = make_fsdp_train_step(model, adam, comm)
    elif kind == "zero-flat-ef":
        manifest = zero_layout_manifest(model, comm)
        step, state = make_zero1_train_step(
            model, adam, comm, grad_reducer=QuantizedReducer(
                comm, wire_format="int8-block"))
    else:
        manifest = zero_layout_manifest(model, comm, 4096)
        step, state = make_zero1_train_step(
            model, lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
            comm, bucket_bytes=4096)
    return step, state, manifest


def pieces(state):
    """A state dict's leaves (its layout's manifest aside) as host
    values: ``("sharded", local, gshape, index)`` or ``("whole",
    value)``."""
    leaves = []
    sd = state.state_dict()
    del sd["layout"]
    _flatten(sd, leaves)
    out = []
    for leaf in leaves:
        if isinstance(leaf, ShardedLeaf):
            out.append(("sharded", leaf.local.detach().numpy().copy(),
                        leaf.gshape, leaf.index))
        else:
            out.append(("whole", np.array(
                leaf.detach().numpy() if torch.is_tensor(leaf) else leaf)))
    return out


def run(mode, comm, path):
    """This rank's part of ``mode``: ``save`` trains and saves each kind,
    then restores it into a fresh step; ``restore`` restores only."""
    from chainermn_torch.checkpointing import reshard_state

    r, n = comm.rank, comm.size
    per = BATCH // n
    res = {}
    for kind in KINDS:
        ck = create_multi_node_checkpointer(kind, comm, path=path)
        if mode == "save":
            step, state, manifest = build(kind, comm)
            for x, y in batches():
                m = step(x[r * per:(r + 1) * per], y[r * per:(r + 1) * per])
                assert np.isfinite(float(m["main/loss"]))
            ck.set_layout(manifest)
            ck.save(state.state_dict(), STEPS)
            res[kind + "/saved"] = pieces(state)
        _, state, _ = build(kind, comm)
        restored, it = reshard_state(ck, state.state_dict(template=True))
        assert it == STEPS, it
        state.load_state_dict(restored)
        res[kind] = pieces(state)
    return res


_WORKER = r'''
import os, pickle, sys
from chainermn_torch.comm import create_communicator
from tests.test_torch_sharded_checkpoint import run
mode, path = sys.argv[1], sys.argv[2]
comm = create_communicator("pure_nccl", device="cpu")
res = run(mode, comm, path)
comm.finalize()
with open(os.path.join(path, f"{mode}{comm.size}.rank{comm.rank}.pkl"),
          "wb") as f:
    pickle.dump(res, f)
print(f"RANK{comm.rank} OK", flush=True)
'''


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sharded"))
    assert_ranks_ok(run_world(_WORKER, 4, timeout=240, args=["save", d]))
    assert_ranks_ok(run_world(_WORKER, 2, timeout=240,
                              args=["restore", d]))
    out = {4: [pickle.load(open(os.path.join(d, f"save4.rank{r}.pkl"),
                                "rb")) for r in range(4)],
           2: [pickle.load(open(os.path.join(d, f"restore2.rank{r}.pkl"),
                                "rb")) for r in range(2)]}
    comm = create_communicator("pure_nccl", device="cpu")
    try:
        out[1] = [run("restore", comm, d)]
    finally:
        comm.finalize()
    return d, out


def assemble(ranks):
    """Each leaf whole, from every rank's pieces (whole leaves must agree
    across ranks; sharded pieces must tile their leaf)."""
    full = []
    for i in range(len(ranks[0])):
        kind = ranks[0][i][0]
        if kind == "whole":
            for rk in ranks[1:]:
                np.testing.assert_array_equal(rk[i][1], ranks[0][i][1])
            full.append(ranks[0][i][1])
            continue
        gshape = ranks[0][i][2]
        buf = np.zeros(gshape, ranks[0][i][1].dtype)
        seen = np.zeros(gshape, np.int64)
        for rk in ranks:
            _, local, g, index = rk[i]
            assert g == gshape
            sl = tuple(slice(a, b) for a, b in index)
            buf[sl] = local.reshape(buf[sl].shape)
            seen[sl] += 1
        assert (seen == 1).all(), f"leaf {i}: pieces do not tile it"
        full.append(buf)
    return full


def _ef_leaves(kind, ranks):
    """Indices of the error-feedback frame leaves (2-D, a row a rank)."""
    return [i for i, p in enumerate(ranks[0][kind]) if p[0] == "sharded"
            and len(p[2]) == 2 and p[2][0] == len(ranks)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("world", [4, 2, 1])
def test_restore_is_bitwise_onto_four_two_and_one(worlds, kind, world):
    _, out = worlds
    saved = assemble([r[kind + "/saved"] for r in out[4]])
    got = assemble([r[kind] for r in out[world]])
    ef = set(_ef_leaves(kind + "/saved", out[4]))
    assert len(saved) == len(got)
    assert bool(ef) == (kind == "zero-flat-ef")
    for i, (a, b) in enumerate(zip(saved, got)):
        if i in ef:
            # the world-stacked frame regroups: pairs averaged, mean kept
            np.testing.assert_array_equal(b, tr.ef_frame_regroup(a, world))
            # (f32 sums in another grouping: a few ulps of the largest)
            np.testing.assert_allclose(b.mean(0), a.mean(0), rtol=0,
                                       atol=2 ** -20 * np.abs(a).max())
            assert np.abs(a).max() > 0
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"leaf {i}")


def test_each_file_holds_its_own_pieces_and_a_layout_manifest(worlds):
    d, _ = worlds
    fn = os.path.join(d, "fsdp", "snapshot_iter_2.1")
    with np.load(fn) as z:
        keys = set(z.files)
        shard_leaves = [k for k in keys if k.endswith("_nshards")]
        assert shard_leaves and all(int(z[k]) == 1 for k in shard_leaves)
        i = shard_leaves[0].split("_")[1]
        assert {f"leaf_{i}_gshape", f"leaf_{i}_s0", f"leaf_{i}_idx0"} <= keys
    man = read_manifest(fn)
    assert man["layout"]["kind"] == "fsdp" and man["layout"]["n"] == 4
    assert man["world"] == 4 and man["axes"] == {"r": 4}
    assert any(v["nshards"] == 1 for v in man["leaves"].values())
    man = read_manifest(os.path.join(d, "zero-flat-ef",
                                     "snapshot_iter_2.3"))
    assert man["layout"]["kind"] == "zero-flat"
    assert man["layout"]["ef_frames"] == [[4, 13056]]


def test_leaf_coverage_and_manifest_info_equal_jax(worlds):
    from chainermn_tpu.checkpointing import reshard as jr

    d, _ = worlds
    for kind in KINDS:
        files = tr.scan_snapshot_dir(os.path.join(d, kind))[STEPS]
        assert files == jr.scan_snapshot_dir(os.path.join(d, kind))[STEPS]
        mine, want = tr.leaf_coverage(files), jr.leaf_coverage(files)
        assert mine == want
        assert all(rec["covered"] for rec in mine.values())
    ck = types.SimpleNamespace(path=os.path.join(d, "fsdp"),
                               replica_path=os.path.join(d, "fsdp", "r"))
    assert tr.manifest_info(ck, STEPS) == jr.manifest_info(ck, STEPS)
    assert tr.saved_axes(ck, STEPS) == jr.saved_axes(ck, STEPS) == {"r": 4}


def test_a_changed_model_raises(worlds):
    from chainermn_torch.models import MLP
    from chainermn_torch.optimizers import make_fsdp_train_step

    d, _ = worlds
    comm = create_communicator("pure_nccl", device="cpu")
    try:
        _, state = make_fsdp_train_step(
            MLP(n_units=8, device="cpu"),
            lambda ps: torch.optim.Adam(ps, lr=1e-3), comm)
        ck = create_multi_node_checkpointer("fsdp", comm, path=d)
        with pytest.raises(ValueError, match="different model"):
            tr.reshard_state(ck, state.state_dict(template=True))
    finally:
        comm.finalize()


def test_a_sharded_leaf_without_a_template(worlds, tmp_path):
    """On the saving world each rank takes back its own piece (a resume
    whose fresh optimizer has no state yet); on another world there is
    no target to restore onto, and the restore raises."""
    comm = create_communicator("pure_nccl", device="cpu")
    try:
        ck = create_multi_node_checkpointer("own", comm,
                                            path=str(tmp_path))
        piece = torch.arange(6.0).reshape(2, 3)
        ck.save({"w": ShardedLeaf(piece, (4, 3), ((2, 4), (0, 3)))}, 1)
        got, it = ck.maybe_load({})
        assert it == 1 and torch.equal(got["w"].local, piece)
        assert (got["w"].gshape, got["w"].index) == ((4, 3),
                                                     ((2, 4), (0, 3)))
        d, _ = worlds
        _, fresh, _ = build("fsdp", comm)
        ck = create_multi_node_checkpointer("fsdp", comm, path=d)
        with pytest.raises(ValueError, match="template has no leaf"):
            tr.reshard_state(ck, fresh.state_dict())
    finally:
        comm.finalize()


@pytest.mark.parametrize("n_old,n_new", [(8, 2), (4, 1), (2, 8), (4, 4)])
def test_ef_frame_regroup_and_resharder_equal_jax(n_old, n_new):
    from chainermn_tpu.checkpointing import reshard as jr

    rs = np.random.RandomState(n_old * 10 + n_new)
    frame = rs.randn(n_old, 512).astype(np.float32)
    np.testing.assert_array_equal(tr.ef_frame_regroup(frame, n_new),
                                  jr.ef_frame_regroup(frame, n_new))
    ref = types.SimpleNamespace(shape=(n_new, 512))
    a = tr.default_leaf_resharder(0, ref, frame.shape, lambda: frame)
    b = jr.default_leaf_resharder(0, ref, frame.shape, lambda: frame)
    assert (a is None) == (b is None) == (n_old == n_new)
    if a is not None:
        np.testing.assert_array_equal(a, b)
    # a model change is no frame regroup
    ref = types.SimpleNamespace(shape=(n_new, 256))
    assert tr.default_leaf_resharder(0, ref, frame.shape,
                                     lambda: frame) is None
    with pytest.raises(ValueError, match="one world size must divide"):
        tr.ef_frame_regroup(frame, 3)


# -- the asynchronous plane ---------------------------------------------------

@pytest.fixture
def comm():
    c = create_communicator("pure_nccl", device="cpu")
    yield c
    c.finalize()


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(64, 32, generator=g),
            "h": torch.randn(8, generator=g).to(torch.bfloat16),
            "shard": ShardedLeaf(torch.randn(4, 8, generator=g), (8, 8),
                                 ((4, 8), (0, 8))),
            "step": 3}


def test_plane_files_equal_a_synchronous_save(comm, tmp_path):
    sync = create_multi_node_checkpointer("a", comm, path=str(tmp_path))
    sync.save(_state(0), 5, host_state={"it": 5})
    ck = create_multi_node_checkpointer("b", comm, path=str(tmp_path))
    plane = AsyncSnapshotPlane(ck)
    state = _state(0)
    assert plane.save(state, 5, host_state={"it": 5})
    state["w"].add_(1.0)         # the next step, in place
    plane.flush()
    with np.load(os.path.join(sync.path, "snapshot_iter_5.0")) as a, \
            np.load(os.path.join(ck.path, "snapshot_iter_5.0")) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ma = read_manifest(os.path.join(sync.path, "snapshot_iter_5.0"))
    mb = read_manifest(os.path.join(ck.path, "snapshot_iter_5.0"))
    assert ma["leaves"] == mb["leaves"] and ma["world"] == mb["world"]
    assert plane.published == 1 and plane.bytes_last > 64 * 32 * 4
    restored, it = plane.maybe_load({"shard": ShardedLeaf(
        torch.zeros(2, 8), (8, 8), ((6, 8), (0, 8)))})
    assert it == 5 and restored["step"] == 3
    assert torch.equal(restored["shard"].local,
                       _state(0)["shard"].local[2:])
    plane.close()


def _blocked(plane):
    """Hold the plane's writer inside its publish until the returned
    event is set."""
    gate, inside = threading.Event(), threading.Event()
    publish = plane.ck._publish

    def slow(*args, **kwargs):
        inside.set()
        assert gate.wait(30)
        return publish(*args, **kwargs)

    plane.ck._publish = slow
    return gate, inside


def test_plane_skip_and_block_backpressure_and_drain(comm, tmp_path):
    ck = create_multi_node_checkpointer("s", comm, path=str(tmp_path))
    plane = AsyncSnapshotPlane(ck, backpressure="skip")
    gate, inside = _blocked(plane)
    assert plane.save(_state(1), 1)
    assert inside.wait(30)            # the writer holds snapshot 1
    assert plane.save(_state(2), 2)   # queued
    assert not plane.save(_state(3), 3)
    assert plane.skipped == 1 and plane.pending == 2
    assert plane.cadence_last == 1
    assert not plane.drain(time.monotonic() + 0.05)
    gate.set()
    assert plane.drain(time.monotonic() + 30)
    assert plane.published == 2 and plane.pending == 0
    assert plane.latest_common_iteration() == 2
    plane.close()

    ck = create_multi_node_checkpointer("k", comm, path=str(tmp_path))
    plane = AsyncSnapshotPlane(ck, backpressure="block")
    gate, inside = _blocked(plane)
    plane.save(_state(1), 1)
    assert inside.wait(30)
    plane.save(_state(2), 2)
    threading.Timer(0.3, gate.set).start()
    assert plane.save(_state(3), 3)   # stalls until the writer frees
    assert plane.stall_ms_last >= 200 and plane.skipped == 0
    plane.flush()
    assert plane.published == 3
    plane.close()


def test_plane_writer_errors_surface_on_flush(comm, tmp_path):
    ck = create_multi_node_checkpointer("e", comm, path=str(tmp_path))
    plane = AsyncSnapshotPlane(ck)

    def broken(*args, **kwargs):
        raise OSError("disk full")

    ck._publish = broken
    plane.save(_state(0), 1)
    with pytest.raises(RuntimeError, match="disk full"):
        plane.flush()
    plane.close()
    with pytest.raises(ValueError, match="backpressure"):
        AsyncSnapshotPlane(ck, backpressure="drop")


class _Ring:
    """Rank 0 of a two-rank ring whose store-backed plane loops back: what
    it sends to its right neighbour comes back from its left."""

    rank, size = 0, 2
    inter_rank, inter_size = 0, 1

    def __init__(self):
        self.sent = []
        self.object_plane = self

    def barrier(self):
        pass

    def send_obj(self, obj, dest, tag=0):
        assert dest == 1 and tag == 7
        self.sent.append(obj)

    def recv_obj(self, src, tag=0):
        assert src == 1 and tag == 7
        return self.sent[-1]


def test_plane_replicator_writes_a_ring_replica(tmp_path):
    """``AsyncSnapshotPlane(replicator=PeerReplicator(ck))`` runs one ring
    round a save on its writer thread, after the publish: the newest
    verified snapshot goes to the neighbour, whose copy (here this
    rank's own, looped back) lands under ``replicas/`` with its manifest
    and verifies; a round with nothing new sends an empty payload."""
    from chainermn_torch.resilience import PeerReplicator

    ring = _Ring()
    ck = create_multi_node_checkpointer("p", ring, path=str(tmp_path))
    plane = AsyncSnapshotPlane(ck, replicator=PeerReplicator(ck))
    plane.save(_state(1), 3)
    plane.flush()
    primary = os.path.join(ck.path, "snapshot_iter_3.0")
    replica = os.path.join(ck.replica_path, "snapshot_iter_3.0")
    with open(primary, "rb") as a, open(replica, "rb") as b:
        assert a.read() == b.read()
    assert ck._verify_snapshot_file(replica)
    assert ck._replica_iters_on_disk() == [3]
    plane.replicator.replicate()          # nothing new since iteration 3
    assert ring.sent[-1] == {"iteration": None}
    plane.close()


def test_checkpoint_report_and_emergency_save(comm, tmp_path, capsys):
    ck = create_multi_node_checkpointer("r", comm, path=str(tmp_path))
    plane = AsyncSnapshotPlane(ck, max_pending=2)

    class Updater:
        iteration = 4
        state = _state(4)

        def host_state_dict(self):
            return {"it": self.iteration}

    trainer = types.SimpleNamespace(updater=Updater(), observation={})
    plane(trainer)
    plane.flush()
    CheckpointReport(plane)(trainer)
    assert "ckpt plane: backpressure=block max_pending=2 replicator=off" \
        in capsys.readouterr().out
    obs = trainer.observation
    assert set(obs) == {"ckpt/stall_ms", "ckpt/bytes", "ckpt/cadence",
                        "ckpt/pending", "ckpt/published", "ckpt/skipped"}
    assert obs["ckpt/published"] == 1 and obs["ckpt/bytes"] > 0
    assert obs["ckpt/pending"] == 0 and obs["ckpt/skipped"] == 0
    trainer.updater.iteration = 6
    fn = plane.emergency_save(trainer, deadline_s=time.monotonic() + 30)
    assert fn.endswith("snapshot_iter_6.0") and os.path.exists(fn)
    assert ck.load_host_state(6) == {"it": 6}
    plane.close()
