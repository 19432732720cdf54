"""The JAX package's offline snapshot tool (``tools/ckpt.py``, numpy
only) on the port's snapshots: a two-rank FSDP file set whose ring
replicas the ``PeerReplicator`` wrote, read with ``inspect``, ``verify``
and ``reshard-dry-run`` as the tool reads the JAX package's, unedited.
A damaged file fails ``verify``. The world also runs the serving
plane's ``pull_weights`` (rank 0's weights reach rank 1)."""

import os
import subprocess
import sys

import pytest

from tests.test_torch_mp import REPO, assert_ranks_ok, run_world

_SAVE = r'''
import os, sys
import numpy as np
from chainermn_torch.comm import create_communicator
from chainermn_torch.extensions import create_multi_node_checkpointer
from chainermn_torch.resilience import PeerReplicator
from tests.test_torch_sharded_checkpoint import BATCH, batches, build

comm = create_communicator("pure_nccl", device="cpu")
r, n = comm.rank, comm.size
per = BATCH // n
step, state, manifest = build("fsdp", comm)
ck = create_multi_node_checkpointer("job", comm, path=sys.argv[1])
ck.set_layout(manifest)
rep = PeerReplicator(ck)
for it, (x, y) in enumerate(batches() * 2, 1):
    step(x[r * per:(r + 1) * per], y[r * per:(r + 1) * per])
    if it % 2 == 0:
        ck.save(state.state_dict(), it)
        rep.replicate()
# the serving plane's peer pull rides this world: rank 0's weights
# (bf16 among them) reach every rank as host tensors
import torch
from chainermn_torch.serving.weights import pull_weights
mine = {"w": torch.arange(6.0).reshape(2, 3) + r,
        "h": torch.full((4,), 0.5 + r, dtype=torch.bfloat16)}
got = pull_weights(comm, mine if r == 0 else None, root=0)
assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3)), got
assert got["h"].dtype == torch.bfloat16 and torch.equal(
    got["h"], torch.full((4,), 0.5, dtype=torch.bfloat16)), got
comm.host_barrier()
print(f"RANK{r} OK", flush=True)
os._exit(0)
'''


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt_tool")
    assert_ranks_ok(run_world(_SAVE, 2, timeout=120, args=[str(d)]))
    return os.path.join(str(d), "job")


def _tool(*argv):
    proc = subprocess.run([sys.executable, os.path.join("tools", "ckpt.py"),
                           *argv], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    return proc.returncode, proc.stdout + proc.stderr


def test_the_port_wrote_primaries_and_ring_replicas(job):
    names = set(os.listdir(job))
    for it in (2, 4):
        assert {f"snapshot_iter_{it}.0", f"snapshot_iter_{it}.1"} <= names
    assert set(os.listdir(os.path.join(job, "replicas"))) >= {
        "snapshot_iter_4.0", "snapshot_iter_4.1", "snapshot_iter_4.0.json"}


def test_inspect_reads_a_port_fsdp_snapshot(job):
    rc, out = _tool("inspect", job)
    assert rc == 0, out
    assert "iteration 4: " in out and "world=2" in out, out
    assert "axes={'r': 2}" in out and "layout: fsdp" in out, out
    assert "(replica)" in out, out
    assert "INCOMPLETE" not in out and "complete" in out, out


@pytest.mark.parametrize("iteration", ["2", "4"])
def test_verify_passes_primaries_and_replicas(job, iteration):
    rc, out = _tool("verify", job, "--iteration", iteration)
    assert rc == 0 and "verify: 0 failure(s)" in out, out
    assert out.count(": ok (") >= 2, out


@pytest.mark.parametrize("target", ["r=1", "r=2", "r=4"])
def test_reshard_dry_run_plans_complete_coverage(job, target):
    rc, out = _tool("reshard-dry-run", job, "--target", target)
    assert rc == 0, out
    assert "reshard dry run: iteration 4" in out, out
    assert "INCOMPLETE" not in out and "CANNOT" not in out, out


def test_verify_fails_a_damaged_port_file(job, tmp_path):
    import shutil

    copy = str(tmp_path / "job")
    shutil.copytree(job, copy)
    fn = os.path.join(copy, "snapshot_iter_4.1")
    with open(fn, "rb+") as fh:
        fh.seek(100)
        fh.write(b"\xff" * 16)
    rc, out = _tool("verify", copy, "--iteration", "4")
    assert rc == 1 and "sha256 mismatch" in out, out
