"""A multi-process launcher for the port's tests: ``run_world`` starts a
script as the ranks of one ``torch.distributed`` world on localhost (the
port's counterpart of ``tests/mp_harness.py``, which serves the JAX
package), plus its self-tests."""

import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_world(script: str, n: int, timeout: float,
              args: Sequence[str] = ()) -> List[Tuple[Optional[int], str]]:
    """Run ``script`` (Python source) in ``n`` processes, ranks 0..n-1 of
    one world (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` set; the repo
    on ``PYTHONPATH``; one OpenMP thread each). Returns each rank's
    ``(returncode, stdout and stderr)`` in rank order. A rank still
    running ``timeout`` seconds after the start is killed and reported
    with its output and a note."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "worker.py")
        with open(path, "w") as f:
            f.write(script)
        procs = []
        try:
            for rank in range(n):
                penv = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                            LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n),
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                            PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
                procs.append(subprocess.Popen(
                    [sys.executable, path, *args], env=penv, cwd=REPO,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            deadline = time.monotonic() + timeout
            outs = []
            for p in procs:
                try:
                    out = p.communicate(
                        timeout=max(0.1, deadline - time.monotonic()))[0]
                except subprocess.TimeoutExpired:
                    p.kill()
                    out = (p.communicate()[0]
                           + f"\n[killed after {timeout} s]")
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def assert_ranks_ok(results, marker: str = "OK") -> None:
    """Every rank exited 0 and printed ``RANK<r> <marker>``."""
    for rank, (rc, out) in enumerate(results):
        assert rc == 0 and f"RANK{rank} {marker}" in out, (
            f"rank {rank} exited {rc}:\n{out[-3000:]}")


_SELF_TEST = r'''
import os, sys
import torch
import torch.distributed as dist
dist.init_process_group("gloo", init_method="env://")
rank, size = dist.get_rank(), dist.get_world_size()
assert rank == int(os.environ["RANK"]) and size == int(sys.argv[1])
t = torch.tensor([float(rank)])
dist.all_reduce(t)
assert t.item() == sum(range(size)), t
dist.destroy_process_group()
print(f"RANK{rank} OK", flush=True)
'''


def test_run_world_launches_the_ranks_of_one_world():
    """Three ranks join one gloo world and all-reduce their ranks."""
    assert_ranks_ok(run_world(_SELF_TEST, 3, timeout=60, args=["3"]))


def test_run_world_reports_failing_and_hung_ranks():
    """A rank's exit code comes back, and a rank that outlives the
    timeout is killed and reported, not waited for."""
    script = ("import os, sys, time\n"
              "r = int(os.environ['RANK'])\n"
              "print(f'RANK{r} up', flush=True)\n"
              "time.sleep(60) if r == 2 else sys.exit(3 * r)\n")
    t0 = time.monotonic()
    (rc0, out0), (rc1, out1), (rc2, out2) = run_world(script, 3, timeout=8)
    assert time.monotonic() - t0 < 30
    assert (rc0, rc1) == (0, 3) and "RANK1 up" in out1
    assert rc2 != 0 and "killed after 8 s" in out2
