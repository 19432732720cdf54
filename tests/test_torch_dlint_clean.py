"""The port's own files must stay clean under the port's dlint: a new
rank-divergent collective, tag collision, wrong-space root, unsynced step
loop, divergent call chain, send/recv cycle, lock inversion, blocking
wait under a lock or key reuse anywhere in ``chainermn_torch/``, the
port's tests, ``chip_smoke.py`` or the port's scripts at the repo's root
fails here, as ``tests/analysis_tests/test_repo_clean.py`` holds the JAX
package to its own.

One in-process run feeds the findings, dead-suppression and rationale
checks; one CLI run covers the SARIF, committed-baseline and time-budget
workflow end to end.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import json
import os
import subprocess
import sys

import pytest

from chainermn_torch.analysis import run_lint
from chainermn_torch.tools.dlint import BASELINE, BUDGET, port_paths

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the whole-program rules: a suppression of one claims a property of
#: the whole program does not hold at that site, so it states why
_PROJECT_RULES = {"DL113", "DL114", "DL115", "DL116", "DL118", "DL120",
                  "DL121", "DL125"}


@pytest.fixture(scope="module")
def port_run():
    return run_lint(port_paths(_REPO))


def test_the_port_is_lint_clean_in_process(port_run):
    assert port_run.findings == [], "\n" + "\n".join(
        f.format() for f in port_run.findings)


def test_the_port_has_no_dead_suppressions(port_run):
    dead = port_run.dead_suppressions
    assert dead == [], "\n" + "\n".join(s.format() for s in dead)
    # the run saw the port's package, its tests and the smoke
    paths = {os.path.relpath(s.path, _REPO) for s in port_run.suppressions}
    assert "chip_smoke.py" in paths
    assert any(p.startswith("chainermn_torch/") for p in paths)


def test_project_rule_suppressions_carry_rationales(port_run):
    bare = []
    for s in port_run.suppressions:
        if not (s.rules & _PROJECT_RULES):
            continue
        with open(s.path, encoding="utf-8") as fh:
            line = fh.read().splitlines()[s.line - 1]
        marker_to_eol = line[line.index("# dlint"):]
        rules_part = ",".join(sorted(s.rules))
        if len(marker_to_eol) <= len(f"# dlint: disable={rules_part}") + 3:
            bare.append(s.format())
    assert bare == [], "suppressions missing a rationale:\n" \
        + "\n".join(bare)


def test_dlint_cli_all_sarif_baseline_exits_zero(tmp_path):
    """``--all --format sarif --baseline <the port's> --report-suppressions
    --timings`` exits 0 with valid SARIF 2.1.0 and no result, inside the
    port's recorded budget."""
    timings_file = tmp_path / "timings.json"
    proc = subprocess.run(
        [sys.executable, "-m", "chainermn_torch.tools.dlint",
         "--all", "--format", "sarif", "--baseline", BASELINE,
         "--report-suppressions", "--timings", str(timings_file)],
        capture_output=True, text=True, timeout=300, cwd=_REPO)
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-2000:])
    log = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert log["version"] == "2.1.0"
    (run,) = log["runs"]
    assert run["tool"]["driver"]["name"] == "dlint"
    assert run["results"] == []
    meta = {r["id"]: r for r in run["tool"]["driver"]["rules"]}
    assert {"DL113", "DL114", "DL115", "DL116", "DL118", "DL120", "DL121",
            "DL125", "DL201", "DL202"} <= set(meta)
    assert meta["DL108"]["properties"]["applicable"] is False
    sups = run["properties"]["suppressions"]
    assert sups and all(s["hits"] > 0 for s in sups)

    timings = json.loads(timings_file.read_text())
    with open(BUDGET) as fh:
        budget = json.load(fh)["all_seconds"]
    assert timings["total_seconds"] < budget, (
        f"full --all run took {timings['total_seconds']}s, budget is "
        f"{budget}s — slowest passes: "
        + str(sorted(timings["passes"].items(),
                     key=lambda kv: -kv[1])[:5]))
    assert {"DL118", "DL120", "DL121", "DL125"} <= set(timings["passes"])


def test_dlint_cli_reports_seeded_violation(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import torch.distributed as dist\n"
        "def f(comm):\n"
        "    if comm.rank == 0:\n"
        "        dist.new_group([0, 1])\n")
    proc = subprocess.run(
        [sys.executable, "-m", "chainermn_torch.tools.dlint", str(bad)],
        capture_output=True, text=True, timeout=120, cwd=_REPO)
    assert proc.returncode == 1
    assert f"{bad}:4: DL101" in proc.stdout


def test_dlint_cli_rejects_unknown_and_jax_only_rules():
    for rule in ("DL999", "DL108"):
        proc = subprocess.run(
            [sys.executable, "-m", "chainermn_torch.tools.dlint",
             "--rules", rule, "--all"],
            capture_output=True, text=True, timeout=120, cwd=_REPO)
        assert proc.returncode == 2
        assert rule in proc.stderr
