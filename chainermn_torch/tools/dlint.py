#!/usr/bin/env python
"""dlint for the port — distributed-correctness lint of ``chainermn_torch``.

Counterpart of the JAX package's ``tools/dlint.py``, with its flags and
its output. Runs the :mod:`chainermn_torch.analysis` source passes — the
per-file AST rules and the whole-program project rules (call-graph
sequence and lock checks, value-level dataflow checks) — and prints one
``path:line: RULE message`` finding per line. Exit status: 0 clean, 1
findings, 2 usage error.

Usage::

    python -m chainermn_torch.tools.dlint --all         # the port's files
    python -m chainermn_torch.tools.dlint chainermn_torch/comm
    python -m chainermn_torch.tools.dlint --rules DL101,DL113 tests/
    python -m chainermn_torch.tools.dlint --list-rules  # catalogue
    python -m chainermn_torch.tools.dlint --all --format sarif
    python -m chainermn_torch.tools.dlint --all \\
        --baseline chainermn_torch/tools/dlint_baseline.json
    python -m chainermn_torch.tools.dlint --all --write-baseline FILE
    python -m chainermn_torch.tools.dlint --changed     # files in the diff
    python -m chainermn_torch.tools.dlint --all --report-suppressions
    python -m chainermn_torch.tools.dlint --all --timings timings.json
    python -m chainermn_torch.tools.dlint --trace trace.json

``--all`` means the port's files: ``chainermn_torch/``, the port's tests
(``tests/test_torch_*.py``, ``tests/torch_threads.py``), ``chip_smoke.py``
and the port's scripts at the repo's root (:data:`REPO_FILES`).
``--timings`` records per-pass wall time; the port's tests compare a full
``--all`` run against ``dlint_budget.json`` beside this file.
``--baseline`` gates on NEW findings only (fingerprints in JAX's format).
``--changed [REF]`` lints only the port's files changed vs REF (default
HEAD) while the whole-program passes still see every root.

The trace passes (DL201-DL205) take a ``torch.profiler`` Chrome trace,
not source files: call them through
:mod:`chainermn_torch.analysis.trace_passes`, or point ``--trace FILE``
at a saved trace to run the argument-free ones (DL201, DL203, DL204,
DL205; DL202 needs a budget), each of which prints one JSON line; a
failed check counts as a finding.

Suppress an intentional finding with ``# dlint: disable=RULE —
rationale`` on the flagged line, the line above, or the first line of
the enclosing statement; ``--report-suppressions`` lists the ones that
absorbed nothing. ``tests/test_torch_dlint_clean.py`` keeps the port
clean.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

#: what --all means: the port's package, then its files outside it
REPO_ROOTS = ("chainermn_torch",)
REPO_FILES = ("tests/test_torch_*.py", "tests/torch_threads.py",
              "chip_smoke.py", "chip_smoke_times.py", "ce_f32_traffic.py",
              "flash_bwd_f32_probe.py", "fsdp_profile.py",
              "fsdp_lamb_oracle.py", "serve_greedy_probe.py")

HERE = os.path.dirname(os.path.abspath(__file__))
BASELINE = os.path.join(HERE, "dlint_baseline.json")
BUDGET = os.path.join(HERE, "dlint_budget.json")


def port_paths(repo: str = REPO):
    """The files and directories ``--all`` lints, those that exist."""
    paths = [os.path.join(repo, r) for r in REPO_ROOTS
             if os.path.isdir(os.path.join(repo, r))]
    for pattern in REPO_FILES:
        paths.extend(sorted(glob.glob(os.path.join(repo, pattern))))
    return paths


def _changed_files(repo: str, ref: str, roots):
    """The port's Python files changed vs ``ref`` (committed, staged and
    unstaged), absolute paths, existing files only."""
    out = subprocess.run(
        ["git", "diff", "--name-only", ref, "--"],
        cwd=repo, capture_output=True, text=True, check=True).stdout
    from chainermn_torch.analysis import iter_python_files

    ours = {os.path.abspath(p) for p in iter_python_files(roots)}
    files = []
    for line in out.splitlines():
        path = os.path.abspath(os.path.join(repo, line.strip()))
        if path.endswith(".py") and path in ours and os.path.isfile(path):
            files.append(path)
    return sorted(set(files))


def _list_rules(RULES, NOT_APPLICABLE, NOT_YET_PORTED):
    rows = [(rid, f"{rid}  [{r.kind}]  {r.name}  ({r.doc})")
            for rid, r in RULES.items()]
    rows += [(rid, f"{rid}  [n/a]  {name}  — not applicable: {why}")
             for rid, (name, why) in NOT_APPLICABLE.items()]
    rows += [(rid, f"{rid}  [trace, to port]  {name}  — {why}")
             for rid, (name, why) in NOT_YET_PORTED.items()]
    for _, row in sorted(rows):
        print(row)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="dlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", help="files or directories to lint")
    ap.add_argument("--all", action="store_true",
                    help="lint the port's files: "
                         + ", ".join(REPO_ROOTS + REPO_FILES))
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule IDs to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    ap.add_argument("--format", dest="fmt", default="text",
                    choices=("text", "sarif"),
                    help="finding output format (default: text)")
    ap.add_argument("--baseline", metavar="FILE", default=None,
                    help="gate only on findings NOT fingerprinted in "
                         "this baseline file")
    ap.add_argument("--write-baseline", metavar="FILE", default=None,
                    help="record the run's findings as the new "
                         "baseline and exit 0")
    ap.add_argument("--changed", nargs="?", const="HEAD", default=None,
                    metavar="REF",
                    help="report only files changed vs REF (default "
                         "HEAD); whole-program passes still see every "
                         "root")
    ap.add_argument("--report-suppressions", action="store_true",
                    help="list '# dlint: disable' comments that "
                         "suppressed zero findings (exit 1 if any)")
    ap.add_argument("--timings", metavar="FILE", default=None,
                    help="write per-pass wall-time JSON to FILE "
                         "('-' for stderr)")
    ap.add_argument("--trace", metavar="FILE", default=None,
                    help="also run the argument-free trace passes "
                         "(DL201, DL203, DL204, DL205) on a "
                         "torch.profiler Chrome trace")
    args = ap.parse_args(argv)

    from chainermn_torch.analysis import (NOT_APPLICABLE, NOT_YET_PORTED,
                                          RULES, filter_new, load_baseline,
                                          run_lint, to_sarif,
                                          write_baseline)

    if args.list_rules:
        _list_rules(RULES, NOT_APPLICABLE, NOT_YET_PORTED)
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            print(f"dlint: unknown rule(s): {', '.join(unknown)}",
                  file=sys.stderr)
            return 2

    only = None
    if args.changed is not None:
        paths = port_paths()
        try:
            only = _changed_files(REPO, args.changed, paths)
        except subprocess.CalledProcessError as e:
            print(f"dlint: git diff failed: {e.stderr.strip()}",
                  file=sys.stderr)
            return 2
    elif args.all:
        paths = port_paths()
    else:
        paths = args.paths
    if not paths and not args.trace:
        ap.print_usage(sys.stderr)
        print("dlint: give paths, --all, --changed, or --trace FILE",
              file=sys.stderr)
        return 2

    t_run = time.perf_counter()
    run = run_lint(paths, rules=rules, only=only) if paths else None
    t_run = time.perf_counter() - t_run
    findings = run.findings if run is not None else []

    if args.timings and run is not None:
        payload = {
            "total_seconds": round(t_run, 3),
            "passes": {k: round(v, 4)
                       for k, v in sorted(run.timings.items())},
        }
        text = json.dumps(payload, indent=2, sort_keys=True) + "\n"
        if args.timings == "-":
            sys.stderr.write(text)
        else:
            with open(args.timings, "w", encoding="utf-8") as fh:
                fh.write(text)

    if args.write_baseline:
        write_baseline(args.write_baseline, findings, root=REPO)
        print(f"dlint: baseline written to {args.write_baseline} "
              f"({len(findings)} finding(s))", file=sys.stderr)
        return 0

    gated = findings
    if args.baseline:
        try:
            known = load_baseline(args.baseline)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"dlint: cannot read baseline: {e}", file=sys.stderr)
            return 2
        gated = filter_new(findings, known, root=REPO)

    if args.fmt == "sarif":
        sups = run.suppressions if run is not None else None
        print(json.dumps(to_sarif(gated, root=REPO, suppressions=sups),
                         indent=2, sort_keys=True))
    else:
        for f in gated:
            print(f.format())

    dead = run.dead_suppressions if run is not None else []
    if args.report_suppressions:
        for s in dead:
            print(f"dead suppression: {s.format()}")
        if not dead:
            print("dlint: no dead suppressions", file=sys.stderr)

    trace_bad = 0
    if args.trace:
        from chainermn_torch.analysis import trace_passes

        for check in (trace_passes.check_dp_overlap,
                      trace_passes.check_pipeline_permute_overlap,
                      trace_passes.check_fsdp_gather_liveness,
                      trace_passes.check_quantized_wire_dtype):
            out = check(args.trace)
            if rules is None or out["rule"] in rules:
                print(json.dumps(out, sort_keys=True))
                if out["ok"] is False:
                    trace_bad += 1

    n = len(gated) + trace_bad
    if args.report_suppressions:
        n += len(dead)
    if n:
        print(f"dlint: {n} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
