"""dlint core for the port: findings, the rule registry, suppressions,
and the driver.

Counterpart of ``chainermn_tpu/analysis/core.py``, kept as the port's own
copy (standard library only, so a lint of sources stays a bare-AST run).
Three pass shapes share one registry:

* **AST passes** (``kind="ast"``) — ``(tree, src, path) ->
  list[Finding]``, run per file with zero cross-module visibility;
* **project passes** (``kind="project"``) — ``(Project) ->
  list[Finding]``, run ONCE over a :class:`~.callgraph.Project` built
  from every parsed file in the run, for the interprocedural rules
  (DL113–DL116). ``lint_source`` builds a single-file project so
  in-string fixtures exercise them too;
* **trace passes** (``kind="trace"``) — registered for the catalogue
  only; they read a ``torch.profiler`` Chrome trace taken on the card
  (:mod:`.trace_passes`), not source files.

The rules of the JAX package that have no port form are not registered:
:data:`NOT_APPLICABLE` names each with its reason,
:data:`NOT_YET_PORTED` the trace passes still to write (none now), and
``chainermn_torch/tools/dlint.py --list-rules`` prints them beside the
registered ones.

The driver parses each file once, collects ``# dlint: disable=RULE``
comments from the token stream (so string literals containing the
marker cannot suppress anything), runs every requested pass, and drops
suppressed findings. A disable comment covers:

* its own line and the line below (the trailing-comment and
  comment-above idioms), and
* when it sits on the FIRST line of a statement — where "first"
  includes a decorator line — the statement's whole ``end_lineno``
  range, so one disable on a ``def``/``with``/multi-line call
  suppresses findings anchored anywhere inside it.

Every suppression records how many findings it absorbed;
:func:`run_lint` returns them so ``python -m chainermn_torch.tools.dlint
--report-suppressions`` can list the dead ones (zero hits) before they
rot.
"""

from __future__ import annotations

import ast
import io
import os
import re
import time
import tokenize
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# matches ``dlint: disable=DL101``, ``disable=DL101,DL104``, and
# ``disable=all`` comment markers (hash prefix implied by the token)
_DISABLE_RE = re.compile(r"#\s*dlint:\s*disable=([\w,\s]+)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str          # stable ID, e.g. "DL101"
    path: str          # file the finding is in
    line: int          # 1-indexed line of the offending node
    message: str       # what is wrong + the fix-it, citing docs

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclass
class Rule:
    """Registry entry: a pass plus its catalogue metadata."""

    rule_id: str
    name: str
    doc: str           # docs/static_analysis_torch.md anchor
    check: Callable    # (tree, src, path) | (Project) -> List[Finding]
    kind: str = "ast"  # "ast" | "project" | "trace"


#: rule_id -> Rule. AST and project passes register themselves on import
#: (see :mod:`.ast_passes` / :mod:`.sequence` / :mod:`.locks`); trace
#: rules register metadata only — they run on a ``torch.profiler`` trace
#: via :mod:`.trace_passes`, not on source files.
RULES: Dict[str, Rule] = {}

_DOC = "docs/static_analysis_torch.md"

#: rule_id -> (name, reason) for the rules of the JAX package's catalogue
#: whose hazard cannot arise in the port; they are not registered
NOT_APPLICABLE: Dict[str, Tuple[str, str]] = {
    "DL108": ("decode-step-recompile",
              "the port compiles nothing: no jit, no torch.compile and no "
              "CUDA graph, so a loop cannot rebuild an executable"),
    "DL119": ("use-after-donation",
              "nothing in the port donates a buffer (no donate_argnums)"),
    "DL122": ("trace-count-instability",
              "nothing is traced: Python branches on tensor values run "
              "eagerly, once per call, and retrace nothing"),
}

#: rule_id -> (name, what it needs) for a JAX HLO pass whose trace
#: counterpart is still to be written; every one is ported (DL201-DL205
#: are :mod:`.trace_passes`), so the table is empty
NOT_YET_PORTED: Dict[str, Tuple[str, str]] = {}


def register(rule: Rule) -> Rule:
    if rule.rule_id in RULES:
        raise ValueError(f"duplicate dlint rule id {rule.rule_id}")
    RULES[rule.rule_id] = rule
    return rule


def _load_passes() -> None:
    """Import every pass module so the registry is complete no matter
    which entry point ran first."""
    from chainermn_torch.analysis import ast_passes  # noqa: F401
    from chainermn_torch.analysis import dataflow_rules  # noqa: F401
    from chainermn_torch.analysis import locks  # noqa: F401
    from chainermn_torch.analysis import sequence  # noqa: F401
    from chainermn_torch.analysis import trace_passes  # noqa: F401


@dataclass
class Suppression:
    """One ``# dlint: disable=...`` comment and what it absorbed."""

    path: str
    line: int               # line the comment is on
    rules: set              # rule IDs it disables ({"all"} = wildcard)
    start: int              # first finding line it covers
    end: int                # last finding line it covers (inclusive)
    hits: int = 0           # findings it suppressed in this run

    def covers(self, f: Finding) -> bool:
        return (self.start <= f.line <= self.end
                and (f.rule in self.rules or "all" in self.rules))

    def format(self) -> str:
        rules = ",".join(sorted(self.rules))
        return f"{self.path}:{self.line}: disable={rules}"


@dataclass
class LintRun:
    """Everything one driver invocation produced."""

    findings: List[Finding] = field(default_factory=list)
    suppressions: List[Suppression] = field(default_factory=list)
    #: wall-clock seconds per pass ("DL113", …) plus the fixed-cost
    #: phases ("parse", "project-build") — the CLI's ``--timings``
    #: serializes this so CI can watch the verify-budget headroom
    timings: Dict[str, float] = field(default_factory=dict)

    @property
    def dead_suppressions(self) -> List[Suppression]:
        return [s for s in self.suppressions if s.hits == 0]


def suppressed_lines(src: str) -> Dict[int, set]:
    """line -> set of rule IDs disabled there (``{"all"}`` disables all).

    Read from the TOKEN stream, not a regex over raw lines: a string
    literal that happens to contain the marker (e.g. this module's own
    docstrings, or a test fixture embedded as a string) must not
    suppress anything.
    """
    out: Dict[int, set] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(src).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _DISABLE_RE.search(tok.string)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                out.setdefault(tok.start[0], set()).update(rules)
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return out


def _statement_ranges(tree: ast.AST) -> Dict[int, int]:
    """first-line -> last end_lineno of any statement starting there.

    "First line" counts decorators: a disable on the ``@decorator``
    line of a decorated def covers the whole def. When several nested
    statements start on one line (``if x: y()``), the outermost —
    largest — range wins, which is the direction suppression should
    err in: the comment visibly sits on that whole construct.
    """
    ranges: Dict[int, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.stmt):
            continue
        first = node.lineno
        for dec in getattr(node, "decorator_list", None) or []:
            first = min(first, dec.lineno)
        end = getattr(node, "end_lineno", None) or node.lineno
        if end > ranges.get(first, 0):
            ranges[first] = end
    return ranges


def collect_suppressions(src: str, path: str,
                         tree: Optional[ast.AST] = None
                         ) -> List[Suppression]:
    disables = suppressed_lines(src)
    if not disables:
        return []
    ranges = _statement_ranges(tree) if tree is not None else {}
    out = []
    for line in sorted(disables):
        # own line + line below (legacy), widened to the full range of
        # a statement whose first line carries (or sits under) it
        end = max(line + 1, ranges.get(line, 0), ranges.get(line + 1, 0))
        out.append(Suppression(path, line, disables[line], line, end))
    return out


def _apply_suppressions(findings: List[Finding],
                        sups: Dict[str, List[Suppression]]
                        ) -> List[Finding]:
    kept: List[Finding] = []
    for f in findings:
        hit = None
        for s in sups.get(f.path, ()):
            if s.covers(f):
                hit = s
                break
        if hit is not None:
            hit.hits += 1
        else:
            kept.append(f)
    return kept


def run_lint_sources(sources: Dict[str, str],
                     rules: Optional[Sequence[str]] = None) -> LintRun:
    """The driver: run AST passes per file and project passes over the
    whole set. ``sources``: path -> source text."""
    _load_passes()
    from chainermn_torch.analysis.callgraph import Project

    run = LintRun()
    findings: List[Finding] = []
    sups: Dict[str, List[Suppression]] = {}
    parsed: Dict[str, Tuple[ast.AST, str]] = {}
    timings = run.timings
    for path in sorted(sources):
        src = sources[path]
        t0 = time.perf_counter()
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            findings.append(Finding(
                "DL000", path, e.lineno or 1,
                f"syntax error blocks analysis: {e.msg}"))
            sups[path] = collect_suppressions(src, path)
            continue
        finally:
            timings["parse"] = timings.get("parse", 0.0) \
                + time.perf_counter() - t0
        parsed[path] = (tree, src)
        sups[path] = collect_suppressions(src, path, tree)
        for rule in RULES.values():
            if rule.kind != "ast":
                continue
            if rules is not None and rule.rule_id not in rules:
                continue
            t0 = time.perf_counter()
            findings.extend(rule.check(tree, src, path))
            timings[rule.rule_id] = timings.get(rule.rule_id, 0.0) \
                + time.perf_counter() - t0

    project_rules = [r for r in RULES.values() if r.kind == "project"
                     and (rules is None or r.rule_id in rules)]
    if project_rules and parsed:
        t0 = time.perf_counter()
        project = Project.build(parsed)
        timings["project-build"] = time.perf_counter() - t0
        for rule in project_rules:
            t0 = time.perf_counter()
            findings.extend(rule.check(project))
            timings[rule.rule_id] = time.perf_counter() - t0

    # a call nested under two rank-dependent Ifs can be reported by both
    # evaluations; one report per (rule, path, line) is enough — dedup
    # BEFORE suppression accounting so duplicates don't inflate hits
    findings = sorted(set(findings),
                      key=lambda f: (f.path, f.line, f.rule))
    findings = _apply_suppressions(findings, sups)
    run.findings = findings
    run.suppressions = [s for path in sorted(sups) for s in sups[path]]
    return run


def lint_source(src: str, path: str = "<string>",
                rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the passes over one source string (project passes see a
    single-file project). ``rules`` restricts to the given IDs
    (default: every registered source rule)."""
    return run_lint_sources({path: src}, rules=rules).findings


def lint_file(path: str,
              rules: Optional[Sequence[str]] = None) -> List[Finding]:
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    return lint_source(src, path, rules=rules)


_SKIP_DIRS = {".git", "__pycache__", ".pytest_cache", "build", "dist",
              ".eggs", "node_modules"}


def iter_python_files(roots: Iterable[str]) -> List[str]:
    """Every .py under the given files/directories, sorted, deduped."""
    out = []
    for root in roots:
        if os.path.isfile(root):
            out.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
            for fn in filenames:
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return sorted(set(out))


def run_lint(paths: Iterable[str],
             rules: Optional[Sequence[str]] = None,
             only: Optional[Iterable[str]] = None) -> LintRun:
    """Lint every .py under ``paths``. ``only``, when given, restricts
    REPORTING to those files while the whole-program passes still see
    everything (the ``--changed`` contract: context stays global, the
    gate is local)."""
    sources: Dict[str, str] = {}
    for path in iter_python_files(paths):
        with open(path, encoding="utf-8") as fh:
            sources[path] = fh.read()
    run = run_lint_sources(sources, rules=rules)
    if only is not None:
        keep = {os.path.abspath(p) for p in only}
        run.findings = [f for f in run.findings
                        if os.path.abspath(f.path) in keep]
        run.suppressions = [s for s in run.suppressions
                            if os.path.abspath(s.path) in keep]
    return run


def lint_paths(paths: Iterable[str],
               rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the source passes over every .py file under ``paths``."""
    return run_lint(paths, rules=rules).findings
