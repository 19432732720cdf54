"""dlint output layer for the port: SARIF 2.1.0 emission and the findings
baseline.

Counterpart of ``chainermn_tpu/analysis/output.py``, in the same formats:
a baseline or a SARIF log that either package's linter writes reads in
the other's. The port's rule catalogue lists every rule ID of the JAX
package's, the ones it does not register marked ``"applicable": false``
with their reason, so a finding's ``ruleIndex`` is the same in both logs.

**SARIF** — one ``run`` with the full rule catalogue under
``tool.driver.rules`` and one ``result`` per finding, so CI viewers
(GitHub code scanning et al.) render findings inline. Paths are
emitted repo-relative with forward slashes, per the spec's
``uriBaseId`` convention.

**Baseline** — the ratchet that makes a whole-program linter adoptable
on a repo with pre-existing findings: ``--write-baseline`` records
today's findings as fingerprints; later runs with ``--baseline`` fail
only on findings NOT in the file, so new debt is blocked while old
debt burns down explicitly. Fingerprints are
``rule :: relative-path :: stripped-source-line-text :: occurrence-
index`` — anchored to the line's TEXT, not its number, so unrelated
edits above a finding don't churn the baseline; the occurrence index
disambiguates identical lines. A finding whose line text changes
deliberately re-surfaces, which is the behavior a ratchet wants.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from chainermn_torch.analysis.core import (NOT_APPLICABLE, NOT_YET_PORTED,
                                           RULES, Finding, Suppression)

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/"
                "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")
BASELINE_VERSION = 1


def _rel(path: str, root: Optional[str] = None) -> str:
    root = root or os.getcwd()
    try:
        rel = os.path.relpath(os.path.abspath(path), root)
    except ValueError:          # different drive (windows)
        rel = path
    if rel.startswith(".."):    # outside the root: keep as given
        rel = path
    return rel.replace(os.sep, "/")


# ---------------------------------------------------------------------------
# SARIF
# ---------------------------------------------------------------------------


def to_sarif(findings: Sequence[Finding],
             root: Optional[str] = None,
             suppressions: Optional[Sequence[Suppression]] = None
             ) -> dict:
    """A complete SARIF 2.1.0 log object for one lint run. When
    ``suppressions`` is given, the in-source ``# dlint: disable``
    comments the run honored are recorded under the run's
    ``properties.suppressions`` (path, line, rules, absorbed-finding
    count) so a SARIF consumer can audit what was silenced and why the
    result list is shorter than the raw finding count."""
    catalogue = {rule_id: (rule.name, rule.doc, None)
                 for rule_id, rule in RULES.items()}
    for table in (NOT_APPLICABLE, NOT_YET_PORTED):
        for rule_id, (name, reason) in table.items():
            catalogue[rule_id] = (
                name, f"docs/static_analysis_torch.md#{rule_id.lower()}",
                reason)
    rules_meta = []
    for rule_id, (name, doc, reason) in sorted(catalogue.items()):
        meta = {
            "id": rule_id,
            "name": name,
            "helpUri": doc,
            "shortDescription": {"text": name},
            "defaultConfiguration": {"level": "error"},
        }
        if reason is not None:
            meta["defaultConfiguration"] = {"enabled": False,
                                            "level": "none"}
            meta["properties"] = {"applicable": False, "reason": reason}
        rules_meta.append(meta)
    index = {r["id"]: i for i, r in enumerate(rules_meta)}
    results = []
    for f in findings:
        result = {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": _rel(f.path, root),
                        "uriBaseId": "SRCROOT",
                    },
                    "region": {"startLine": max(1, f.line)},
                },
            }],
        }
        if f.rule in index:
            result["ruleIndex"] = index[f.rule]
        results.append(result)
    run: dict = {
        "tool": {
            "driver": {
                "name": "dlint",
                "informationUri": "docs/static_analysis_torch.md",
                "rules": rules_meta,
            },
        },
        "originalUriBaseIds": {
            "SRCROOT": {"uri": "file:///" + _rel(
                root or os.getcwd(), "/").lstrip("/") + "/"},
        },
        "results": results,
    }
    if suppressions is not None:
        run["properties"] = {
            "suppressions": [
                {
                    "uri": _rel(s.path, root),
                    "line": s.line,
                    "rules": sorted(s.rules),
                    "hits": s.hits,
                }
                for s in sorted(suppressions,
                                key=lambda s: (s.path, s.line))
            ],
        }
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [run],
    }


def from_sarif(log: dict) -> Tuple[List[Finding], List[Suppression]]:
    """Inverse of :func:`to_sarif` up to path relativization: rebuild
    the findings (rule, uri, line, message) and recorded suppressions
    from a dlint SARIF log. Locations come back repo-relative — exactly
    what round-trip tests and CI tooling diffing two logs need."""
    if not isinstance(log, dict) or "runs" not in log:
        raise ValueError("not a SARIF log object")
    findings: List[Finding] = []
    suppressions: List[Suppression] = []
    for run in log["runs"]:
        for res in run.get("results", ()):
            loc = (res.get("locations") or [{}])[0]
            phys = loc.get("physicalLocation", {})
            uri = phys.get("artifactLocation", {}).get("uri", "")
            line = phys.get("region", {}).get("startLine", 1)
            findings.append(Finding(
                res.get("ruleId", ""), uri, int(line),
                res.get("message", {}).get("text", "")))
        for s in run.get("properties", {}).get("suppressions", ()):
            sup = Suppression(
                path=s.get("uri", ""), line=int(s.get("line", 0)),
                rules=set(s.get("rules", ())),
                start=int(s.get("line", 0)),
                end=int(s.get("line", 0)) + 1)
            sup.hits = int(s.get("hits", 0))
            suppressions.append(sup)
    return findings, suppressions


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


def _line_text(path: str, line: int,
               cache: Dict[str, List[str]]) -> str:
    if path not in cache:
        try:
            with open(path, encoding="utf-8") as fh:
                cache[path] = fh.read().splitlines()
        except OSError:
            cache[path] = []
    lines = cache[path]
    if 1 <= line <= len(lines):
        return lines[line - 1].strip()
    return ""


def fingerprints(findings: Sequence[Finding],
                 root: Optional[str] = None) -> List[Tuple[Finding, str]]:
    """(finding, fingerprint) pairs; stable across line-number drift."""
    cache: Dict[str, List[str]] = {}
    counts: Dict[str, int] = {}
    out: List[Tuple[Finding, str]] = []
    # occurrence index assigned in (path, line, rule) order so two
    # identical lines fingerprint deterministically
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        base = "::".join((f.rule, _rel(f.path, root),
                          _line_text(f.path, f.line, cache)))
        n = counts.get(base, 0)
        counts[base] = n + 1
        out.append((f, f"{base}::{n}"))
    return out


def write_baseline(path: str, findings: Sequence[Finding],
                   root: Optional[str] = None) -> dict:
    data = {
        "version": BASELINE_VERSION,
        "tool": "dlint",
        "findings": sorted(fp for _, fp in fingerprints(findings, root)),
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return data


def load_baseline(path: str) -> set:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, dict) or "findings" not in data:
        raise ValueError(f"{path}: not a dlint baseline file")
    return set(data["findings"])


def filter_new(findings: Sequence[Finding], baseline: Iterable[str],
               root: Optional[str] = None) -> List[Finding]:
    """Findings whose fingerprint is NOT in the baseline — the only
    ones a baselined run gates on."""
    known = set(baseline)
    return [f for f, fp in fingerprints(findings, root)
            if fp not in known]
