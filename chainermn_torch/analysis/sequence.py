"""Collective-sequence abstract interpretation (DL113 / DL114) for the
port.

Counterpart of ``chainermn_tpu/analysis/sequence.py``. The point-to-point
set counts the port's receives too: ``recv_tree`` (the chain list's
autograd receive), ``try_recv_obj`` (the planes' bounded probe: it
consumes the message a send put on its channel, so it matches that send;
being bounded, it is never itself an unmatched or circular wait),
``torch.distributed``'s ``isend``/``irecv``, and the communicator's
``exchange``, whose literal ``sends``/``recvs`` lists become their sends
followed by their receives.

Every function is summarized ONCE as an ordered event list:

* ``Op`` — a collective or point-to-point call, with its rule-relevant
  facts (symmetric vs P2P, direction, literal tag/peer when present)
  and source anchor;
* ``Branch`` — an ``if``, carrying whether its test is rank-dependent
  (the path condition the cross-rank checks care about) and the event
  lists of both sides. A terminating rank guard (``if rank == 0: ...;
  return``) folds the statement's fallthrough into the implicit else,
  exactly like DL101;
* ``CallSite`` — a call resolved through the :class:`~.callgraph.
  Project`; expansion happens lazily, bounded by
  :data:`~.callgraph.DEFAULT_CALL_DEPTH` with a cycle guard, so the
  summaries compose interprocedurally without exponential blowup.

Two project rules interpret the summaries:

**DL113 interprocedural-divergent-collective** — at every
rank-dependent branch, the symmetric collectives reachable from one
side (THROUGH any resolved call chain) must also be reachable from the
sibling, and a side that communicates point-to-point needs a sibling
that communicates at all. This is DL101's cross-rank agreement check
lifted over the call graph; to keep one finding per defect, DL113 only
reports divergence that crosses at least one call boundary — the
zero-hop case is DL101's, and stays there.

**DL114 send-recv-cycle** — the eager point-to-point channel graph,
built from every ``send``/``recv``-family call with a statically-known
tag across ALL modules. Two checks:

* *unmatched endpoints*: a tag that is only ever sent (or only ever
  received) anywhere in the analyzed sources strands its peer in the
  transport;
* *cycles*: within each rank path (rank-dependent branches split the
  path — the two sides run on different ranks), a ``recv(tag=a)``
  ordered before a ``send(tag=b)`` means producing ``b`` waits on
  ``a``. A strongly-connected component of that waits-before relation
  in which EVERY send of every member tag sits behind a member recv has
  no rank that can send first: circular wait, runtime deadlock.

Path conditions are tracked exactly as far as the checks need: splits
happen only at rank-dependent branches (data-dependent branches
contribute both sides to one path, an over-approximation of order),
and the per-function path count is capped (:data:`MAX_PATHS`) so
branch-heavy code cannot explode the analysis.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from chainermn_torch.analysis.ast_passes import (
    _ENDPOINT_KWS,
    P2P_CALLS,
    SYMMETRIC_COLLECTIVES,
    _arg_or_kw,
    _callee_name,
    _contains_rank_source,
    _kw,
    _literal,
    _tainted_names,
    _terminates,
)
from chainermn_torch.analysis.callgraph import (
    DEFAULT_CALL_DEPTH,
    FunctionInfo,
    Project,
)
from chainermn_torch.analysis.core import Finding, Rule, register

_DOC = "docs/static_analysis_torch.md"

#: cap on rank paths enumerated per function (DL114); beyond it the
#: remaining splits merge, an over-approximation that only costs recall
MAX_PATHS = 32

_SENDS = {"send", "send_obj", "eager_send", "isend"}
_RECVS = {"recv", "recv_obj", "eager_recv", "recv_tree", "try_recv_obj",
          "irecv"}
#: receives that return or raise once their timeout ends: they match a
#: send (its message is consumed), but never wait forever themselves
_BOUNDED_RECVS = {"try_recv_obj"}


@dataclass(frozen=True)
class Op:
    kind: str                  # "sym" | "send" | "recv"
    name: str                  # callee terminal name
    path: str
    line: int
    tag: object = None         # literal tag when statically known
    peer: object = None        # literal dest/src when statically known
    via: Tuple[str, ...] = ()  # call chain (function names) to reach it


@dataclass
class Branch:
    rank_dep: bool
    line: int
    body: List[object] = field(default_factory=list)
    orelse: List[object] = field(default_factory=list)


@dataclass
class CallSite:
    callee: str                # qualname in project.functions
    line: int
    path: str


def _p2p_facts(call: ast.Call, name: str):
    """(tag, peer) literals for an eager P2P call, mirroring DL102's
    argument conventions — or (None, None) when not statically known.
    Returns ``None`` (not a tuple) when the call doesn't look like one
    of ours at all (a socket/generator ``.send`` with neither tag nor
    endpoint keyword)."""
    if name in ("send", "recv"):
        # ``tag`` only as a KEYWORD: the traced functions.send/recv
        # share these names with the eager comm API but take the peer
        # rank positionally where eager takes the tag — a positional
        # guess mistakes one for the other
        ep_name = "dest" if name == "send" else "src"
        ep = _arg_or_kw(call, 1 if name == "send" else 0, ep_name)
        tag_node = _kw(call, "tag")
        if tag_node is None and not any(
                kw.arg in _ENDPOINT_KWS for kw in call.keywords):
            return None
        return (_literal(tag_node) if tag_node is not None else 0,
                _literal(ep))
    if name in ("isend", "irecv"):
        # torch.distributed.isend(tensor, dst, group=, tag=) /
        # irecv(tensor, src, ...): the tag defaults to 0 there too
        ep = _arg_or_kw(call, 1, "dst" if name == "isend" else "src")
        tag_node = _kw(call, "tag")
        return (_literal(tag_node) if tag_node is not None else 0,
                _literal(ep))
    if name in ("send_obj", "recv_obj", "try_recv_obj"):
        ep = _arg_or_kw(call, 1 if name == "send_obj" else 0,
                        "dest" if name == "send_obj" else "src")
        tag_node = _arg_or_kw(call, 2 if name == "send_obj" else 1, "tag")
        return (_literal(tag_node) if tag_node is not None else 0,
                _literal(ep))
    if name in ("eager_send", "eager_recv", "recv_tree"):
        ep = _arg_or_kw(call, 2 if name == "eager_send" else 1, "rank")
        tag_node = _kw(call, "tag")
        return (_literal(tag_node) if tag_node is not None else 0,
                _literal(ep))
    return None


def _exchange_ops(call: ast.Call, path: str) -> List["Op"]:
    """The port's ``comm.exchange(sends=[(dest, tag, tree)], recvs=[(src,
    tag)])``: every send goes out before any receive, so the call is its
    sends then its receives, each with its literal tag and peer where the
    argument is a literal list of tuples. A non-literal side is one
    message of unknown tag (it still communicates, for DL113)."""
    ops: List[Op] = []
    for pos, kw, kind, tag_at in ((0, "sends", "send", 1),
                                  (1, "recvs", "recv", 1)):
        arg = _arg_or_kw(call, pos, kw)
        if arg is None:
            continue
        if isinstance(arg, (ast.List, ast.Tuple)):
            for elt in arg.elts:
                if isinstance(elt, ast.Tuple) and len(elt.elts) > tag_at:
                    ops.append(Op(kind, "exchange", path, call.lineno,
                                  tag=_literal(elt.elts[tag_at]),
                                  peer=_literal(elt.elts[0])))
                else:
                    ops.append(Op(kind, "exchange", path, call.lineno))
        else:
            ops.append(Op(kind, "exchange", path, call.lineno))
    return ops


class SequenceAnalysis:
    """Builds and caches per-function event summaries for one project."""

    def __init__(self, project: Project,
                 depth: int = DEFAULT_CALL_DEPTH):
        self.project = project
        self.depth = depth
        self._summaries: Dict[str, List[object]] = {}
        self._flat: Dict[Tuple[str, int], List[Op]] = {}
        self._expanded: Dict[Tuple[str, int], List[object]] = {}
        self._op_reach_map: Optional[Dict[str, bool]] = None

    # -- summarization ----------------------------------------------------

    def summary(self, func: FunctionInfo) -> List[object]:
        if func.qualname in self._summaries:
            return self._summaries[func.qualname]
        self._summaries[func.qualname] = []     # cycle guard
        tainted = _tainted_names(func.node.body)
        local_types = self.project.local_types(func)
        events = self._events(func, func.node.body, tainted, local_types)
        self._summaries[func.qualname] = events
        return events

    def _events(self, func: FunctionInfo, stmts: Sequence[ast.stmt],
                tainted: Set[str], local_types) -> List[object]:
        out: List[object] = []
        for i, stmt in enumerate(stmts):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.If):
                rank_dep = _contains_rank_source(stmt.test, tainted)
                body = self._events(func, stmt.body, tainted, local_types)
                orelse = self._events(func, stmt.orelse, tainted,
                                      local_types)
                if rank_dep and _terminates(stmt.body):
                    rest = self._events(func, stmts[i + 1:], tainted,
                                        local_types)
                    out.append(Branch(True, stmt.lineno, body,
                                      orelse + rest))
                    return out
                if rank_dep and _terminates(stmt.orelse):
                    rest = self._events(func, stmts[i + 1:], tainted,
                                        local_types)
                    out.append(Branch(True, stmt.lineno, body + rest,
                                      orelse))
                    return out
                out.append(Branch(rank_dep, stmt.lineno, body, orelse))
                continue
            # loops / with / try: inline nested blocks in source order
            # (one abstract iteration — enough for agreement and
            # waits-before ordering)
            nested = []
            for name in ("body", "orelse", "finalbody"):
                blk = getattr(stmt, name, None)
                if isinstance(blk, list):
                    nested.extend(blk)
            for h in getattr(stmt, "handlers", []) or []:
                nested.extend(h.body)
            if nested:
                # the statement's own expressions (loop iterables, with
                # items) may carry calls too
                out.extend(self._expr_events(func, stmt, local_types,
                                             skip_blocks=True))
                out.extend(self._events(func, nested, tainted,
                                        local_types))
                continue
            out.extend(self._expr_events(func, stmt, local_types))
        return out

    def _expr_events(self, func: FunctionInfo, stmt: ast.stmt,
                     local_types, skip_blocks: bool = False
                     ) -> List[object]:
        out: List[object] = []
        for n in ast.walk(stmt) if not skip_blocks else \
                self._walk_header(stmt):
            if not isinstance(n, ast.Call):
                continue
            name = _callee_name(n)
            if name in SYMMETRIC_COLLECTIVES:
                out.append(Op("sym", name, func.path, n.lineno))
            elif name == "exchange":
                out.extend(_exchange_ops(n, func.path))
            elif name in P2P_CALLS:
                facts = _p2p_facts(n, name)
                if facts is None:
                    continue
                tag, peer = facts
                kind = "send" if name in _SENDS else "recv"
                out.append(Op(kind, name, func.path, n.lineno,
                              tag=tag, peer=peer))
            else:
                resolved = self.project.resolve_call(n, func, local_types)
                if resolved is not None:
                    out.append(CallSite(resolved.qualname, n.lineno,
                                        func.path))
        out.sort(key=lambda e: e.line)
        return out

    @staticmethod
    def _walk_header(stmt: ast.stmt):
        """Walk only the non-block expressions of a compound statement
        (the loop iterable, the with items, the try has none)."""
        for fieldname, value in ast.iter_fields(stmt):
            if fieldname in ("body", "orelse", "finalbody", "handlers"):
                continue
            if isinstance(value, ast.AST):
                yield from ast.walk(value)
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.AST):
                        yield from ast.walk(v)

    # -- flattening -------------------------------------------------------

    def flatten_callee(self, qualname: str, depth: int) -> List[Op]:
        """Every Op reachable from ``qualname``'s body (both sides of
        every nested branch), call chains expanded to ``depth``, each
        Op's ``via`` rooted at this callee's name. Memoized per
        (qualname, depth) — callers prepend their own prefix."""
        key = (qualname, depth)
        cached = self._flat.get(key)
        if cached is not None:
            return cached
        self._flat[key] = []               # cycle guard
        func = self.project.functions.get(qualname)
        if func is None:
            return []
        name = qualname.split(":", 1)[-1]
        ops = self._flatten_events(self.summary(func), depth, (name,))
        self._flat[key] = ops
        return ops

    def _flatten_events(self, events: List[object], depth: int,
                        via: Tuple[str, ...]) -> List[Op]:
        out: List[Op] = []
        for ev in events:
            if isinstance(ev, Op):
                if via != ev.via:
                    ev = Op(ev.kind, ev.name, ev.path, ev.line,
                            tag=ev.tag, peer=ev.peer, via=via)
                out.append(ev)
            elif isinstance(ev, Branch):
                out.extend(self._flatten_events(ev.body, depth, via))
                out.extend(self._flatten_events(ev.orelse, depth, via))
            elif isinstance(ev, CallSite):
                if depth <= 0:
                    continue
                if not self._op_reach().get(ev.callee, False):
                    continue               # op-free subtree: nothing there
                callee = ev.callee.split(":", 1)[-1]
                if callee in via:
                    continue               # recursion: treat as opaque
                for op in self.flatten_callee(ev.callee, depth - 1):
                    if any(v in via for v in op.via):
                        continue           # cycle through the prefix
                    out.append(Op(op.kind, op.name, op.path, op.line,
                                  tag=op.tag, peer=op.peer,
                                  via=via + op.via))
        return out

    def _summaries_for(self, qualname: str) -> List[object]:
        func = self.project.functions.get(qualname)
        return self.summary(func) if func is not None else []

    # -- op reachability (expansion pruning) ------------------------------

    def _op_reach(self) -> Dict[str, bool]:
        """qualname → does any Op exist transitively in its call tree.
        One whole-project fixpoint; expansion then skips op-free
        callees entirely. Without this, a cluster of mutually recursive
        helpers is re-inlined at every distinct remaining depth — an
        exponential tree copy that buys nothing, since an op-free
        subtree can never contribute an event."""
        if self._op_reach_map is not None:
            return self._op_reach_map
        direct: Dict[str, bool] = {}
        calls: Dict[str, Set[str]] = {}

        def scan(events, q):
            for ev in events:
                if isinstance(ev, Op):
                    direct[q] = True
                elif isinstance(ev, Branch):
                    scan(ev.body, q)
                    scan(ev.orelse, q)
                elif isinstance(ev, CallSite):
                    calls[q].add(ev.callee)

        for q, func in self.project.functions.items():
            direct.setdefault(q, False)
            calls.setdefault(q, set())
            scan(self.summary(func), q)
        changed = True
        while changed:
            changed = False
            for q, callees in calls.items():
                if not direct[q] and any(direct.get(c, False)
                                         for c in callees):
                    direct[q] = True
                    changed = True
        self._op_reach_map = direct
        return direct

    # -- rank paths (DL114) -----------------------------------------------

    def rank_paths(self, qualname: str) -> List[List[Op]]:
        func = self.project.functions.get(qualname)
        if func is None:
            return []
        return self._paths(self._expanded_tree(qualname, self.depth))

    def _expanded_tree(self, qualname: str,
                       depth: int) -> List[object]:
        """The function's event tree with resolved calls inlined
        (Branch structure kept, unlike :meth:`flatten_callee`).
        Memoized per (qualname, depth); an in-progress entry (direct or
        mutual recursion) reads as empty, i.e. the recursive call is
        opaque."""
        key = (qualname, depth)
        cached = self._expanded.get(key)
        if cached is not None:
            return cached
        self._expanded[key] = []           # cycle guard
        func = self.project.functions.get(qualname)
        if func is None:
            return []
        out = self._expand(self.summary(func), depth)
        self._expanded[key] = out
        return out

    def _expand(self, events: List[object], depth: int) -> List[object]:
        out: List[object] = []
        for ev in events:
            if isinstance(ev, Op):
                out.append(ev)
            elif isinstance(ev, Branch):
                out.append(Branch(
                    ev.rank_dep, ev.line,
                    self._expand(ev.body, depth),
                    self._expand(ev.orelse, depth)))
            elif isinstance(ev, CallSite):
                if depth <= 0:
                    continue
                if not self._op_reach().get(ev.callee, False):
                    continue               # op-free subtree: nothing there
                out.extend(self._expanded_tree(ev.callee, depth - 1))
        return out

    def _paths(self, events: List[object]) -> List[List[Op]]:
        paths: List[List[Op]] = [[]]
        for ev in events:
            if isinstance(ev, Op):
                for p in paths:
                    p.append(ev)
            elif isinstance(ev, Branch):
                if ev.rank_dep and len(paths) * 2 <= MAX_PATHS:
                    body_paths = self._paths(ev.body)
                    orelse_paths = self._paths(ev.orelse)
                    paths = [p + b for p in paths for b in body_paths] \
                        + [p + o for p in paths for o in orelse_paths]
                else:
                    # merged (data-dependent, or path budget exhausted):
                    # both sides contribute, in source order
                    seq = self._flatten_events(ev.body, 0, ()) \
                        + self._flatten_events(ev.orelse, 0, ())
                    for p in paths:
                        p.extend(seq)
        return paths[:MAX_PATHS]


# ---------------------------------------------------------------------------
# DL113 — interprocedural divergent collective
# ---------------------------------------------------------------------------


def _chain_str(op: Op) -> str:
    return " -> ".join(op.via) if op.via else op.name


def _walk_branches(events, out):
    for ev in events:
        if isinstance(ev, Branch):
            out.append(ev)
            _walk_branches(ev.body, out)
            _walk_branches(ev.orelse, out)


def check_interprocedural_divergent_collective(
        project: Project) -> List[Finding]:
    analysis = SequenceAnalysis(project)
    findings: List[Finding] = []
    for qualname, func in sorted(project.functions.items()):
        branches: List[Branch] = []
        _walk_branches(analysis.summary(func), branches)
        for br in branches:
            if not br.rank_dep:
                continue
            body = analysis._flatten_events(br.body, analysis.depth, ())
            orelse = analysis._flatten_events(br.orelse, analysis.depth,
                                              ())
            for a, b in ((body, orelse), (orelse, body)):
                other_names = {o.name for o in b if o.kind == "sym"}
                other_p2p = any(o.kind in ("send", "recv") for o in b)
                for op in a:
                    if not op.via:
                        continue      # zero call hops: DL101's finding
                    if op.kind == "sym" and op.name not in other_names:
                        findings.append(Finding(
                            "DL113", func.path, br.line,
                            f"rank-dependent branch reaches collective "
                            f"'{op.name}' through the call chain "
                            f"{_chain_str(op)} ({op.path}:{op.line}) "
                            "but the sibling path never reaches it — "
                            "ranks that take the other side skip the "
                            "rendezvous and the rest deadlock. Hoist "
                            "the call out of the rank guard or make "
                            "every path reach the same collective "
                            f"sequence ({_DOC}#dl113)."))
                        break
                    if (op.kind in ("send", "recv") and not other_p2p):
                        findings.append(Finding(
                            "DL113", func.path, br.line,
                            f"rank-dependent branch reaches "
                            f"point-to-point '{op.name}' through "
                            f"{_chain_str(op)} ({op.path}:{op.line}) "
                            "with no communication on the sibling "
                            "path — the peer rank never enters the "
                            "transport and both sides hang. Pair the "
                            "send/recv across the branch or hoist it "
                            f"({_DOC}#dl113)."))
                        break
    return findings


register(Rule("DL113", "interprocedural-divergent-collective",
              f"{_DOC}#dl113",
              check_interprocedural_divergent_collective,
              kind="project"))


# ---------------------------------------------------------------------------
# DL114 — send/recv channel cycles and unmatched endpoints
# ---------------------------------------------------------------------------


def check_send_recv_cycle(project: Project) -> List[Finding]:
    analysis = SequenceAnalysis(project)
    findings: List[Finding] = []

    # ---- collect ops globally (for endpoint matching) and per path
    send_sites: Dict[object, List[Op]] = {}
    recv_sites: Dict[object, List[Op]] = {}
    all_paths: List[List[Op]] = []
    # Only summarize TOP-LEVEL behavior once per function; paths reached
    # purely as callees of another analyzed function are re-walked there,
    # which is fine for a waits-before relation (duplicates add no edge).
    for qualname in sorted(project.functions):
        for path_ops in analysis.rank_paths(qualname):
            p2p = [op for op in path_ops
                   if op.kind in ("send", "recv") and op.tag is not None]
            if p2p:
                all_paths.append(p2p)

    seen_sites: Set[Tuple[str, int, str]] = set()
    for p2p in all_paths:
        for op in p2p:
            key = (op.path, op.line, op.kind)
            if key in seen_sites:
                continue
            seen_sites.add(key)
            (send_sites if op.kind == "send"
             else recv_sites).setdefault(op.tag, []).append(op)

    # ---- unmatched endpoints
    for tag in sorted(set(send_sites) - set(recv_sites), key=repr):
        op = min(send_sites[tag], key=lambda o: (o.path, o.line))
        findings.append(Finding(
            "DL114", op.path, op.line,
            f"channel tag {tag!r} is sent here but never received "
            "anywhere in the analyzed sources — the destination rank "
            "has no matching recv, so the transport strands the "
            "message (and a rendezvous send blocks forever). Add the "
            "matching recv, or if the receiver lives outside the "
            "analyzed tree (an embedded worker script, a subprocess), "
            f"suppress with a rationale ({_DOC}#dl114)."))
    for tag in sorted(set(recv_sites) - set(send_sites), key=repr):
        blocking = [o for o in recv_sites[tag]
                    if o.name not in _BOUNDED_RECVS]
        if not blocking:
            continue          # a bounded probe for nothing times out
        op = min(blocking, key=lambda o: (o.path, o.line))
        findings.append(Finding(
            "DL114", op.path, op.line,
            f"channel tag {tag!r} is received here but never sent "
            "anywhere in the analyzed sources — this recv blocks "
            "forever (peer death aside, nothing will ever arrive). "
            "Add the matching send, or suppress with a rationale if "
            "the sender is outside the analyzed tree "
            f"({_DOC}#dl114)."))

    # ---- waits-before cycles
    # edge a -> b: some rank path receives tag a before sending tag b
    edges: Dict[object, Set[object]] = {}
    edge_sites: Dict[Tuple[object, object], Tuple[Op, Op]] = {}
    # per send occurrence: tags received earlier on its path
    send_prevs: Dict[Tuple[str, int], Set[object]] = {}
    for p2p in all_paths:
        seen_recvs: List[Op] = []
        for op in p2p:
            if op.kind == "recv":
                if op.name not in _BOUNDED_RECVS:
                    seen_recvs.append(op)
            else:
                key = (op.path, op.line)
                prev = {r.tag for r in seen_recvs}
                if key in send_prevs:
                    # same send reached along several paths: it can
                    # proceed if ANY path frees it
                    send_prevs[key] &= prev
                else:
                    send_prevs[key] = set(prev)
                for r in seen_recvs:
                    edges.setdefault(r.tag, set()).add(op.tag)
                    edge_sites.setdefault((r.tag, op.tag), (r, op))

    # SCCs over the waits-before graph (iterative Tarjan is overkill at
    # this scale; simple Kosaraju-style via reachability)
    tags = sorted(edges, key=repr)
    sccs: List[Set[object]] = []
    assigned: Set[object] = set()

    def _reach(start: object) -> Set[object]:
        out, stack = set(), [start]
        while stack:
            t = stack.pop()
            for nxt in edges.get(t, ()):
                if nxt not in out:
                    out.add(nxt)
                    stack.append(nxt)
        return out

    reach = {t: _reach(t) for t in tags}
    for t in tags:
        if t in assigned:
            continue
        scc = {t} | {u for u in reach[t] if t in reach.get(u, set())}
        if len(scc) > 1 or t in edges.get(t, set()):
            sccs.append(scc)
        assigned |= scc

    for scc in sccs:
        # deadlocked iff NO send of any member tag can go first: every
        # send occurrence of every member sits behind a member recv
        free = False
        for tag in scc:
            for op in send_sites.get(tag, []):
                prevs = send_prevs.get((op.path, op.line), set())
                if not (prevs & scc):
                    free = True
                    break
            if free:
                break
        if free:
            continue
        members = sorted(scc, key=repr)
        first_tag = members[0]
        anchor = min(recv_sites.get(first_tag, [])
                     or send_sites.get(first_tag, []),
                     key=lambda o: (o.path, o.line))
        chain = ", ".join(
            f"recv({a!r}) before send({b!r}) at "
            f"{edge_sites[(a, b)][0].path}:{edge_sites[(a, b)][0].line}"
            for a in members for b in edges.get(a, ())
            if b in scc and (a, b) in edge_sites)
        findings.append(Finding(
            "DL114", anchor.path, anchor.line,
            f"send/recv cycle over channel tags {members!r}: "
            f"{chain} — every rank waits to receive before any rank "
            "sends, so no message ever enters the transport (circular "
            "wait, runtime deadlock). Break the cycle by making one "
            "endpoint send first, or split the exchange onto distinct "
            f"tags with a send-first initiator ({_DOC}#dl114)."))
    return findings


register(Rule("DL114", "send-recv-cycle", f"{_DOC}#dl114",
              check_send_recv_cycle, kind="project"))
