"""Concurrency pass: lock orderings and blocking calls (DL115 / DL116).

The fleet router, async snapshot writer, and serving frontend are the
repo's three multi-threaded planes, and they share one discipline
(docs/serving.md): locks protect *bookkeeping*, never *waiting*. This
pass verifies both halves of that discipline whole-program:

**DL115 lock-order-inversion** — walk every function with the set of
locks held (``with lock:`` scopes plus unbounded ``.acquire()`` calls),
following resolved calls through the :class:`~.callgraph.Project` to
:data:`~.callgraph.DEFAULT_CALL_DEPTH`. Every nested acquisition adds a
*held-before* edge; a cycle in that graph means two threads can grab
the same pair of locks in opposite orders and deadlock. A self-edge is
flagged only when the lock is provably a plain ``threading.Lock``
(non-reentrant re-entry is a guaranteed single-thread deadlock; for an
``RLock`` or an unknown constructor it's legal).

**DL116 blocking-call-under-lock** — while any lock is held, flag calls
that can block indefinitely: unbounded future/mailbox waits
(``.get()``/``.result()``/``.wait()`` with the same receiver-name and
deadline rules as DL111), unbounded thread ``.join()``, object-plane
collectives (pickle over the network), and ``barrier()`` (a cross-rank
rendezvous under a local lock couples lock latency to the slowest
rank). Bounded waits pass — slicing a wait at a deadline under a lock
is the router's own probe pattern. ``Condition.wait()`` on the lock
being held is NOT flagged: that wait *releases* the lock; it is the
standard condition-variable idiom.

Lock identity is intentionally name-structural, not alias-precise:

* ``self.X`` in a method of class ``C``       → ``("cls", module:C, X)``
* a module-level ``X = threading.Lock()``     → ``("mod", module, X)``
* a local ``X = threading.Lock()``            → ``("loc", qualname, X)``
* any other receiver ``r.X``                  → ``("obj", r, X)``

Two ``rep.lock`` expressions on different replicas therefore alias to
one identity. That is the useful direction for an ORDERING property:
per-instance locks of one class form one rank in the ordering, so
taking two instances' locks in both orders still shows up as a cycle.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from chainermn_torch.analysis.ast_passes import (
    OBJ_PLANE_CALLS,
    _callee_name,
    _is_unbounded_wait,
    _wait_receiver_name,
    _WAIT_RECEIVER_HINTS,
)
from chainermn_torch.analysis.callgraph import (
    DEFAULT_CALL_DEPTH,
    FunctionInfo,
    Project,
    _attr_chain,
)
from chainermn_torch.analysis.core import Finding, Rule, register

_DOC = "docs/static_analysis_torch.md"

#: threading/multiprocessing constructors that create a lock object
LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
              "BoundedSemaphore"}

#: name fragments that mark a receiver as a lock even without seeing
#: its constructor (cross-module attributes)
_LOCK_NAME_HINTS = ("lock", "mutex")

#: thread-ish receiver fragments for the unbounded-join check
_JOIN_RECEIVER_HINTS = ("thread", "worker", "proc", "writer")

LockId = Tuple[str, str, str]


def _lock_ctor_name(value: ast.expr) -> Optional[str]:
    """``threading.Lock()`` / ``Lock()`` → ``"Lock"``, else None."""
    if not isinstance(value, ast.Call):
        return None
    chain = _attr_chain(value.func)
    if chain and chain[-1] in LOCK_CTORS:
        return chain[-1]
    return None


def _name_is_lockish(name: str) -> bool:
    low = name.lower()
    return any(h in low for h in _LOCK_NAME_HINTS)


class LockAnalysis:
    """Shared traversal for DL115/DL116 over one project."""

    def __init__(self, project: Project,
                 depth: int = DEFAULT_CALL_DEPTH):
        self.project = project
        self.depth = depth
        # ("cls", module:Class, attr) → ctor name, when seen
        self.ctors: Dict[LockId, str] = {}
        self._mod_locks: Dict[str, Set[str]] = {}
        self._harvest()
        # DL115 state
        self.edges: Dict[LockId, Set[LockId]] = {}
        self.anchors: Dict[Tuple[LockId, LockId],
                           Tuple[str, int, str]] = {}
        # DL116 findings accumulate during the same walk
        self.blocking: List[Finding] = []
        self._blocked_sites: Set[Tuple[str, int]] = set()
        self._local_lock_memo: Dict[str, Dict[str, str]] = {}

    # -- lock discovery ---------------------------------------------------

    def _harvest(self) -> None:
        for mod in self.project.modules.values():
            mod_locks: Set[str] = set()
            for node in mod.tree.body:
                if isinstance(node, ast.Assign):
                    ctor = _lock_ctor_name(node.value)
                    if ctor is None:
                        continue
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            mod_locks.add(t.id)
                            self.ctors[("mod", mod.name, t.id)] = ctor
            self._mod_locks[mod.name] = mod_locks
            for ci in mod.classes.values():
                key_cls = f"{mod.name}:{ci.name}"
                for meth in ci.methods.values():
                    for n in ast.walk(meth.node):
                        if not isinstance(n, ast.Assign):
                            continue
                        ctor = _lock_ctor_name(n.value)
                        if ctor is None:
                            continue
                        for t in n.targets:
                            if (isinstance(t, ast.Attribute)
                                    and isinstance(t.value, ast.Name)
                                    and t.value.id == "self"):
                                self.ctors[("cls", key_cls, t.attr)] \
                                    = ctor

    def _local_locks(self, func: FunctionInfo) -> Dict[str, str]:
        cached = self._local_lock_memo.get(func.qualname)
        if cached is not None:
            return cached
        out: Dict[str, str] = {}
        for n in ast.walk(func.node):
            if isinstance(n, ast.Assign):
                ctor = _lock_ctor_name(n.value)
                if ctor is None:
                    continue
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = ctor
        self._local_lock_memo[func.qualname] = out
        return out

    def lock_id(self, expr: ast.expr, func: FunctionInfo,
                local_locks: Dict[str, str]) -> Optional[LockId]:
        """Identity of a lock expression, or None when the expression
        is not recognizably a lock."""
        if isinstance(expr, ast.Name):
            name = expr.id
            if name in local_locks:
                lid = ("loc", func.qualname, name)
                self.ctors.setdefault(lid, local_locks[name])
                return lid
            if name in self._mod_locks.get(func.module, ()):
                return ("mod", func.module, name)
            if _name_is_lockish(name):
                return ("loc", func.qualname, name)
            return None
        if isinstance(expr, ast.Attribute):
            attr = expr.attr
            if isinstance(expr.value, ast.Name) \
                    and expr.value.id == "self" and func.cls:
                lid = ("cls", f"{func.module}:{func.cls}", attr)
                if lid in self.ctors or _name_is_lockish(attr):
                    return lid
                return None
            if not _name_is_lockish(attr):
                return None
            recv_chain = _attr_chain(expr.value)
            recv = recv_chain[-1] if recv_chain else "?"
            return ("obj", recv, attr)
        return None

    # -- the walk ---------------------------------------------------------

    def run(self) -> None:
        for qualname in sorted(self.project.functions):
            func = self.project.functions[qualname]
            self._walk_func(func, held=(), depth=self.depth,
                            stack=(qualname,), anchor=None)

    def _walk_func(self, func: FunctionInfo, held: Tuple[LockId, ...],
                   depth: int, stack: Tuple[str, ...],
                   anchor: Optional[Tuple[str, int, str]]) -> None:
        """Walk ``func``'s body with ``held`` locks. ``anchor``, when
        set, is the original (path, line, chain) call site in the
        FIRST function of the walk — interprocedural findings must be
        reported there, where the suppressing file can see them."""
        local_locks = self._local_locks(func)
        self._walk_stmts(func.node.body, func, held, depth, stack,
                         anchor, local_locks, None)

    def _walk_stmts(self, stmts: Sequence[ast.stmt], func: FunctionInfo,
                    held: Tuple[LockId, ...], depth: int,
                    stack: Tuple[str, ...],
                    anchor: Optional[Tuple[str, int, str]],
                    local_locks: Dict[str, str],
                    local_types: Dict[str, str]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                now = held
                for item in stmt.items:
                    lid = self.lock_id(item.context_expr, func,
                                       local_locks)
                    if lid is None and isinstance(item.context_expr,
                                                  ast.Call):
                        # ``with self._lock:`` vs ``with open(...)`` —
                        # an ``x.acquire_timeout()``-style helper or a
                        # Condition call; only plain lock expressions
                        # count as acquisitions
                        self._visit_calls(item.context_expr, func, now,
                                          depth, stack, anchor,
                                          local_locks, local_types)
                    if lid is not None:
                        self._acquire(now, lid, func, stmt.lineno,
                                      anchor)
                        now = now + (lid,)
                self._walk_stmts(stmt.body, func, now, depth, stack,
                                 anchor, local_locks, local_types)
                continue
            for name in ("body", "orelse", "finalbody"):
                blk = getattr(stmt, name, None)
                if isinstance(blk, list) and blk:
                    self._walk_stmts(blk, func, held, depth, stack,
                                     anchor, local_locks, local_types)
            for h in getattr(stmt, "handlers", []) or []:
                self._walk_stmts(h.body, func, held, depth, stack,
                                 anchor, local_locks, local_types)
            self._visit_header(stmt, func, held, depth, stack, anchor,
                               local_locks, local_types)

    def _visit_header(self, stmt: ast.stmt, func, held, depth, stack,
                      anchor, local_locks, local_types) -> None:
        """Visit the calls in a statement's own expressions (not its
        nested blocks, which :meth:`_walk_stmts` handles)."""
        for fieldname, value in ast.iter_fields(stmt):
            if fieldname in ("body", "orelse", "finalbody", "handlers"):
                continue
            vals = value if isinstance(value, list) else [value]
            for v in vals:
                if isinstance(v, ast.AST):
                    self._visit_calls(v, func, held, depth, stack,
                                      anchor, local_locks, local_types)

    def _visit_calls(self, root: ast.AST, func: FunctionInfo, held,
                     depth, stack, anchor, local_locks,
                     local_types) -> None:
        if not held:
            # nothing to learn outside a lock scope: edges need a held
            # lock, and callees are each walked as roots of their own
            return
        for n in ast.walk(root):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            if not isinstance(n, ast.Call):
                continue
            self._visit_call(n, func, held, depth, stack, anchor,
                             local_locks, local_types)

    def _visit_call(self, call: ast.Call, func: FunctionInfo, held,
                    depth, stack, anchor, local_locks,
                    local_types) -> None:
        name = _callee_name(call)
        # explicit .acquire(): an ordering edge when unbounded
        if (name == "acquire" and isinstance(call.func, ast.Attribute)
                and _is_unbounded_wait(call)):
            lid = self.lock_id(call.func.value, func, local_locks)
            if lid is not None:
                self._acquire(held, lid, func, call.lineno, anchor)
                return
        if held:
            self._check_blocking(call, name, func, held, anchor)
        if local_types is None:
            local_types = self.project.local_types(func)
        resolved = self.project.resolve_call(call, func, local_types)
        if resolved is None or depth <= 0:
            return
        callee = resolved.qualname
        if callee in stack:
            return
        sub_anchor = anchor
        if held and sub_anchor is None:
            chain = resolved.name
            sub_anchor = (func.path, call.lineno, chain)
        elif held and sub_anchor is not None:
            sub_anchor = (sub_anchor[0], sub_anchor[1],
                          f"{sub_anchor[2]} -> {resolved.name}")
        self._walk_func(resolved, held, depth - 1, stack + (callee,),
                        sub_anchor)

    # -- DL115 edges ------------------------------------------------------

    def _acquire(self, held: Tuple[LockId, ...], lid: LockId,
                 func: FunctionInfo, line: int,
                 anchor: Optional[Tuple[str, int, str]]) -> None:
        site = anchor or (func.path, line, "")
        for h in held:
            self.edges.setdefault(h, set()).add(lid)
            self.anchors.setdefault((h, lid), site)

    # -- DL116 blocking ---------------------------------------------------

    def _check_blocking(self, call: ast.Call, name: Optional[str],
                        func: FunctionInfo, held: Tuple[LockId, ...],
                        anchor: Optional[Tuple[str, int, str]]) -> None:
        reason = None
        if name in OBJ_PLANE_CALLS:
            reason = (f"object-plane collective '{name}' (pickle over "
                      "the network)")
        elif name == "barrier":
            reason = ("cross-rank 'barrier()' — lock hold time becomes "
                      "the slowest rank's arrival time")
        elif name == "join" and _is_unbounded_wait(call) \
                and isinstance(call.func, ast.Attribute):
            recv = _wait_receiver_name_any(call)
            if recv and any(h in recv.lower()
                            for h in _JOIN_RECEIVER_HINTS):
                reason = f"unbounded '{recv}.join()'"
        else:
            recv = _wait_receiver_name(call)
            if recv is not None \
                    and any(h in recv.lower()
                            for h in _WAIT_RECEIVER_HINTS) \
                    and _is_unbounded_wait(call):
                # Condition.wait() on a HELD lock releases that lock —
                # the standard cv idiom, not a blocking hold
                if not (call.func.attr == "wait"
                        and any(h[2] == recv or h[2] == recv.lstrip("_")
                                for h in held)):
                    reason = (f"unbounded '{recv}.{call.func.attr}()' "
                              "wait")
        if reason is None:
            return
        if anchor is not None:
            path, line, chain = anchor
            msg = (f"call chain '{chain}' reaches {reason} at "
                   f"{func.path}:{call.lineno} while a lock acquired "
                   "here is still held")
        else:
            path, line = func.path, call.lineno
            msg = f"{reason} while holding a lock"
        key = (path, line)
        if key in self._blocked_sites:
            return
        self._blocked_sites.add(key)
        self.blocking.append(Finding(
            "DL116", path, line,
            f"{msg} — every other thread contending for the lock "
            "blocks for as long as the wait does (a dead peer makes "
            "that forever), freezing the whole plane. Move the wait "
            "outside the lock (snapshot state under the lock, wait "
            "after releasing, like checkpointing.AsyncSnapshotPlane) "
            f"or bound it with a timeout ({_DOC}#dl116)."))


def _wait_receiver_name_any(call: ast.Call) -> Optional[str]:
    """Terminal receiver name for any attribute call (no method-name
    filter — used for ``.join()``)."""
    recv = call.func.value
    if isinstance(recv, ast.Name):
        return recv.id
    if isinstance(recv, ast.Attribute):
        return recv.attr
    return None


def _fmt_lock(lid: LockId) -> str:
    kind, owner, name = lid
    if kind == "cls":
        return f"{owner.split(':', 1)[-1]}.{name}"
    if kind == "mod":
        return f"{owner}.{name}"
    if kind == "obj":
        return f"{owner}.{name}"
    return name


def _analysis_for(project: Project) -> LockAnalysis:
    cached = getattr(project, "_lock_analysis", None)
    if cached is None:
        cached = LockAnalysis(project)
        cached.run()
        project._lock_analysis = cached
    return cached


def check_lock_order_inversion(project: Project) -> List[Finding]:
    la = _analysis_for(project)
    findings: List[Finding] = []
    reported: Set[frozenset] = set()
    for a in sorted(la.edges, key=repr):
        for b in sorted(la.edges[a], key=repr):
            if a == b:
                # re-entry: only a deadlock for a plain Lock
                if la.ctors.get(a) == "Lock":
                    path, line, chain = la.anchors[(a, a)]
                    via = f" (via call chain '{chain}')" if chain else ""
                    findings.append(Finding(
                        "DL115", path, line,
                        f"non-reentrant lock '{_fmt_lock(a)}' is "
                        f"acquired again while already held{via} — "
                        "threading.Lock does not re-enter; this "
                        "thread deadlocks on itself. Use an RLock or "
                        "restructure so the inner path doesn't "
                        f"re-acquire ({_DOC}#dl115)."))
                continue
            if a not in la.edges.get(b, ()):  # need b→a too for a cycle
                continue
            pair = frozenset((a, b))
            if pair in reported:
                continue
            reported.add(pair)
            pa, la_line, ca = la.anchors[(a, b)]
            pb, lb_line, _cb = la.anchors[(b, a)]
            via = f" via '{ca}'" if ca else ""
            findings.append(Finding(
                "DL115", pa, la_line,
                f"lock-order inversion: '{_fmt_lock(a)}' is held while "
                f"acquiring '{_fmt_lock(b)}' here{via}, but "
                f"{pb}:{lb_line} acquires them in the opposite order — "
                "two threads interleaving those paths deadlock "
                "holding one lock each. Pick one global order "
                f"(docs/serving.md) and re-nest ({_DOC}#dl115)."))
    return findings


def check_blocking_call_under_lock(project: Project) -> List[Finding]:
    return list(_analysis_for(project).blocking)


register(Rule("DL115", "lock-order-inversion", f"{_DOC}#dl115",
              check_lock_order_inversion, kind="project"))
register(Rule("DL116", "blocking-call-under-lock", f"{_DOC}#dl116",
              check_blocking_call_under_lock, kind="project"))
