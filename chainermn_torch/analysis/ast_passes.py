"""dlint AST passes for the port: the distributed-correctness source rules.

Counterpart of ``chainermn_tpu/analysis/ast_passes.py``. Each pass is a
function ``(tree, src, path) -> [Finding]`` registered in
:data:`chainermn_torch.analysis.core.RULES`. Where a rule depends on the
framework only through a set of names, the port's set is the JAX
package's set plus what the port calls (``torch.distributed``'s
collectives, ``new_group`` — collective over the whole world —, the
communicator's flat reducers, ``host_barrier``, the eager receives
``recv_tree``/``try_recv_obj``/``exchange``, ``isend``/``irecv``, the
CUDA syncs), so code in either idiom trips the rule on the same line. The
rules encode these failure shapes:

* DL101 — a *collective* reachable under rank-dependent control flow is
  the classic deadlock shape: some ranks enter the collective, the rest
  never do, and everyone blocks (SURVEY.md §3.3's MPI order discipline).
* DL102 — eager-P2P channels are keyed ``(tag, src, dst)``
  (``XlaCommunicator._p2p_tag``); two subsystems registering the same
  key interleave their messages, and the ``eagergrad.*`` namespace is
  reserved for autograd's reverse transport (functions/eager_p2p.py).
* DL103 — two rank spaces exist: array-collective roots are communicator
  ranks (dense in ``[0, size)``), object-collective roots are *process*
  indices. Passing one where the other belongs addresses the wrong peer
  or exceeds the communicator (VERDICT r5 weak #6).
* DL104 — a loop dispatching steps without a per-iteration sync piles up
  asynchronous CUDA and NCCL work until a collective's watchdog aborts
  the process; a scalar pull (``.item()``), ``.cpu()``,
  ``torch.cuda.synchronize()`` or a ``Work.wait()`` retires it.
* DL105 — the object plane converts a detected peer death into
  ``JobAbortedError`` (comm/object_plane.py's poison key + fail-fast
  probes). A ``try`` that swallows it around ``send_obj``/``recv_obj``/
  ``bcast_obj`` turns the bounded abort back into the infinite hang the
  resilience layer exists to prevent (docs/fault_tolerance.md).

Known limits, by design (documented in docs/static_analysis.md): the
passes are intra-file and intra-function — no cross-module call graph,
no dataflow beyond single-assignment taint — so they over-approximate
reachability (a flagged call may be dynamically dead) and miss
divergence routed through helper functions. Suppress intentional sites
with ``# dlint: disable=RULE`` plus a rationale.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from chainermn_torch.analysis.core import Finding, Rule, register

_DOC = "docs/static_analysis_torch.md"

# -- what counts as rank-dependent ------------------------------------------

#: attribute reads that differ per rank/process (sizes deliberately
#: excluded: size/inter_size/intra_size are equal on every rank)
RANK_ATTRS = {
    "rank", "inter_rank", "intra_rank", "global_index", "is_master",
    "process_index",
}

#: calls whose value differs per rank/process (``dist.get_rank()`` is the
#: port's world rank)
RANK_CALLS = {"process_index", "axis_index", "get_rank"}

#: environment variables that hold a rank (``os.environ["RANK"]``,
#: ``os.environ.get("LOCAL_RANK")``, ``os.getenv("RANK")``)
RANK_ENV = {"RANK", "LOCAL_RANK"}

# -- what counts as a collective --------------------------------------------

#: symmetric collectives: EVERY rank of the communicator must call them
SYMMETRIC_COLLECTIVES = {
    "psum", "pmean", "pmax", "pmin", "psum_scatter", "all_gather",
    "all_to_all", "ppermute", "pbroadcast",
    "allreduce", "allreduce_grad", "allgather", "alltoall",
    "bcast", "bcast_data", "gather", "scatter", "barrier",
    "bcast_obj", "gather_obj", "allgather_obj", "allreduce_obj",
    "scatter_obj",
    "broadcast_one_to_all", "sync_global_devices", "process_allgather",
    # torch.distributed, the port's communicator and its host plane
    "all_reduce", "broadcast", "all_gather_into_tensor",
    "reduce_scatter_tensor", "reduce_scatter", "all_to_all_single",
    "broadcast_object_list", "all_gather_object", "gather_object",
    "scatter_object_list", "new_group", "over_mesh", "reduce_flat",
    "reduce_scatter_flat", "all_gather_flat", "host_barrier",
}

#: point-to-point: pairwise, so a rank-dependent branch is fine as long
#: as the *sibling* branch also communicates (the send/recv pattern)
P2P_CALLS = {"send", "recv", "send_obj", "recv_obj",
             "eager_send", "eager_recv",
             "recv_tree", "try_recv_obj", "isend", "irecv", "exchange"}

#: sync markers that retire a dispatched step (DL104)
SYNC_CALLS = {
    "float", "int", "asarray", "array", "block_until_ready",
    "device_get", "item", "tolist", "barrier", "sync_global_devices",
    "wait_until_ready", "effects_barrier", "copy_to_host_async",
    # torch: a CUDA/event/stream sync, a host copy, a Work's wait
    "synchronize", "cpu", "numpy", "wait",
}


def _callee_name(call: ast.Call) -> Optional[str]:
    """Terminal name of the called thing: ``comm.send`` -> ``send``."""
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _walk_excluding_defs(nodes: Iterable[ast.AST]):
    """Walk statements/expressions, NOT descending into nested function
    or class definitions (their bodies run at some other time)."""
    stack = list(nodes)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            stack.append(child)


def _is_rank_env(n: ast.AST) -> bool:
    """``os.environ["RANK"]``, ``os.environ.get("RANK")`` or
    ``os.getenv("LOCAL_RANK")``: a rank read from the launcher's
    environment."""
    key = None
    if (isinstance(n, ast.Subscript) and isinstance(n.value, ast.Attribute)
            and n.value.attr == "environ"):
        key = n.slice
    elif isinstance(n, ast.Call) and n.args:
        fn = n.func
        if isinstance(fn, ast.Attribute) and (
                fn.attr == "getenv"
                or (fn.attr == "get" and isinstance(fn.value, ast.Attribute)
                    and fn.value.attr == "environ")):
            key = n.args[0]
    return (isinstance(key, ast.Constant) and key.value in RANK_ENV)


def _contains_rank_source(node: ast.AST, tainted: Set[str]) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in RANK_ATTRS:
            return True
        if _is_rank_env(n):
            return True
        if isinstance(n, ast.Call):
            name = _callee_name(n)
            if name in RANK_CALLS:
                return True
        if isinstance(n, ast.Name) and n.id in tainted:
            return True
    return False


def _tainted_names(func_body: List[ast.stmt]) -> Set[str]:
    """Single-assignment taint: local names whose RHS reads a rank
    source. One pass, then a propagation sweep so chains like
    ``r = comm.rank; me = r`` taint both."""
    tainted: Set[str] = set()
    assigns: List[Tuple[Set[str], ast.AST]] = []
    for node in _walk_excluding_defs(func_body):
        targets: List[ast.expr] = []
        value: Optional[ast.AST] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        elif isinstance(node, ast.AugAssign):
            targets, value = [node.target], node.value
        if value is None:
            continue
        names = {t.id for t in targets if isinstance(t, ast.Name)}
        if names:
            assigns.append((names, value))
    changed = True
    while changed:
        changed = False
        for names, value in assigns:
            if names <= tainted:
                continue
            if _contains_rank_source(value, tainted):
                tainted |= names
                changed = True
    return tainted


def _collective_calls(nodes: List[ast.stmt]) -> List[Tuple[str, ast.Call]]:
    out = []
    for n in _walk_excluding_defs(nodes):
        if isinstance(n, ast.Call):
            name = _callee_name(n)
            if name in SYMMETRIC_COLLECTIVES or name in P2P_CALLS:
                out.append((name, n))
    return out


def _function_scopes(tree: ast.AST):
    """Yield (body, is_module) for the module and each function —
    the taint scope DL101 analyzes within."""
    yield list(getattr(tree, "body", [])), True
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.body, False


# ---------------------------------------------------------------------------
# DL101 — divergent collective under rank-dependent control flow
# ---------------------------------------------------------------------------


_TERMINATORS = (ast.Return, ast.Raise, ast.Continue, ast.Break)


def _terminates(stmts: List[ast.stmt]) -> bool:
    """Does the branch end by leaving the enclosing block? A terminating
    rank guard (``if rank == root: ...; return``) makes the code AFTER
    the If the implicit else branch — the fallthrough only runs on the
    other ranks."""
    return bool(stmts) and isinstance(stmts[-1], _TERMINATORS)


def _child_blocks(stmt: ast.stmt) -> List[List[ast.stmt]]:
    """Statement lists nested directly under ``stmt`` (loop/with/try/if
    bodies), NOT descending into function or class definitions."""
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return []
    blocks = []
    for name in ("body", "orelse", "finalbody"):
        b = getattr(stmt, name, None)
        if isinstance(b, list) and b:
            blocks.append(b)
    for h in getattr(stmt, "handlers", []) or []:
        blocks.append(h.body)
    return blocks


def _check_branch(calls, other, path, findings):
    other_names = {n for n, _ in other}
    other_has_p2p = bool(other_names & P2P_CALLS)
    for name, call in calls:
        if name in SYMMETRIC_COLLECTIVES:
            # symmetric: every rank must reach the SAME collective —
            # the sibling branch must call it too
            ok = name in other_names
            shape = (f"collective '{name}' is only reached by some "
                     "ranks (the sibling branch never calls it)")
        else:
            # P2P: pairwise — the sibling branch (or, after a
            # terminating guard, the fallthrough) must communicate at
            # all (send<->recv pairing)
            ok = other_has_p2p
            shape = (f"point-to-point '{name}' has no matching "
                     "send/recv on the sibling path, so the peer "
                     "rank never enters the transport")
        if not ok:
            findings.append(Finding(
                "DL101", path, call.lineno,
                f"{shape}; ranks that skip it leave the others "
                "blocked in the rendezvous (deadlock). Hoist the call "
                "out of the rank-dependent branch, or make every "
                f"branch call it (see {_DOC}#dl101).",
            ))


def _visit_block(stmts, tainted, path, findings):
    for i, stmt in enumerate(stmts):
        if (isinstance(stmt, ast.If)
                and _contains_rank_source(stmt.test, tainted)):
            remainder = stmts[i + 1:]
            body_calls = _collective_calls(stmt.body)
            orelse_calls = _collective_calls(stmt.orelse)
            rem_calls = _collective_calls(remainder)
            _check_branch(
                body_calls,
                orelse_calls + (rem_calls if _terminates(stmt.body)
                                else []),
                path, findings)
            _check_branch(
                orelse_calls,
                body_calls + (rem_calls if _terminates(stmt.orelse)
                              else []),
                path, findings)
        for block in _child_blocks(stmt):
            _visit_block(block, tainted, path, findings)


def check_divergent_collective(tree, src, path) -> List[Finding]:
    findings: List[Finding] = []
    for body, _ in _function_scopes(tree):
        tainted = _tainted_names(body)
        _visit_block(body, tainted, path, findings)
    return findings


register(Rule("DL101", "divergent-collective", f"{_DOC}#dl101",
              check_divergent_collective))


# ---------------------------------------------------------------------------
# DL102 — eager-P2P channel-tag collision
# ---------------------------------------------------------------------------

_GRAD_NS = "eagergrad"

#: keywords that claim a ``.send``/``.recv`` as a rank-addressed message
#: (``dst`` is ``torch.distributed``'s)
_ENDPOINT_KWS = ("dest", "src", "as_rank", "dst")


def _kw(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _literal(node: Optional[ast.expr]):
    """The literal value of a Constant node (including a negated numeric
    one — ``-1`` parses as ``UnaryOp(USub, Constant(1))``), else None."""
    if isinstance(node, ast.Constant):
        return node.value
    if (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
            and isinstance(node.operand, ast.Constant)
            and isinstance(node.operand.value, (int, float))):
        return -node.operand.value
    return None


def _arg_or_kw(call: ast.Call, pos: int, name: str) -> Optional[ast.expr]:
    kw = _kw(call, name)
    if kw is not None:
        return kw
    if len(call.args) > pos:
        return call.args[pos]
    return None


def check_channel_tag_collision(tree, src, path) -> List[Finding]:
    findings: List[Finding] = []
    # map each line to its innermost enclosing function (for scope
    # grouping: two sends in ONE function are sequential on an ordered
    # channel — fine; the same channel from two different scopes is a
    # concurrency hazard)
    func_of_line: Dict[int, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            end = getattr(node, "end_lineno", node.lineno)
            for ln in range(node.lineno, end + 1):
                # innermost wins: later (deeper) defs overwrite
                func_of_line[ln] = f"{node.name}@{node.lineno}" \
                    if func_of_line.get(ln) is None or True else \
                    func_of_line[ln]
    # registrations: channel key -> list of (scope, call, kind)
    sends: Dict[tuple, List[tuple]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _callee_name(node)
        tag_node = None
        endpoint = None  # the literal dest/src/rank, if any
        kind = None
        if name in ("send", "recv"):
            ep_name = "dest" if name == "send" else "src"
            ep = _arg_or_kw(node, 1 if name == "send" else 0, ep_name)
            tag_node = _kw(node, "tag")
            if tag_node is None and name == "send" and len(node.args) > 2:
                tag_node = node.args[2]
            if tag_node is None and name == "recv" and len(node.args) > 1:
                tag_node = node.args[1]
            # gate: plain socket/generator .send/.recv carry neither a
            # tag nor a dest/src keyword — require one to claim the call
            if tag_node is None and not any(
                    kw.arg in _ENDPOINT_KWS for kw in node.keywords):
                continue
            endpoint = _literal(ep)
            kind = "array"
        elif name in ("send_obj", "recv_obj"):
            # (a bounded try_recv_obj polls a channel without owning it:
            # probes of one channel from several scopes are the planes'
            # idiom, so it registers nothing here)
            ep = _arg_or_kw(node, 1 if name == "send_obj" else 0,
                            "dest" if name == "send_obj" else "src")
            tag_node = _arg_or_kw(node, 2 if name == "send_obj" else 1,
                                  "tag")
            endpoint = _literal(ep)
            kind = "obj"
        elif name in ("eager_send", "eager_recv", "recv_tree"):
            # eager_send(x, comm, rank, tag=..) / eager_recv(comm, rank,
            # ..., tag=..) / recv_tree(comm, rank, anchor, tag=..) — all
            # lower onto comm.send/recv channels, so they share the
            # "array" channel space
            ep = _arg_or_kw(node, 2 if name == "eager_send" else 1,
                            "rank")
            tag_node = _kw(node, "tag")
            endpoint = _literal(ep)
            kind = "eager"
        else:
            continue
        tag = _literal(tag_node) if tag_node is not None else (
            0 if _kw(node, "tag") is None and tag_node is None else None)
        if isinstance(tag, str) and tag.split(".")[0] == _GRAD_NS:
            findings.append(Finding(
                "DL102", path, node.lineno,
                f"tag {tag!r} enters the reserved '{_GRAD_NS}.*' channel "
                "namespace — autograd's reverse transport for "
                "eager_send/eager_recv rides it "
                "(functions/eager_p2p.py); user traffic there corrupts "
                f"backward transfers. Pick another tag ({_DOC}#dl102).",
            ))
            continue
        if tag is None or endpoint is None:
            continue  # not statically known — nothing to compare
        direction = "send" if name in ("send", "send_obj",
                                       "eager_send") else "recv"
        space = "obj" if kind == "obj" else "array"
        key = (space, direction, tag, endpoint)
        scope = func_of_line.get(node.lineno, "<module>")
        sends.setdefault(key, []).append((scope, node, kind))
    for (space, direction, tag, endpoint), regs in sends.items():
        if len(regs) < 2:
            continue
        scopes = {s for s, _, _ in regs}
        kinds = {k for _, _, k in regs}
        # same channel from two scopes, or mixed raw/autograd use of one
        # channel, is a collision; N calls in one scope are sequential
        # messages on one ordered channel — legitimate
        if len(scopes) < 2 and not (kinds == {"array", "eager"}):
            continue
        first = min(regs, key=lambda r: r[1].lineno)
        for scope, call, kind in regs:
            if call is first[1]:
                continue
            findings.append(Finding(
                "DL102", path, call.lineno,
                f"channel (tag={tag!r}, "
                f"{'dst' if direction == 'send' else 'src'}={endpoint}) "
                f"is already registered at line {first[1].lineno}"
                + (" by the autograd eager-P2P path"
                   if "eager" in kinds and kind != "eager" else "")
                + "; concurrent traffic on one ordered channel "
                "interleaves messages between consumers. Use a distinct "
                f"tag per subsystem ({_DOC}#dl102).",
            ))
    return findings


register(Rule("DL102", "channel-tag-collision", f"{_DOC}#dl102",
              check_channel_tag_collision))


# ---------------------------------------------------------------------------
# DL103 — root argument from the wrong rank space
# ---------------------------------------------------------------------------

#: in the port EVERY root is a communicator rank, dense in [0, size):
#: the object collectives run over the communicator's own gloo group and
#: check their root as the array ones do (``comm/distributed.py``
#: ``_check_root``), where the JAX package's take process indices
ARRAY_ROOT_CALLS = {"bcast", "gather", "scatter", "bcast_data"}
OBJ_ROOT_CALLS = {"bcast_obj", "gather_obj", "scatter_obj"}
ROOT_CALLS = ARRAY_ROOT_CALLS | OBJ_ROOT_CALLS

#: rank-space sources that are NOT communicator ranks: world positions
#: (``global_index``, ``dist.get_rank()``, ``$RANK``), the node index
_NON_COMM_RANK = {"global_index", "inter_rank", "process_index",
                  "get_rank"}


def _root_expr(call: ast.Call) -> Optional[ast.expr]:
    kw = _kw(call, "root")
    if kw is not None:
        return kw
    if len(call.args) > 1:
        return call.args[1]
    return None


def check_root_invariant(tree, src, path) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _callee_name(node)
        if name not in ROOT_CALLS:
            continue
        bad_attrs, space, right = (
            _NON_COMM_RANK, "communicator-rank",
            "comm.rank (dense in [0, size)) or a literal below size")
        root = _root_expr(node)
        if root is None:
            continue
        lit = _literal(root)
        if isinstance(lit, int) and lit < 0:
            findings.append(Finding(
                "DL103", path, node.lineno,
                f"negative root {lit} passed to {name}() — roots are "
                f"{space} values, never negative ({_DOC}#dl103)."))
            continue
        for n in ast.walk(root):
            bad = None
            if isinstance(n, ast.Attribute) and n.attr in bad_attrs:
                bad = n.attr
            elif (isinstance(n, ast.Call)
                  and _callee_name(n) in bad_attrs):
                bad = _callee_name(n)
            elif _is_rank_env(n):
                bad = "the launcher's $RANK"
            if bad is not None:
                findings.append(Finding(
                    "DL103", path, node.lineno,
                    f"root of {name}() is derived from '{bad}', which is "
                    f"not a {space} value — on a sub-communicator "
                    "(split, over_mesh) a world position can exceed the "
                    f"valid root range or address the wrong peer. Use "
                    f"{right} "
                    f"({_DOC}#dl103)."))
                break
    return findings


register(Rule("DL103", "root-rank-space", f"{_DOC}#dl103",
              check_root_invariant))


# ---------------------------------------------------------------------------
# DL104 — step-dispatch loop without a per-iteration sync
# ---------------------------------------------------------------------------


#: factories RETURN a step function; calling one dispatches nothing
_FACTORY_PREFIXES = ("make_", "build_", "create_", "get_")


def _is_step_call(call: ast.Call) -> bool:
    name = _callee_name(call)
    if name is None:
        return False
    if name.startswith(_FACTORY_PREFIXES):
        return False
    if name.startswith("on_"):
        return False  # event hooks (chaos.on_step) dispatch no compute
    return (name in ("step", "step_fn", "train_step")
            or name.endswith("_step"))


def _has_sync(nodes: List[ast.stmt]) -> bool:
    for n in _walk_excluding_defs(nodes):
        if isinstance(n, ast.Call) and _callee_name(n) in SYNC_CALLS:
            return True
    return False


def check_unsynced_step_loop(tree, src, path) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.For, ast.While)):
            continue
        step_calls = [
            n for n in _walk_excluding_defs(node.body)
            if isinstance(n, ast.Call) and _is_step_call(n)
        ]
        if not step_calls:
            continue
        if _has_sync(node.body):
            continue
        first = min(step_calls, key=lambda c: c.lineno)
        findings.append(Finding(
            "DL104", path, first.lineno,
            "loop dispatches a step with no per-iteration sync "
            "(float(loss), .item(), .cpu(), torch.cuda.synchronize(), "
            "work.wait(), ...): asynchronous CUDA and NCCL work piles "
            "up until a collective's timeout aborts the process. Pull "
            f"a scalar or synchronize inside the loop ({_DOC}#dl104)."))
    return findings


register(Rule("DL104", "unsynced-step-loop", f"{_DOC}#dl104",
              check_unsynced_step_loop))


# ---------------------------------------------------------------------------
# DL105 — unguarded object-plane call (handler swallows JobAbortedError)
# ---------------------------------------------------------------------------

#: object-plane entry points whose guarded waits raise JobAbortedError on
#: peer death / coordinator loss
OBJ_PLANE_CALLS = {
    "send_obj", "recv_obj", "bcast_obj", "gather_obj", "allgather_obj",
    "allreduce_obj", "scatter_obj",
}

#: exception names that catch JobAbortedError: itself, or any ancestor on
#: its MRO (JobAbortedError -> RuntimeError -> Exception -> BaseException)
_ABORT_CATCHERS = {
    "JobAbortedError", "RuntimeError", "Exception", "BaseException",
}


def _handler_catches_abort(handler: ast.ExceptHandler) -> bool:
    """Does this handler's type clause catch JobAbortedError? A bare
    ``except:`` does; so does any name on its MRO or a tuple containing
    one."""
    t = handler.type
    if t is None:
        return True  # bare except
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for node in types:
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name in _ABORT_CATCHERS:
            return True
    return False


def _walk_statements(stmts: List[ast.stmt]):
    """Like :func:`_walk_excluding_defs`, but also skips defs appearing
    DIRECTLY in ``stmts`` (their bodies run at some other time)."""
    live = [s for s in stmts
            if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda))]
    return _walk_excluding_defs(live)


def _handler_swallows(handler: ast.ExceptHandler) -> bool:
    """A handler swallows the abort when no path through its body leaves
    by raising — a ``raise`` anywhere in the body (re-raise or wrap)
    counts as propagating. Over-approximation: a conditional raise is
    treated as propagating."""
    for n in _walk_statements(handler.body):
        if isinstance(n, ast.Raise):
            return False
    return True


def check_unguarded_object_plane(tree, src, path) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        swallowing = [
            h for h in node.handlers
            if _handler_catches_abort(h) and _handler_swallows(h)
        ]
        if not swallowing:
            continue
        for n in _walk_statements(node.body):
            if not isinstance(n, ast.Call):
                continue
            name = _callee_name(n)
            if name not in OBJ_PLANE_CALLS:
                continue
            h = swallowing[0]
            catches = ("bare 'except:'" if h.type is None else
                       f"'except {ast.unparse(h.type)}' at line "
                       f"{h.lineno}")
            findings.append(Finding(
                "DL105", path, n.lineno,
                f"object-plane call '{name}' sits in a try whose "
                f"{catches} swallows JobAbortedError — the abort a "
                "watchdog or poison key raises when a peer dies. "
                "Swallowing it turns detected peer death back into a "
                "silent hang (the surviving ranks keep waiting at the "
                "next collective). Re-raise JobAbortedError, or narrow "
                f"the except clause ({_DOC}#dl105)."))
    return findings


register(Rule("DL105", "unguarded-object-plane-call", f"{_DOC}#dl105",
              check_unguarded_object_plane))


# ---------------------------------------------------------------------------
# DL106 — hand-rolled gradient collective bypassing GradReducer
# ---------------------------------------------------------------------------

#: raw reduction primitives a train step should route through a
#: GradReducer (pmean/all_gather excluded: metrics and param gathers);
#: ``torch.distributed``'s two gradient reductions beside JAX's
GRAD_COLLECTIVES = {"psum", "psum_scatter", "all_reduce",
                    "reduce_scatter_tensor"}

#: gradient producers: assignments whose RHS calls these taint targets
#: (``jax.grad`` and ``torch.autograd.grad`` alike)
_GRAD_SOURCES = {"grad", "value_and_grad"}


def _reads_grad_attr(expr: ast.AST) -> bool:
    """Does ``expr`` read a ``.grad`` attribute — a parameter's gradient
    after ``.backward()`` (``p.grad``), not a called ``jax.grad``?"""
    called = {id(n.func) for n in ast.walk(expr) if isinstance(n, ast.Call)}
    return any(isinstance(n, ast.Attribute) and n.attr == "grad"
               and id(n) not in called for n in ast.walk(expr))


def _grad_tainted_names(func: ast.AST) -> Set[str]:
    """Names holding gradients inside one step function's subtree
    (nested closures included — the scan/micro bodies gradients flow
    into). Sources are ``jax.grad``/``jax.value_and_grad`` results; for
    the 2-tuple ``value_and_grad`` unpack only the gradient half taints
    (the loss/aux half feeds metric psums legitimately). Propagates
    through assignments, for-loops, and comprehension binders."""
    tainted: Set[str] = set()
    flows: List[Tuple[Set[str], ast.AST]] = []
    for node in ast.walk(func):
        targets: List[ast.expr] = []
        value: Optional[ast.AST] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        elif isinstance(node, ast.AugAssign):
            targets, value = [node.target], node.value
        elif isinstance(node, ast.For):
            targets, value = [node.target], node.iter
        elif isinstance(node, (ast.ListComp, ast.SetComp,
                               ast.GeneratorExp, ast.DictComp)):
            for comp in node.generators:
                names = {n.id for n in ast.walk(comp.target)
                         if isinstance(n, ast.Name)}
                if names:
                    flows.append((names, comp.iter))
            continue
        elif isinstance(node, ast.Call):
            # tree_map(lambda g: ..., grads): the mapped-over tree's
            # taint enters through the lambda's parameters
            lams = [a for a in node.args if isinstance(a, ast.Lambda)]
            others = ([a for a in node.args
                       if not isinstance(a, ast.Lambda)]
                      + [kw.value for kw in node.keywords])
            if lams and others:
                carrier = ast.Tuple(elts=others, ctx=ast.Load())
                for lam in lams:
                    names = {a.arg for a in lam.args.args}
                    if names:
                        flows.append((names, carrier))
            continue
        if value is None:
            continue
        src_kind = next(
            (_callee_name(n) for n in ast.walk(value)
             if isinstance(n, ast.Call)
             and _callee_name(n) in _GRAD_SOURCES), None)
        if src_kind is not None:
            grad_targets = targets
            if (src_kind == "value_and_grad" and len(targets) == 1
                    and isinstance(targets[0], ast.Tuple)
                    and len(targets[0].elts) == 2):
                grad_targets = [targets[0].elts[1]]
            for t in grad_targets:
                tainted |= {n.id for n in ast.walk(t)
                            if isinstance(n, ast.Name)}
            continue
        names = {n.id for t in targets for n in ast.walk(t)
                 if isinstance(n, ast.Name)}
        if names:
            flows.append((names, value))

    def _reads_tainted(expr: ast.AST) -> bool:
        return _reads_grad_attr(expr) or any(
            isinstance(n, ast.Name) and n.id in tainted
            for n in ast.walk(expr))

    changed = True
    while changed:
        changed = False
        for names, value in flows:
            if names <= tainted:
                continue
            if _reads_tainted(value):
                tainted |= names
                changed = True
    return tainted


def check_handrolled_grad_collective(tree, src, path) -> List[Finding]:
    findings: List[Finding] = []
    if "collectives" in path.replace("\\", "/").split("/")[:-1]:
        return findings        # the reducers themselves
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if "step" not in node.name:
            continue
        tainted = _grad_tainted_names(node)
        for n in ast.walk(node):
            if not (isinstance(n, ast.Call)
                    and _callee_name(n) in GRAD_COLLECTIVES):
                continue
            exprs = list(n.args) + [kw.value for kw in n.keywords]
            if any(_reads_grad_attr(e) for e in exprs) or any(
                    isinstance(x, ast.Name) and x.id in tainted
                    for e in exprs for x in ast.walk(e)):
                findings.append(Finding(
                    "DL106", path, n.lineno,
                    f"hand-rolled '{_callee_name(n)}' on a gradient "
                    "inside a train step bypasses the GradReducer "
                    "strategy registry: the reduction algorithm stops "
                    "being selectable (hierarchical/quantized/auto), "
                    "invisible to ReductionReport, and numerically "
                    "unaudited against the flat reference. Route it "
                    "through grad_reducer= / comm.allreduce_grad() / "
                    "reducer.reduce() or reducer.reduce_scatter_flat() "
                    f"({_DOC}#dl106)."))
    return findings


register(Rule("DL106", "handrolled-grad-collective", f"{_DOC}#dl106",
              check_handrolled_grad_collective))


# ---------------------------------------------------------------------------
# DL107 — stale-schedule-profile
# ---------------------------------------------------------------------------

#: ProfileDB lookups whose first argument is the topology (fingerprint)
_PROFILE_LOOKUPS = {"plan_for", "measured_for"}


def check_stale_schedule_profile(tree, src, path) -> List[Finding]:
    """A profile-DB lookup keyed by a HARD-CODED fingerprint string.

    The schedtune profile DB (docs/tuning.md) keys plans by
    ``Topology.fingerprint()`` — platform, device kind, per-tier sizes.
    ``db.plan_for("tpu:v5e/ici:4+dcn:2")`` pins the lookup to the
    machine the string was copied from: on any other mesh it either
    misses (silently untuned) or, worse, returns a plan tuned for
    different hardware, and bucket sizes/strategy mis-tune with no
    error. Derive the key from the live mesh —
    ``db.plan_for(Topology.from_comm(comm))`` — or let
    ``create_multi_node_optimizer(tune=...)`` resolve it, which also
    REFUSES a fingerprint mismatch at runtime. Intra-function only: a
    literal laundered through a variable is not tracked (documented
    limit, ``{_DOC}#dl107``).
    """
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _callee_name(node) in _PROFILE_LOOKUPS):
            continue
        arg = _arg_or_kw(node, 0, "topology")
        val = _literal(arg)
        if isinstance(val, str):
            findings.append(Finding(
                "DL107", path, node.lineno,
                f"profile lookup '{_callee_name(node)}' keyed by the "
                f"hard-coded topology fingerprint {val!r}: a profile "
                "tuned on one machine silently mis-tunes any other "
                "mesh. Build the key from the live communicator "
                "(Topology.from_comm(comm)) or use "
                "create_multi_node_optimizer(tune=...), which verifies "
                f"the fingerprint at runtime ({_DOC}#dl107)."))
    return findings


register(Rule("DL107", "stale-schedule-profile", f"{_DOC}#dl107",
              check_stale_schedule_profile))


# DL108 (decode-step-recompile) has no port form: the port compiles
# nothing (core.NOT_APPLICABLE).

#: wrappers that compile their argument into a fresh executable (JAX's
#: names, kept so DL109 reads code in either idiom)
_JIT_WRAPPERS = {"jit", "pmap", "pjit"}


def _is_step_factory(call: ast.Call) -> bool:
    """A port step factory (``make_data_parallel_train_step``,
    ``make_fsdp_train_step``, ...): its result dispatches a step."""
    name = _callee_name(call)
    return bool(name) and name.startswith("make_") and "step" in name


def _jit_bound_names(tree: ast.AST) -> Set[str]:
    """Names assigned from a ``jit``/``pmap``/``pjit`` wrapper or from a
    port step factory anywhere in the file — the step functions DL109
    counts as a loop's training step."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if any(isinstance(n, ast.Call)
               and (_callee_name(n) in _JIT_WRAPPERS
                    or _is_step_factory(n))
               for n in ast.walk(node.value)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


# ---------------------------------------------------------------------------
# DL109 — blocking-save-in-step-loop
# ---------------------------------------------------------------------------

#: constructors whose result is a SYNCHRONOUS checkpointer (save() runs
#: device-get + serialize + fsync + SHA-256 on the calling thread)
_CKPT_FACTORIES = {"create_multi_node_checkpointer",
                   "MultiNodeCheckpointer"}


def _async_plane_available() -> bool:
    """Is the async snapshot plane shipped alongside this analysis
    package? File-existence probe on purpose — importing
    ``chainermn_torch.checkpointing`` would drag torch into a pass suite
    that deliberately runs on bare ASTs (here: torch)."""
    import os

    pkg = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "checkpointing", "async_plane.py")
    return os.path.exists(pkg)


def _ckpt_bound_names(tree: ast.AST) -> Set[str]:
    """Names assigned DIRECTLY from a synchronous-checkpointer
    constructor anywhere in the file (same intra-file tracking contract
    as :func:`_jit_bound_names`). Only the OUTERMOST call counts:
    ``plane = AsyncSnapshotPlane(MultiNodeCheckpointer(...))`` binds a
    plane, not a checkpointer — that IS the fix this rule points at."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if (isinstance(node.value, ast.Call)
                and _callee_name(node.value) in _CKPT_FACTORIES):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


def check_blocking_save_in_step_loop(tree, src, path) -> List[Finding]:
    """A synchronous ``checkpointer.save(...)`` on the step path.

    The sync save spends device-get + serialize + fsync + SHA-256 on
    the step thread — at a checkpoint cadence dense enough to survive
    preemption, that stall dominates the step
    (docs/fault_tolerance.md#checkpoint-cadence). Flagged when a name
    bound from ``create_multi_node_checkpointer`` /
    ``MultiNodeCheckpointer`` has ``.save(...)`` called inside a
    ``for``/``while`` loop that ALSO dispatches a training step (a call
    to a name bound from ``jit`` or from a ``make_*step*`` factory, or
    an ``.update()`` method call) — a plain
    save loop (tests, offline conversion) is not a step loop and stays
    clean. Fix: wrap the checkpointer in
    ``checkpointing.AsyncSnapshotPlane`` and call ``plane.save(...)``
    (or extend the plane on the Trainer); names bound from
    ``AsyncSnapshotPlane(...)`` are not tracked, so the fixed code
    passes. The rule only fires when the async plane ships next to this
    package (``chainermn_torch/checkpointing/``) — there is no fix to
    point at otherwise. Intra-file, like every pass here. Suppress a
    deliberate sync save (e.g. benchmarking the stall itself) with
    ``# dlint: disable=DL109``.
    """
    if not _async_plane_available():
        return []
    findings: List[Finding] = []
    ckpts = _ckpt_bound_names(tree)
    if not ckpts:
        return findings
    jitted = _jit_bound_names(tree)
    for loop in ast.walk(tree):
        if not isinstance(loop, (ast.For, ast.While)):
            continue
        calls = [n for n in _walk_excluding_defs(loop.body)
                 if isinstance(n, ast.Call)]
        steps = any(
            (_callee_name(n) in jitted)
            or (isinstance(n.func, ast.Attribute)
                and n.func.attr == "update")
            for n in calls)
        if not steps:
            continue
        for n in calls:
            if (isinstance(n.func, ast.Attribute)
                    and n.func.attr == "save"
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id in ckpts):
                findings.append(Finding(
                    "DL109", path, n.lineno,
                    f"synchronous '{n.func.value.id}.save(...)' inside "
                    "a step loop: the device-get + serialize + fsync + "
                    "SHA-256 all stall the step thread. Wrap the "
                    "checkpointer in checkpointing.AsyncSnapshotPlane "
                    "and save through the plane — the write pipeline "
                    "moves off the critical path and the stall drops "
                    "to a device-side copy dispatch "
                    f"({_DOC}#dl109)."))
    return findings


register(Rule("DL109", "blocking-save-in-step-loop", f"{_DOC}#dl109",
              check_blocking_save_in_step_loop))


# ---------------------------------------------------------------------------
# DL110 — per-token-host-sync
# ---------------------------------------------------------------------------

#: host materializers: calling one of these ON decode output pulls the
#: whole array across the device boundary
_HOST_PULLS = {"asarray", "device_get", "array"}
#: the same pulls as tensor methods (``logits.cpu()``, ``.tolist()``)
_HOST_PULL_METHODS = {"cpu", "tolist", "item", "numpy"}

#: callee-name fragments that mark a decode dispatch... and the exempt
#: fixed path: ``decode_k`` returns int32 token IDS (4 bytes/token) —
#: pulling those is the fix DL110 points at, not the bug
_DECODE_FRAGMENT = "decode"
_DECODE_EXEMPT = "decode_k"


def _is_decode_dispatch(call: ast.Call) -> bool:
    name = _callee_name(call)
    return (name is not None and _DECODE_FRAGMENT in name
            and _DECODE_EXEMPT not in name)


def _strip_subscripts(node: ast.expr) -> ast.expr:
    while isinstance(node, ast.Subscript):
        node = node.value
    return node


def check_per_token_host_sync(tree, src, path) -> List[Finding]:
    """Full decode logits pulled to the host inside a token loop.

    The serving invariant DL108's sibling (docs/serving.md): the decode
    hot loop's device→host traffic must not scale with the vocabulary.
    ``np.asarray(steps.decode(cur))`` (or ``jax.device_get`` /
    ``np.array`` of the same) inside a ``for``/``while`` loop ships the
    ``[n_slots, vocab]`` f32 logits across PCIe once per generated
    token — the transfer the on-device sampler
    (``serving/sampling.py``) exists to eliminate. Flagged shapes:

    * a direct pull — ``np.asarray(steps.decode(cur))`` — including
      through subscripts (``np.asarray(steps.decode(cur)[0])`` pulls
      the whole buffer before slicing);
    * a pull of a name assigned from a decode dispatch in the SAME loop
      (single-assignment taint, as everywhere in this suite).

    The port's form is the tensor method: ``steps.decode(cur).cpu()``,
    ``.tolist()``, ``.item()`` or ``.numpy()``.

    NOT flagged: reducing on device first and pulling the result —
    ``np.asarray(jnp.argmax(steps.decode(cur), -1))`` or
    ``steps.decode(cur).argmax(-1).cpu()`` moves ids only — and any
    callee whose name contains ``decode_k``: the
    multi-token program already returns token ids, so materializing its
    output IS the fixed pattern. Parity oracles that legitimately
    compare full logit rows (bitwise tests) suppress with
    ``# dlint: disable=DL110`` plus a rationale.
    """
    findings: List[Finding] = []
    seen: Set[Tuple[int, int]] = set()   # dedup nested-loop double walks
    for loop in ast.walk(tree):
        if not isinstance(loop, (ast.For, ast.While)):
            continue
        tainted: Set[str] = set()
        for n in _walk_excluding_defs(loop.body):
            if (isinstance(n, ast.Assign)
                    and isinstance(n.value, ast.Call)
                    and _is_decode_dispatch(n.value)):
                tainted |= {t.id for t in n.targets
                            if isinstance(t, ast.Name)}
        for n in _walk_excluding_defs(loop.body):
            if not isinstance(n, ast.Call):
                continue
            if (isinstance(n.func, ast.Attribute)
                    and n.func.attr in _HOST_PULL_METHODS):
                arg = _strip_subscripts(n.func.value)
            elif _callee_name(n) in _HOST_PULLS and n.args:
                arg = _strip_subscripts(n.args[0])
            else:
                continue
            direct = isinstance(arg, ast.Call) and _is_decode_dispatch(arg)
            named = isinstance(arg, ast.Name) and arg.id in tainted
            if not (direct or named):
                continue
            key = (n.lineno, n.col_offset)
            if key in seen:
                continue
            seen.add(key)
            findings.append(Finding(
                "DL110", path, n.lineno,
                f"'{_callee_name(n)}' materializes decode output on the "
                "host inside a token loop — the [n_slots, vocab] f32 "
                "logits cross PCIe once per generated token (vocab × 4 "
                "bytes/token; bench.py gates the decode path at ≤ 8). "
                "Sample on device (serving/sampling.py) and pull "
                "token ids via ServingStep.decode_k, or at least reduce "
                "on device first — logits.argmax(-1).cpu() moves ids "
                f"only ({_DOC}#dl110)."))
    return findings


register(Rule("DL110", "per-token-host-sync", f"{_DOC}#dl110",
              check_per_token_host_sync))


# ---------------------------------------------------------------------------
# DL111 — blocking-rpc-in-router-loop
# ---------------------------------------------------------------------------

#: blocking-wait methods a dispatch loop can wedge on
_WAIT_METHODS = {"result", "get", "wait"}

#: receiver-name fragments that mark a future/mailbox wait (``fut``
#: covers ``future``/``futures``; ``mail`` covers ``mailbox``); plain
#: ``dict.get(key)``-style calls don't match because they carry a
#: positional argument, and ``os.path.join``-alikes use other methods
_WAIT_RECEIVER_HINTS = ("queue", "mail", "fut", "inbox", "mbox")


def _wait_receiver_name(call: ast.Call) -> Optional[str]:
    """Terminal receiver name of ``<recv>.result()/.get()/.wait()``:
    ``fut.result`` → ``fut``, ``self._mail.get`` → ``_mail``."""
    if not isinstance(call.func, ast.Attribute):
        return None
    if call.func.attr not in _WAIT_METHODS:
        return None
    recv = call.func.value
    if isinstance(recv, ast.Name):
        return recv.id
    if isinstance(recv, ast.Attribute):
        return recv.attr
    return None


def _is_unbounded_wait(call: ast.Call) -> bool:
    """Unbounded = no positional deadline and no ``timeout=`` kwarg (or
    an explicit ``timeout=None``). ``get_nowait()``, ``result(
    timeout=probe)``, and ``join(timeout=30)`` all pass."""
    if call.args:
        return False
    for kw in call.keywords:
        if kw.arg == "timeout":
            return (isinstance(kw.value, ast.Constant)
                    and kw.value.value is None)
    return True


def check_blocking_rpc_in_router_loop(tree, src, path) -> List[Finding]:
    """Unbounded future/mailbox wait inside a dispatch loop.

    The fleet-router discipline (docs/serving.md): every wait inside a
    ``for``/``while`` dispatch loop must carry a deadline, because the
    thing being waited on is another replica — and replicas die. One
    ``inbox.get()`` or ``fut.result()`` with no timeout turns a single
    replica death into a frozen fleet: the loop never comes back to the
    health sweep that would have re-queued the dead replica's work.
    Flagged shape: ``<recv>.result()/.get()/.wait()`` where the
    receiver name names a future or mailbox (``queue``/``mail``/
    ``fut``/``inbox``/``mbox``) and the call is unbounded — no
    positional deadline, no ``timeout=`` kwarg, or an explicit
    ``timeout=None``.

    NOT flagged: ``get_nowait()`` (never blocks), any wait with a
    finite ``timeout=``, waits on receivers that aren't futures or
    mailboxes, and waits outside loops (a one-shot join at teardown is
    not a dispatch loop). The fixed patterns are ``fleet/router.py``'s:
    drain mailboxes with ``get_nowait()`` + idle sleep, and slice
    future waits at ``RpcPolicy.probe_ms``.
    """
    findings: List[Finding] = []
    seen: Set[Tuple[int, int]] = set()   # dedup nested-loop double walks
    for loop in ast.walk(tree):
        if not isinstance(loop, (ast.For, ast.While)):
            continue
        for n in _walk_excluding_defs(loop.body):
            if not isinstance(n, ast.Call):
                continue
            recv = _wait_receiver_name(n)
            if recv is None:
                continue
            if not any(h in recv.lower() for h in _WAIT_RECEIVER_HINTS):
                continue
            if not _is_unbounded_wait(n):
                continue
            key = (n.lineno, n.col_offset)
            if key in seen:
                continue
            seen.add(key)
            findings.append(Finding(
                "DL111", path, n.lineno,
                f"'{recv}.{n.func.attr}()' blocks without a deadline "
                "inside a dispatch loop — if the producer is a dead "
                "replica this wait never returns and the loop never "
                "reaches the health sweep that would re-queue its "
                "work. Bound it: get_nowait() + idle sleep for "
                "mailboxes, or slice the wait at RpcPolicy.probe_ms "
                f"like fleet.Router.result ({_DOC}#dl111)."))
    return findings


register(Rule("DL111", "blocking-rpc-in-router-loop", f"{_DOC}#dl111",
              check_blocking_rpc_in_router_loop))


# ---------------------------------------------------------------------------
# DL112 — asymmetric-tier-collective
# ---------------------------------------------------------------------------

#: jax.lax-style collectives whose second argument / ``axis_name=``
#: kwarg names the mesh axis the traffic moves over
_AXIS_COLLECTIVES = {
    "psum", "pmean", "pmax", "pmin", "psum_scatter", "all_gather",
    "all_to_all", "ppermute", "pbroadcast",
}


def _declared_tier_names(tree: ast.AST) -> Set[str]:
    """Names of every ``Tier("<name>", ...)`` declared in the module
    (string-constant first argument or ``name=`` kwarg only — a
    variable tier name can't be checked statically)."""
    out: Set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and _callee_name(n) == "Tier":
            name = _literal(_arg_or_kw(n, 0, "name"))
            if isinstance(name, str):
                out.add(name)
    return out


def _axis_name_constants(node: Optional[ast.expr]) -> List[str]:
    """String-constant axis names in an axis_name argument: a bare
    string, or every string element of a tuple/list of them."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [e.value for e in node.elts
                if isinstance(e, ast.Constant)
                and isinstance(e.value, str)]
    return []


def _over_mesh_axes(call: ast.Call) -> List[str]:
    """Constant axis names of a port ``over_mesh(mesh, axes=...)``."""
    if _callee_name(call) != "over_mesh":
        return []
    return _axis_name_constants(_arg_or_kw(call, 1, "axes"))


def check_asymmetric_tier_collective(tree, src, path) -> List[Finding]:
    """Collective over an axis the module's declared tiers don't name.

    The synthesis/tuning discipline (docs/tuning.md): a module that
    describes its machine as explicit ``Tier(...)`` levels has promised
    that ALL collective traffic moves over those tiers — that promise
    is what makes the per-tier cost model and the synthesized-program
    wire accounting (``program_wire_bytes``) truthful. A hard-coded
    ``lax.psum(x, 'dcn2')`` next to ``Tier('ici', ...)``/
    ``Tier('dcn', ...)`` declarations moves bytes over an axis the
    topology doesn't know: the tuner prices it at zero, the wire
    report under-counts, and a program validated against the declared
    tiers runs asymmetric traffic beside it. Flagged shape: a
    string-constant axis name (or tuple element) passed to a lax-style
    collective, in a module that declares at least one
    ``Tier("<name>", ...)``, where the axis is not a declared tier
    name.

    The port's form: a communicator built by ``over_mesh(mesh,
    axes=("x",))`` over a constant axis that no declared ``Tier`` names
    (the port's ``Topology`` tiers are ``nvlink`` and ``net``); its
    collectives move bytes the cost model never priced.

    NOT flagged: modules with no ``Tier`` declarations (nothing is
    promised), non-constant axis names (the tier map resolving names
    at run time is the fixed pattern — synthesis/compiler.py routes
    every step through its ``_TierMap``), and axis names that match a
    declared tier.
    """
    tiers = _declared_tier_names(tree)
    if not tiers:
        return []
    findings: List[Finding] = []
    for n in ast.walk(tree):
        if not isinstance(n, ast.Call):
            continue
        if _callee_name(n) in _AXIS_COLLECTIVES:
            axes = _axis_name_constants(_arg_or_kw(n, 1, "axis_name"))
        else:
            axes = _over_mesh_axes(n)
        for axis in axes:
            if axis in tiers:
                continue
            findings.append(Finding(
                "DL112", path, n.lineno,
                f"'{_callee_name(n)}' moves traffic over axis "
                f"{axis!r} but this module declares tiers "
                f"{sorted(tiers)} — collectives outside the declared "
                "topology escape the per-tier cost model and the "
                "synthesized-program wire accounting. Name the axis "
                "as a Tier, or resolve axes through the tier map at "
                "run time like synthesis/compiler.py "
                f"({_DOC}#dl112)."))
    return findings


register(Rule("DL112", "asymmetric-tier-collective", f"{_DOC}#dl112",
              check_asymmetric_tier_collective))


# ---------------------------------------------------------------------------
# DL117 — unbounded-retry-loop
# ---------------------------------------------------------------------------

#: callee names that mark one attempt against a remote peer — the
#: RPC/transport operations a retry loop is presumably absorbing
#: failures of (object-plane ops, coordinator KV primitives, generic
#: wire verbs)
_RETRY_RPC_CALLS = OBJ_PLANE_CALLS | {
    "try_recv_obj", "blocking_key_value_get",
    "blocking_key_value_get_bytes", "key_value_set",
    "key_value_set_bytes", "wait_at_barrier", "send", "recv",
    "rpc", "request", "urlopen",
}

#: calls that are bounding evidence on their own: the RpcPolicy retry
#: ladder (a loop sleeping the jittered ladder is policy-driven)
_BACKOFF_CALLS = {"backoff_ms", "backoffs_ms"}

#: clock reads whose presence in the loop marks deadline math
_CLOCK_CALLS = {"monotonic", "perf_counter"}

#: name fragments that mark an attempt/deadline bound when they appear
#: in a comparison — or on the receiver/name of a call — inside the loop
_BOUND_NAME_HINTS = ("deadline", "attempt", "budget", "waited",
                     "remaining", "left", "tries", "retries",
                     "policy", "exhausted")


def _retry_handler_swallows(handler: ast.ExceptHandler) -> bool:
    """For DL117 a handler bounds the loop if ANY path through it
    raises, returns, or breaks — each one exits the retry. Only a
    handler that always falls back into the loop (``pass``/
    ``continue``/log-and-go) swallows."""
    for n in _walk_statements(handler.body):
        if isinstance(n, (ast.Raise, ast.Return, ast.Break)):
            return False
    return True


def _names_in(node: ast.AST):
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            yield n.id
        elif isinstance(n, ast.Attribute):
            yield n.attr


def _loop_is_bounded(loop: ast.While) -> bool:
    """Bounding evidence anywhere in the loop body (over-approximate on
    purpose — a misfire on bounded code is noise; the fix for a true
    positive is mechanical): a policy backoff call, a clock read
    (deadline math), or a comparison over an attempt/deadline-named
    quantity."""
    for n in _walk_excluding_defs(loop.body):
        if isinstance(n, ast.Call):
            name = _callee_name(n)
            if name in _BACKOFF_CALLS or name in _CLOCK_CALLS:
                return True
            # the OBJECT form of the same evidence: a method call on a
            # budget/policy-named receiver (``budget.exhausted()``,
            # ``pol.remaining_ms()`` — the fleet/transport.py retry
            # shape, where the bound lives behind an RpcPolicy budget
            # object instead of a literal count)
            for part in _names_in(n.func):
                if any(h in part.lower() for h in _BOUND_NAME_HINTS):
                    return True
        if isinstance(n, ast.Compare):
            for name in _names_in(n):
                if any(h in name.lower() for h in _BOUND_NAME_HINTS):
                    return True
    return False


def check_unbounded_retry_loop(tree, src, path) -> List[Finding]:
    """Retry-forever around an RPC/transport call.

    The resilience discipline (docs/fault_tolerance.md): every retry
    against a remote peer must be bounded by a deadline, an attempt
    cap, or the :class:`~chainermn_tpu.resilience.policy.RpcPolicy`
    backoff ladder — a bare ``while True: try: rpc() except: continue``
    retries against a DEAD coordinator forever, which is exactly the
    silent hang the watchdog/poison-key machinery exists to prevent.
    Flagged shape: a ``while True``-style loop (constant-true
    condition) whose try body calls an RPC/transport operation
    (``send_obj``/``recv_obj``/``try_recv_obj``/KV-store primitives/
    generic wire verbs) with a handler that always falls back into the
    loop, and NO bounding evidence in the loop body.

    NOT flagged: ``for`` loops and non-constant ``while`` conditions
    (inherently bounded); handlers that raise/return/break on any path
    (the exit is the bound); loops containing ``RpcPolicy.backoff_ms``/
    ``backoffs_ms`` calls, a ``time.monotonic()``/``perf_counter()``
    read (deadline math), a comparison over an attempt/deadline-
    named quantity, or a method call on a budget/policy-named receiver
    (the RpcPolicy budget-object form: ``budget.exhausted()``,
    ``pol.remaining_ms()``). The fixed patterns are ``comm/object_plane.py``'s
    ``_sliced_get`` (budget-sliced, raises on exhaustion) and
    ``fleet/transport.py``'s ack wait (per-attempt ``handoff_ack_ms``
    deadline under a ``max_attempts`` cap).
    """
    findings: List[Finding] = []
    for loop in ast.walk(tree):
        if not isinstance(loop, ast.While):
            continue
        test = loop.test
        if not (isinstance(test, ast.Constant) and test.value):
            continue                      # non-constant condition = bound
        if _loop_is_bounded(loop):
            continue
        for node in _walk_excluding_defs(loop.body):
            if not isinstance(node, ast.Try):
                continue
            if not any(_retry_handler_swallows(h) for h in node.handlers):
                continue
            for n in _walk_statements(node.body):
                if not isinstance(n, ast.Call):
                    continue
                name = _callee_name(n)
                if name not in _RETRY_RPC_CALLS:
                    continue
                findings.append(Finding(
                    "DL117", path, n.lineno,
                    f"'{name}' is retried in a 'while True' loop whose "
                    "handler always falls back into the loop, with no "
                    "deadline, attempt cap, or backoff in sight — "
                    "against a dead peer this retries forever, the "
                    "silent hang the fail-fast machinery exists to "
                    "prevent. Bound it: slice the wait against an "
                    "RpcPolicy budget and raise on exhaustion "
                    "(comm/object_plane.py _sliced_get), or cap "
                    "attempts with backoff_ms between re-sends "
                    f"(fleet/transport.py) ({_DOC}#dl117)."))
                break                     # one finding per try block
    return findings


register(Rule("DL117", "unbounded-retry-loop", f"{_DOC}#dl117",
              check_unbounded_retry_loop))


# ---------------------------------------------------------------------------
# DL123 — socket-without-timeout
# ---------------------------------------------------------------------------

#: calls that mint a socket object worth tracking: constructors, the
#: dial helper, and ``accept()`` (whose returned conn is a NEW socket
#: that does NOT inherit a deadline discipline worth relying on)
_SOCKET_CREATORS = {"socket", "create_connection", "create_server",
                    "accept"}

#: operations on a socket that block until the peer acts — each one is
#: an indefinite hang against a half-open peer unless a timeout is set
_SOCKET_BLOCKING_OPS = {"recv", "recv_into", "recvfrom", "accept",
                        "connect", "sendall", "send", "makefile"}


def _sock_name(node: ast.expr) -> Optional[str]:
    """The trackable name of a socket receiver/target: a bare ``Name``
    or the final attribute of ``self.x``-style access."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def check_socket_without_timeout(tree, src, path) -> List[Finding]:
    """A blocking socket op on a socket that never got a timeout.

    TCP gives no notification for a peer that is SIGKILLed, wedged, or
    partitioned mid-connection: a ``recv``/``accept``/``connect`` on a
    default (blocking, no-timeout) socket hangs FOREVER — the network
    twin of the DL117 unbounded retry. The discipline
    (``comm/socket_plane.py``): every socket gets ``settimeout`` right
    after creation, sized from the ``RpcPolicy`` probe budget, so every
    wire wait is a bounded probe slice that re-checks liveness.

    Flagged shape: a name assigned from ``socket()``/
    ``create_connection()``/``create_server()`` or an ``accept()``
    result, later used for a blocking op (``recv``/``accept``/
    ``connect``/``sendall``/...) with no ``settimeout``/
    ``setblocking`` call on that name anywhere in the file. One
    finding per socket name, at its first blocking use.

    NOT flagged: ``create_connection(addr, timeout)`` /
    ``timeout=`` (the dial is bounded at birth — but the returned
    socket still needs ``settimeout`` for its LATER reads, so only the
    tracked dial itself is excused when the timeout rides along);
    files that call ``socket.setdefaulttimeout`` (a process-wide
    bound); names that ``setblocking(False)`` (non-blocking I/O has
    its own readiness discipline). Tracking is per-file and by name —
    over-approximate on purpose, same trade as DL117.
    """
    for n in ast.walk(tree):
        if (isinstance(n, ast.Call)
                and _callee_name(n) == "setdefaulttimeout"):
            return []                   # process-wide bound
    created: Dict[str, int] = {}        # name → creation line
    safe: Set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            callee = _callee_name(n.value)
            if callee not in _SOCKET_CREATORS or len(n.targets) != 1:
                continue
            target = n.targets[0]
            if callee == "accept" and isinstance(target, ast.Tuple):
                target = target.elts[0] if target.elts else target
            tname = _sock_name(target)
            if tname is None:
                continue
            created.setdefault(tname, n.lineno)
            if callee == "create_connection" and (
                    len(n.value.args) >= 2
                    or any(kw.arg == "timeout"
                           for kw in n.value.keywords)):
                safe.add(tname)         # bounded at birth
        elif (isinstance(n, ast.Call)
              and isinstance(n.func, ast.Attribute)
              and n.func.attr in ("settimeout", "setblocking")):
            tname = _sock_name(n.func.value)
            if tname is not None:
                safe.add(tname)
    findings: List[Finding] = []
    reported: Set[str] = set()
    for n in ast.walk(tree):
        if not (isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in _SOCKET_BLOCKING_OPS):
            continue
        tname = _sock_name(n.func.value)
        if (tname is None or tname not in created or tname in safe
                or tname in reported):
            continue
        reported.add(tname)
        findings.append(Finding(
            "DL123", path, n.lineno,
            f"'{tname}.{n.func.attr}' blocks on a socket that never "
            f"got a timeout (created at line {created[tname]}) — "
            "against a SIGKILLed or partitioned peer this waits "
            "forever, the network twin of the DL117 unbounded retry. "
            "Call settimeout right after creating it, sized from the "
            "RpcPolicy probe budget (comm/socket_plane.py), so every "
            f"wire wait is a bounded probe slice ({_DOC}#dl123)."))
    findings.sort(key=lambda f: f.line)
    return findings


register(Rule("DL123", "socket-without-timeout", f"{_DOC}#dl123",
              check_socket_without_timeout))


# ---------------------------------------------------------------------------
# DL124 — unverified-weight-load
# ---------------------------------------------------------------------------

#: calls that deserialize bytes into arrays/objects — the moment a
#: torn or tampered snapshot becomes live params if nothing checked it
_DESERIALIZER_CALLS = {"load", "fromfile"}

#: a weight/snapshot-load-shaped function name: it must say WHAT it
#: loads (weights or a snapshot) and that it LOADS it
_WEIGHTY = ("weight", "snapshot")
_LOADY = ("load", "read", "decode", "restore")


def _is_verifyish(name: Optional[str]) -> bool:
    """A callee name that smells like integrity checking.

    ``sha`` only counts on a token boundary (``sha256``, ``_sha``),
    so ``read_weight_shards`` is still a loader, not a verifier.
    """
    if not name:
        return False
    low = name.lower()
    if any(tok in low for tok in ("verify", "digest", "checksum")):
        return True
    for part in low.replace(".", "_").split("_"):
        if part == "sha" or part.startswith(("sha1", "sha2",
                                             "sha3", "sha5")):
            return True
    return False


def check_unverified_weight_load(tree, src, path) -> List[Finding]:
    """A weight/snapshot loader that deserializes without verifying.

    Weights are the one artifact every replica trusts blindly: a torn
    ``publish_weights`` rename, a corrupt relay chunk, or a stale ring
    replica that loads unchecked becomes silently wrong LOGITS — no
    crash, no NaN, just a fleet bitwise-diverging from its oracle. The
    discipline (``serving/weights.py``): every snapshot travels with a
    SHA-256 + byte-count manifest, and every loader calls ``_verify``
    (or checks the digest inline) BEFORE ``np.load`` touches the
    payload — a failed check falls back to the next candidate or
    raises ``WeightsError``, it never half-loads.

    Flagged shape: a function whose name says it loads weights or a
    snapshot (``load``/``read``/``decode``/``restore`` ×
    ``weight``/``snapshot``) calling ``np.load``/``fromfile`` while
    neither calling anything verify-ish (``verify``/``sha``/
    ``digest``/``checksum``) itself nor calling an in-file helper that
    does (one level of resolution — the ``load_weights`` → ``_verify``
    shape). One finding per function, at the deserializing call.

    NOT flagged: functions named like verifiers (they ARE the check);
    deserialization in functions with other names (checkpoint iterators
    and manifest peeks have their own disciplines — this rule guards
    the load-weights face specifically, the trade every DL1xx rule
    makes: catch the shape that burned us, over-approximate nowhere).
    """
    # per-function direct-callee sets, for the one-level resolution
    callees: Dict[str, Set[str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names = set()
            for n in _walk_excluding_defs(node.body):
                if isinstance(n, ast.Call):
                    cn = _callee_name(n)
                    if cn:
                        names.add(cn)
            callees.setdefault(node.name, set()).update(names)

    def _verifies(fname: str, depth: int = 1) -> bool:
        called = callees.get(fname, set())
        if any(_is_verifyish(c) for c in called):
            return True
        if depth > 0:
            return any(c in callees and _verifies(c, depth - 1)
                       for c in called)
        return False

    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        low = node.name.lower()
        if _is_verifyish(node.name):
            continue                    # the function IS the check
        if not (any(w in low for w in _WEIGHTY)
                and any(l in low for l in _LOADY)):
            continue
        if _verifies(node.name):
            continue
        for n in _walk_excluding_defs(node.body):
            if (isinstance(n, ast.Call)
                    and _callee_name(n) in _DESERIALIZER_CALLS):
                findings.append(Finding(
                    "DL124", path, n.lineno,
                    f"'{node.name}' deserializes a weight/snapshot "
                    "payload with no integrity check in sight — a torn "
                    "publish, a corrupt relay chunk, or a stale replica "
                    "loads as silently wrong logits, the failure no "
                    "crash ever reports. Verify the SHA-256 manifest "
                    "first (serving/weights.py _verify, or "
                    "decode_weights' inline digest) and fall back or "
                    "raise WeightsError on mismatch "
                    f"({_DOC}#dl124)."))
                break                   # one finding per function
    findings.sort(key=lambda f: f.line)
    return findings


register(Rule("DL124", "unverified-weight-load", f"{_DOC}#dl124",
              check_unverified_weight_load))
