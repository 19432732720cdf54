"""dlint dataflow rules DL118–DL122, DL125: value-level contracts.

These project passes stand on :mod:`.dataflow` (reaching definitions +
def-use chains + interprocedural parameter summaries) and encode the
value contracts the rest of the stack only states in prose:

* **DL118 prng-key-reuse** — a ``jax.random`` key fed to two consumers
  (or a ``split``/``fold_in`` result discarded) breaks the
  one-split-per-sampled-token replay contract (serving/sampling.py):
  reuse correlates samples silently and replay/migration stop being
  bitwise. ``fold_in(key, i)`` does NOT consume its key — folding
  varying data into one base key is the sanctioned loop idiom
  (training/step.py) — but dropping its RESULT is still flagged.
* **DL119 use-after-donation** — a value passed at a
  ``donate_argnums`` position of a jit-compiled callable and read
  afterwards: XLA reuses the donated buffer, so the read sees garbage.
  Tracked through jit aliases (``step = jax.jit(f, donate_argnums=...)``
  and ``self._fn = jax.jit(...)``) and through callees whose summary
  says a parameter is donated. ``IfExp`` donation switches
  (``donate_argnums=(0,) if donate else ()``) are deliberately opaque —
  maybe-donated must not flag.
* **DL120 nondeterministic-iteration** — iterating a ``set`` to build
  collectives, assign channel tags, or form signature/cache-key tuples:
  set order varies across processes, so ranks disagree on collective
  order or tag assignment. Dict iteration is NOT flagged (insertion
  order is a language guarantee since 3.7 — the repo relies on it).
* **DL121 host-sync-in-decode** — ``.item()``/``float()``/
  ``np.asarray``/``jax.device_get`` on a value derived from the data
  parameters of anything reachable from ``decode_k*`` functions or
  ``ServingStep`` methods: each pull serializes the decode conveyor.
  ``self`` state is not tracked (the sanctioned debug pulls like
  ``ServingStep.cursors`` read ``self.cache`` outside the token path).
* **DL122 trace-count-instability** — a Python ``if``/``while`` on a
  value derived from a traced parameter of a jit/pjit/pmap-compiled
  function: each outcome traces a separate executable (the static twin
  of DL108's runtime trace budget) or raises under tracing. Parameters
  bound by a default (the ``_k=kk`` capture idiom), listed in
  ``static_argnums``/``static_argnames``, named ``self``/``cls``, and
  bare ``is None`` tests are static and exempt.

* **DL125 draft-target-key-confusion** — a token sampled with a
  ``draft_shadow_keys`` SHADOW key row (serving/speculative.py's draft
  proposal stream) committed through an emit/commit-style call with no
  verify/accept call receiving it on the dataflow path: draft samples
  are PROPOSALS — only the target's verify pass may put tokens into a
  stream, or accepted streams stop being bitwise-identical to
  non-speculative decode and the draft's shadow splits leak into the
  real one-split-per-sampled-token key stream.

All six fire only when EVERY definition reaching the flagged use has
the hazardous property — an uncertain merge silences the finding (the
package-wide precision stance, docs/static_analysis.md#dl118).
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from chainermn_torch.analysis.ast_passes import (
    P2P_CALLS,
    SYMMETRIC_COLLECTIVES,
    _callee_name,
    _walk_excluding_defs,
)
from chainermn_torch.analysis.callgraph import (
    DEFAULT_CALL_DEPTH,
    FunctionInfo,
    ModuleInfo,
    Project,
    _attr_chain,
)
from chainermn_torch.analysis.core import Finding, Rule, register
from chainermn_torch.analysis.dataflow import (
    Analysis,
    DefUse,
    FlowWalker,
    STATIC_ATTRS,
    map_args_to_params,
    positional_param_indices,
    scopes_in,
)

_DOC = "docs/static_analysis_torch.md"


# ---------------------------------------------------------------------------
# shared: resolving jax.random / numpy / jit name chains per module
# ---------------------------------------------------------------------------


def _chain_module(mod: Optional[ModuleInfo],
                  chain: List[str]) -> Optional[str]:
    """Dotted module a receiver chain refers to (``["jax","random"]``
    -> ``"jax.random"``, an alias ``jr`` -> its import target)."""
    if not chain:
        return None
    dotted = ".".join(chain)
    if dotted in ("jax.random", "numpy", "jax"):
        return dotted
    if mod is None:
        return None
    bound = mod.imports.get(chain[0])
    if isinstance(bound, str):
        return ".".join([bound] + chain[1:])
    if isinstance(bound, tuple):
        return ".".join([f"{bound[0]}.{bound[1]}".strip(".")] + chain[1:])
    return None


#: jax.random ops that CONSUME the key they are given (first arg or
#: ``key=``): samplers plus split. fold_in is excluded — see module doc.
_PRNG_CONSUMERS = {
    "split", "normal", "uniform", "categorical", "bernoulli", "gumbel",
    "randint", "truncated_normal", "permutation", "choice",
    "exponential", "laplace", "cauchy", "logistic", "beta", "gamma",
    "dirichlet", "poisson", "rademacher", "bits", "ball", "maxwell",
    "multivariate_normal", "orthogonal", "t", "loggamma", "weibull_min",
}

#: ops whose RESULT being discarded is the bug (the advanced key is lost)
_PRNG_PRODUCERS = {"split", "fold_in"}


def _prng_op(mod: Optional[ModuleInfo], call: ast.Call) -> Optional[str]:
    """The ``jax.random`` op name this call invokes, else None."""
    chain = _attr_chain(call.func)
    if chain is None:
        return None
    op = chain[-1]
    if op not in _PRNG_CONSUMERS | _PRNG_PRODUCERS:
        return None
    if len(chain) == 1:
        bound = mod.imports.get(op) if mod is not None else None
        if isinstance(bound, tuple) and bound[0] == "jax.random" \
                and bound[1] == op:
            return op
        return None
    return op if _chain_module(mod, chain[:-1]) == "jax.random" else None


def _prng_key_arg(call: ast.Call) -> Optional[ast.expr]:
    if call.args and not isinstance(call.args[0], ast.Starred):
        return call.args[0]
    for kw in call.keywords:
        if kw.arg == "key":
            return kw.value
    return None


#: the port's key API (``__all__`` of serving/sampling.py, and
#: ops/dropout.py): calls that CONSUME the key rows they are given, by
#: the position (and keyword) of those rows — ``split_keys`` advances
#: them, ``sample_tokens`` draws from them
_PORT_KEY_CONSUMERS = {"split_keys": (0, "keys"),
                       "sample_tokens": (1, "keys")}
#: port ops whose result being discarded loses the advanced key
_PORT_KEY_PRODUCERS = {"split_keys", "fold_in"}


def _port_key_op(mod: Optional[ModuleInfo], call: ast.Call
                 ) -> Optional[str]:
    """The port key-API op this call invokes (by terminal name, unless
    the name is ``jax.random``'s), else None."""
    chain = _attr_chain(call.func)
    if chain is None:
        return None
    op = chain[-1]
    if op not in _PORT_KEY_CONSUMERS and op not in _PORT_KEY_PRODUCERS:
        return None
    return None if _prng_op(mod, call) is not None else op


def _prng_consumed_args(mod: Optional[ModuleInfo], call: ast.Call
                        ) -> List[Tuple[ast.expr, str]]:
    op = _prng_op(mod, call)
    if op is None or op not in _PRNG_CONSUMERS:
        port = _port_key_op(mod, call)
        if port not in _PORT_KEY_CONSUMERS:
            return []
        pos, kw = _PORT_KEY_CONSUMERS[port]
        arg = next((k.value for k in call.keywords if k.arg == kw), None)
        if arg is None and len(call.args) > pos \
                and not isinstance(call.args[pos], ast.Starred):
            arg = call.args[pos]
        return [(arg, port)] if arg is not None else []
    arg = _prng_key_arg(call)
    return [(arg, op)] if arg is not None else []


def _functions_by_node(project: Project) -> Dict[int, FunctionInfo]:
    cached = getattr(project, "_dataflow_by_node", None)
    if cached is None:
        cached = {id(f.node): f for f in project.functions.values()}
        project._dataflow_by_node = cached   # type: ignore[attr-defined]
    return cached


def _ctx_for(project: Project, mod: ModuleInfo, scope: ast.AST
             ) -> Tuple[FunctionInfo, Optional[Dict[str, str]]]:
    """A resolve_call context for any scope: the real FunctionInfo for
    indexed functions (memoized local types), a synthetic one with
    empty local types for module bodies and nested defs."""
    info = _functions_by_node(project).get(id(scope))
    if info is not None:
        return info, None
    name = getattr(scope, "name", "<module>")
    info = FunctionInfo(
        qualname=f"{mod.name}:<{name}@{getattr(scope, 'lineno', 0)}>",
        module=mod.name, name=name, cls=None, node=scope, path=mod.path)
    return info, {}


# ---------------------------------------------------------------------------
# DL118 — prng-key-reuse
# ---------------------------------------------------------------------------


class _KeyReuseWalker(FlowWalker):
    """Path-sensitive consumption tracking: state is the set of
    ``(definition uid, literal subscript index)`` keys already fed to a
    consumer on EVERY path reaching the current point (merges
    intersect). ``ks = split(key, 3)`` used as ``ks[0]``/``ks[1]`` keeps
    distinct indices; a bare ``ks`` use conflicts with all of them."""

    def __init__(self, scope, project: Project, mod: ModuleInfo,
                 ctx: FunctionInfo, local_types, analysis: Analysis,
                 detector, findings: List[Finding]):
        super().__init__(scope)
        self.project, self.mod, self.ctx = project, mod, ctx
        self.local_types = local_types
        self.analysis, self.detector = analysis, detector
        self.findings = findings

    def initial_state(self):
        return set()

    def copy_state(self, state):
        return set(state)

    def merge_states(self, a, b):
        return a & b

    def _key_refs(self, arg: ast.expr
                  ) -> List[Tuple[int, Optional[int], str]]:
        """(uid, subscript-index, display name) per definition the key
        argument may refer to; [] when untrackable (calls, variable
        subscripts — those never flag and never mark)."""
        if isinstance(arg, ast.Name):
            return [(d.uid, None, arg.id)
                    for d in self.env.get(arg.id, frozenset())]
        if (isinstance(arg, ast.Subscript)
                and isinstance(arg.value, ast.Name)
                and isinstance(arg.slice, ast.Constant)
                and isinstance(arg.slice.value, int)):
            idx = arg.slice.value
            return [(d.uid, idx, f"{arg.value.id}[{idx}]")
                    for d in self.env.get(arg.value.id, frozenset())]
        return []

    def _conflicts(self, ref) -> bool:
        uid, idx, _name = ref
        if (uid, None) in self.state or (uid, idx) in self.state:
            return True
        return idx is None and any(u == uid for u, _i in self.state)

    def _port_fold_in(self, call: ast.Call) -> None:
        """The port's ``fold_in(key, data)`` is a pure function: folding
        the same literal datum into the same key twice derives the same
        key twice. State entries ``("fold", (uid, idx, datum))`` record
        the folds made on every path so far."""
        if _port_key_op(self.mod, call) != "fold_in" or len(call.args) < 2:
            return
        datum = call.args[1]
        if not isinstance(datum, ast.Constant):
            return                  # only literal data is comparable
        refs = self._key_refs(call.args[0])
        marks = [("fold", (uid, idx, repr(datum.value)))
                 for uid, idx, _n in refs]
        if refs and all(m in self.state for m in marks):
            self.findings.append(Finding(
                "DL118", self.mod.path, call.lineno,
                f"'fold_in({refs[0][2]}, {datum.value!r})' folds the same "
                "datum into the same key again on every path reaching "
                "this call — fold_in is a pure function, so both calls "
                "derive ONE key and their masks/samples coincide. Fold "
                "a distinct datum (the step, the layer) per use "
                f"({_DOC}#dl118)."))
        self.state.update(marks)

    def on_call(self, call: ast.Call) -> None:
        self._port_fold_in(call)
        consumed = _prng_consumed_args(self.mod, call)
        ops = {op for _, op in consumed}
        if not consumed:
            callee = self.project.resolve_call(call, self.ctx,
                                               self.local_types)
            if callee is not None:
                sub = self.analysis.summary(callee, self.detector, "prng")
                if sub.consumed:
                    arg_map = map_args_to_params(call, callee)
                    consumed = [(arg_map[i], reason)
                                for i, reason in sub.consumed.items()
                                if i in arg_map]
                    ops = {f"{callee.name}()"}
        for arg, op in consumed:
            refs = self._key_refs(arg)
            if refs and all(self._conflicts(r) for r in refs):
                self.findings.append(Finding(
                    "DL118", self.mod.path, call.lineno,
                    f"PRNG key '{refs[0][2]}' is used again by "
                    f"'{op}' after already being consumed on every "
                    "path reaching this call — reusing a key "
                    "correlates samples and breaks the one-split-per-"
                    "sampled-token replay contract (serving/"
                    "sampling.py). Split and rebind first: "
                    "`keys, sub = split_keys(keys)` (or "
                    "`key, sub = jax.random.split(key)`) "
                    f"({_DOC}#dl118)."))
            self.state.update((u, i) for u, i, _n in refs)

    def on_expr_statement(self, value: ast.expr) -> None:
        if not isinstance(value, ast.Call):
            return
        op = _prng_op(self.mod, value)
        port = _port_key_op(self.mod, value)
        if port in _PORT_KEY_PRODUCERS:
            self.findings.append(Finding(
                "DL118", self.mod.path, value.lineno,
                f"the result of '{port}' is discarded — it RETURNS the "
                "advanced key rows (split_keys: the rows to thread on "
                "and the rows this draw uses); dropping them leaves the "
                "caller drawing from the stale rows, so every consumer "
                f"downstream reuses old randomness ({_DOC}#dl118)."))
        elif op in _PRNG_PRODUCERS:
            self.findings.append(Finding(
                "DL118", self.mod.path, value.lineno,
                f"the result of 'jax.random.{op}' is discarded — "
                "split/fold_in RETURN the advanced key(s); dropping "
                "them leaves the caller sampling from the stale key, "
                "so every consumer downstream reuses old randomness "
                f"({_DOC}#dl118)."))


def _prng_detector(project: Project):
    def det(du: DefUse, call: ast.Call, func: FunctionInfo):
        return _prng_consumed_args(project.modules.get(func.module), call)
    return det


def check_prng_key_reuse(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    analysis = Analysis.of(project)
    det = _prng_detector(project)
    for mod in project.modules.values():
        for scope in scopes_in(mod.tree):
            ctx, local_types = _ctx_for(project, mod, scope)
            _KeyReuseWalker(scope, project, mod, ctx, local_types,
                            analysis, det, findings).run()
    return findings


register(Rule("DL118", "prng-key-reuse", f"{_DOC}#dl118",
              check_prng_key_reuse, kind="project"))


# DL119 (use-after-donation) has no port form: nothing in the port donates
# a buffer (core.NOT_APPLICABLE).


# ---------------------------------------------------------------------------
# DL120 — nondeterministic-iteration
# ---------------------------------------------------------------------------


_SET_MAKERS = {"set", "frozenset"}
_SET_METHODS = {"union", "intersection", "difference",
                "symmetric_difference", "copy"}
#: names whose assignment from ``tuple(<set>)`` marks a signature/key
_SIG_NAME_HINTS = ("sig", "signature", "key", "fingerprint")
#: iterator wrappers that preserve the argument's (non)order
_ORDER_PRESERVING = {"enumerate", "list", "tuple", "iter"}


def _set_typed_defs(du: DefUse) -> Set[int]:
    """uids of definitions that are statically set-typed (literals,
    ``set()``/``frozenset()`` calls, set methods returning sets, plain
    copies, and set-algebra BinOps over set-typed names)."""
    sets: Set[int] = set()

    def names_all_set(expr: ast.expr) -> bool:
        if not isinstance(expr, ast.Name):
            return False
        defs = du.defs_of(expr)
        return bool(defs) and all(d.uid in sets for d in defs)

    def is_set_expr(v: ast.expr) -> bool:
        if isinstance(v, (ast.Set, ast.SetComp)):
            return True
        if isinstance(v, ast.Call):
            name = _callee_name(v)
            if name in _SET_MAKERS:
                return True
            if (name in _SET_METHODS
                    and isinstance(v.func, ast.Attribute)
                    and names_all_set(v.func.value)):
                return True
            return False
        if isinstance(v, ast.Name):
            return names_all_set(v)
        if isinstance(v, ast.BinOp) and isinstance(
                v.op, (ast.BitOr, ast.BitAnd, ast.Sub)):
            return names_all_set(v.left) or names_all_set(v.right)
        return False

    changed = True
    while changed:
        changed = False
        for d in du.defs:
            if d.uid in sets or d.index is not None:
                continue
            v = du.def_value.get(d.uid)
            if v is not None and is_set_expr(v):
                sets.add(d.uid)
                changed = True
    return sets


def _iterated_set(du: DefUse, sets: Set[int],
                  it: ast.expr) -> Optional[str]:
    """Display name when a ``for`` iterates a set (directly, through a
    literal, or through an order-preserving wrapper); None otherwise
    (``sorted(s)`` reads clean here)."""
    while (isinstance(it, ast.Call)
            and _callee_name(it) in _ORDER_PRESERVING and it.args):
        it = it.args[0]
    if isinstance(it, (ast.Set, ast.SetComp)):
        return "a set literal"
    if isinstance(it, ast.Call) and _callee_name(it) in _SET_MAKERS:
        return f"'{_callee_name(it)}(...)'"
    if isinstance(it, ast.Name):
        defs = du.defs_of(it)
        if defs and all(d.uid in sets for d in defs):
            return f"'{it.id}'"
    return None


def check_nondeterministic_iteration(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    analysis = Analysis.of(project)
    for mod in project.modules.values():
        for scope in scopes_in(mod.tree):
            du = analysis.defuse(scope)
            sets = _set_typed_defs(du)
            body = getattr(scope, "body", [])
            if not isinstance(body, list):
                continue
            for n in _walk_excluding_defs(body):
                if isinstance(n, (ast.For, ast.AsyncFor)):
                    what = _iterated_set(du, sets, n.iter)
                    if what is None:
                        continue
                    hazard = _loop_body_comm_hazard(n.body)
                    if hazard is None:
                        continue
                    findings.append(Finding(
                        "DL120", mod.path, n.lineno,
                        f"iterating {what} — a set — drives {hazard}: "
                        "set iteration order differs across processes "
                        "and runs, so ranks disagree on collective "
                        "order / channel-tag assignment and deadlock "
                        "or cross wires. Iterate "
                        f"sorted({what.strip(chr(39))}) instead "
                        f"({_DOC}#dl120)."))
                elif (isinstance(n, ast.Call)
                      and _callee_name(n) == "new_group"):
                    ranks = n.args[0] if n.args else next(
                        (k.value for k in n.keywords if k.arg == "ranks"),
                        None)
                    what = (_iterated_set(du, sets, ranks)
                            if ranks is not None else None)
                    if what is not None:
                        findings.append(Finding(
                            "DL120", mod.path, n.lineno,
                            f"'new_group' takes its ranks from {what} — "
                            "a set, whose order differs across "
                            "processes: new_group is collective over the "
                            "whole world, so every rank must make the "
                            "same groups with the same rank lists in one "
                            "order. Pass sorted(...) "
                            f"({_DOC}#dl120)."))
                elif isinstance(n, ast.Assign):
                    hit = _sig_tuple_from_set(du, sets, n)
                    if hit is not None:
                        findings.append(Finding(
                            "DL120", mod.path, n.lineno,
                            f"'{hit}' is a signature/key tuple built "
                            "from a set — its element order varies "
                            "per process, so trace signatures and "
                            "cache keys stop matching across ranks. "
                            "Build it from sorted(...) "
                            f"({_DOC}#dl120)."))
    return findings


def _loop_body_comm_hazard(body: List[ast.stmt]) -> Optional[str]:
    for n in _walk_excluding_defs(body):
        if not isinstance(n, ast.Call):
            continue
        name = _callee_name(n)
        if name in SYMMETRIC_COLLECTIVES:
            return f"the collective '{name}'"
        if name in P2P_CALLS:
            return f"the P2P call '{name}'"
        if any(kw.arg == "tag" for kw in n.keywords):
            return f"'{name}(tag=...)' channel-tag assignment"
    return None


def _sig_tuple_from_set(du: DefUse, sets: Set[int],
                        assign: ast.Assign) -> Optional[str]:
    v = assign.value
    if not (isinstance(v, ast.Call) and _callee_name(v) in
            ("tuple", "list") and v.args
            and isinstance(v.args[0], ast.Name)):
        return None
    defs = du.defs_of(v.args[0])
    if not defs or not all(d.uid in sets for d in defs):
        return None
    for t in assign.targets:
        if isinstance(t, ast.Name) and any(
                h in t.id.lower() for h in _SIG_NAME_HINTS):
            return t.id
    return None


register(Rule("DL120", "nondeterministic-iteration", f"{_DOC}#dl120",
              check_nondeterministic_iteration, kind="project"))


# ---------------------------------------------------------------------------
# DL121 — host-sync-in-decode
# ---------------------------------------------------------------------------


#: tensor methods that pull to the host (``.cpu()`` and ``.numpy()`` are
#: the port's, beside JAX's ``.item()``/``.tolist()``)
_HOST_PULL_ATTRS = {"item", "tolist", "cpu", "numpy"}


def _host_sync_target(mod: ModuleInfo, call: ast.Call
                      ) -> Optional[Tuple[ast.expr, str]]:
    """(pulled expression, display) when the call synchronously moves a
    device value to host: .item()/.tolist(), float(), numpy
    asarray/array, jax.device_get."""
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr in _HOST_PULL_ATTRS:
        return fn.value, f".{fn.attr}()"
    chain = _attr_chain(fn)
    if chain is None:
        return None
    arg = call.args[0] if call.args else None
    if arg is None:
        return None
    if chain == ["float"]:
        return arg, "float()"
    if len(chain) >= 2 and chain[-1] in ("asarray", "array") \
            and _chain_module(mod, chain[:-1]) == "numpy":
        return arg, f"np.{chain[-1]}"
    if chain[-1] == "device_get" \
            and (len(chain) == 1
                 or _chain_module(mod, chain[:-1]) == "jax"):
        return arg, "jax.device_get"
    return None


def _decode_roots(project: Project) -> List[FunctionInfo]:
    # test functions whose NAME mentions decode_k are assertions about
    # the hot path, not the hot path — they pull to host by design
    return [f for f in project.functions.values()
            if not f.name.startswith("test")
            and ("decode_k" in f.name
                 or (f.cls is not None and "ServingStep" in f.cls))]


def check_host_sync_in_decode(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    analysis = Analysis.of(project)
    roots = _decode_roots(project)
    # reachable set: qualname -> (FunctionInfo, root it was reached from)
    reached: Dict[str, Tuple[FunctionInfo, str]] = {}
    frontier = [(f, f.name, 0) for f in roots]
    while frontier:
        func, root, depth = frontier.pop()
        if func.qualname in reached or depth > DEFAULT_CALL_DEPTH:
            continue
        reached[func.qualname] = (func, root)
        for n in ast.walk(func.node):
            if isinstance(n, ast.Call):
                callee = project.resolve_call(n, func)
                if callee is not None:
                    frontier.append((callee, root, depth + 1))
    for func, root in reached.values():
        mod = project.modules.get(func.module)
        if mod is None:
            continue
        du = analysis.defuse(func.node)
        indices = {n: i for n, i
                   in positional_param_indices(func.node).items()
                   if n not in ("self", "cls")}
        origins = du.param_origins(indices, skip_attrs=STATIC_ATTRS)
        data_uids = {uid for uid, srcs in origins.items() if srcs}
        for call in du.calls:
            hit = _host_sync_target(mod, call)
            if hit is None:
                continue
            pulled, display = hit
            if any(d.uid in data_uids
                   for d in du.loads_in(pulled, STATIC_ATTRS)):
                where = func.name if func.name == root \
                    else f"{func.name} (reached from {root})"
                findings.append(Finding(
                    "DL121", func.path, call.lineno,
                    f"host-device sync '{display}' on a value derived "
                    f"from the data arguments of '{where}' — the "
                    "decode hot path must stay device-resident; every "
                    "per-token pull stalls the conveyor behind a "
                    "device round-trip. Keep the value on device "
                    "(tensor ops) or hoist the pull out of the decode/"
                    f"step loop ({_DOC}#dl121)."))
    return findings


register(Rule("DL121", "host-sync-in-decode", f"{_DOC}#dl121",
              check_host_sync_in_decode, kind="project"))


# DL122 (trace-count-instability) has no port form: nothing is traced
# (core.NOT_APPLICABLE).


# ---------------------------------------------------------------------------
# DL125 — draft-target-key-confusion
# ---------------------------------------------------------------------------


#: the taint source: serving/sampling.py's shadow-copy of the target's
#: key rows for a draft proposal pass
_DRAFT_KEY_MAKER = "draft_shadow_keys"
#: samplers whose (logits, keys) call shape the rule understands
_DRAFT_SAMPLERS = {"sample_tokens"}
#: a call whose name carries one of these receives the token for
#: target-side verification — the blessing that makes a commit legal
_VERIFY_HINTS = ("verify", "accept")
#: commit-style sinks a raw draft sample must never reach
_COMMIT_SINKS = {"emit", "_emit", "commit", "commit_token",
                 "record_token", "append", "push", "send", "publish"}


def _call_name(call: ast.Call) -> str:
    chain = _attr_chain(call.func)
    return (chain[-1] if chain else _callee_name(call)) or ""


class _DraftKeyWalker(FlowWalker):
    """Taint tracking for the speculative-decoding PRNG contract.

    ``draft_shadow_keys(...)`` results are SHADOW keys; a
    ``sample_tokens`` call keyed by one yields a DRAFT token (result 0)
    and a new shadow key (result 1). Path state is the set of draft-
    token defs a verify/accept call has received on every path (merges
    intersect — maybe-verified stays silent); a commit-style call whose
    argument's reaching definitions are all unverified draft tokens is
    the finding."""

    def __init__(self, scope, mod: ModuleInfo, findings: List[Finding]):
        super().__init__(scope)
        self.mod = mod
        self.findings = findings
        self.shadow_keys: Set[int] = set()
        self.draft_toks: Set[int] = set()
        # per-sampler-call "keyed by shadow rows" verdict: the walker
        # binds each tuple-unpack target (and its env entry) before
        # on_def fires, so by the time the REBOUND key target of
        # ``tok, shadow = sample_tokens(.., shadow, ..)`` is processed
        # the key argument resolves to the def being created; the
        # verdict cached while processing the token target is the one
        # that saw the pre-bind environment
        self._keyed_calls: Dict[int, bool] = {}

    def initial_state(self):
        return set()

    def copy_state(self, state):
        return set(state)

    def merge_states(self, a, b):
        return a & b

    def _name_defs(self, expr) -> FrozenSet:
        if isinstance(expr, ast.Name):
            return self.env.get(expr.id, frozenset())
        return frozenset()

    def on_def(self, d) -> None:
        v = self.def_value.get(d.uid)
        if not isinstance(v, ast.Call):
            return
        name = _call_name(v)
        if name == _DRAFT_KEY_MAKER:
            if d.index in (None, 0):
                self.shadow_keys.add(d.uid)
            return
        if name in _DRAFT_SAMPLERS:
            key_arg = (v.args[1] if len(v.args) > 1
                       and not isinstance(v.args[1], ast.Starred)
                       else None)
            for kw in v.keywords:
                if kw.arg in ("keys", "key"):
                    key_arg = kw.value
            refs = self._name_defs(key_arg)
            keyed = bool(refs) and all(
                r.uid in self.shadow_keys for r in refs)
            keyed = keyed or self._keyed_calls.get(id(v), False)
            self._keyed_calls[id(v)] = keyed
            if keyed:
                if d.index in (None, 0):
                    self.draft_toks.add(d.uid)
                elif d.index == 1:
                    # the advanced shadow key stays a shadow key
                    self.shadow_keys.add(d.uid)

    def on_call(self, call: ast.Call) -> None:
        name = _call_name(call)
        low = name.lower()
        if any(h in low for h in _VERIFY_HINTS):
            args = list(call.args) + [kw.value for kw in call.keywords]
            for arg in args:
                for d in self._name_defs(arg):
                    if d.uid in self.draft_toks:
                        self.state.add(d.uid)
            return
        if name not in _COMMIT_SINKS:
            return
        for arg in call.args:
            if isinstance(arg, ast.Starred):
                continue
            refs = self._name_defs(arg)
            if refs and all(r.uid in self.draft_toks for r in refs) \
                    and any(r.uid not in self.state for r in refs):
                tok = arg.id if isinstance(arg, ast.Name) else "<token>"
                self.findings.append(Finding(
                    "DL125", self.mod.path, call.lineno,
                    f"'{tok}' was sampled with a draft_shadow_keys "
                    f"SHADOW key row and is committed by '{name}' "
                    "with no verify/accept call receiving it on this "
                    "path — draft samples are proposals; only the "
                    "target's verify pass may put tokens into a "
                    "stream, or accepted streams stop being bitwise "
                    "and the shadow key splits leak into the real "
                    "one-split-per-sampled-token stream (serving/"
                    f"speculative.py; {_DOC}#dl125)."))


def check_draft_target_key_confusion(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for mod in project.modules.values():
        for scope in scopes_in(mod.tree):
            _DraftKeyWalker(scope, mod, findings).run()
    return findings


register(Rule("DL125", "draft-target-key-confusion", f"{_DOC}#dl125",
              check_draft_target_key_confusion, kind="project"))
