"""Value-level dataflow for the dlint project passes.

The sequence/lock passes (PR 13) reason about *event order*; the rules
this module powers (DL118–DL122, :mod:`.dataflow_rules`) reason about
*values*: which definition a name refers to at a use site, whether a
buffer that was donated is read again, whether a PRNG key reaches two
consumers. Three layers:

* :class:`FlowWalker` — a flow-sensitive abstract interpreter over one
  function (or module) body. It executes statements in program order
  keeping an environment ``name -> frozenset[Definition]`` (reaching
  definitions): ``if``/``try`` branches interpret each arm on a copy
  and merge, loops interpret the body twice (entry pass + back-edge
  pass) so loop-carried reuse is observed, and nested ``def``/
  ``class``/``lambda`` bodies are not descended into (they run at some
  other time — a nested def only binds its name). Subclasses hook
  :meth:`~FlowWalker.on_load` / :meth:`~FlowWalker.on_call` and may
  thread a rule-specific auxiliary state through the same branch
  topology (copied at forks, merged at joins) — that is how DL118/119
  stay *path*-sensitive (a key consumed in one arm of an ``if`` is not
  "already consumed" after the join unless both arms consumed it).

* :class:`DefUse` — the vanilla subclass collecting def-use chains:
  every ``Name`` load with the definitions that reach it, every call in
  execution order, return expressions, and bare expression statements
  (for discarded-result checks). :meth:`DefUse.derived_from` closes a
  seed set of definitions over value expressions (``b = f(a)`` makes
  ``b`` derived from ``a``), optionally refusing to propagate through
  static attribute reads (``n = x.shape[0]`` does NOT make ``n``
  data-derived — shapes are trace-time constants).

* :func:`param_summary` — the interprocedural layer: per function,
  which parameters flow to its returns and which are *consumed*
  (handed to a consumer call — PRNG split/sample, a donating jit —
  directly or through further resolved calls). Summaries compose
  through :meth:`~.callgraph.Project.resolve_call` down to
  :data:`~.callgraph.DEFAULT_CALL_DEPTH` with a cycle guard and are
  memoized per :class:`Analysis`, so a lint run visits each function
  once per rule family.

Precision stance (same contract as the rest of the package,
docs/static_analysis.md#whole-program-engine): reaching definitions
are an over-approximation (a merge keeps both arms' defs) while the
rule-facing *judgments* stay under-approximate — DL118/119 only fire
when EVERY definition reaching a use is consumed/donated, so an
uncertain path silences the finding instead of raising noise.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, \
    Sequence, Set, Tuple

from chainermn_torch.analysis.callgraph import (
    DEFAULT_CALL_DEPTH,
    FunctionInfo,
    Project,
)

#: attribute reads that yield trace-time constants, not data — a value
#: derived only through these is NOT data-derived (DL121/DL122)
STATIC_ATTRS = ("shape", "dtype", "ndim", "size")


@dataclass(frozen=True)
class Definition:
    """One binding of a name, created per *execution* of the binding
    statement (the loop back-edge pass mints fresh definitions, which
    is what lets loop-carried rebinding read as clean)."""

    uid: int                 # unique within one walker
    name: str
    line: int
    kind: str                # "param"|"assign"|"aug"|"for"|"with"|...
    index: Optional[int] = None   # position in a tuple-unpack target


Env = Dict[str, FrozenSet[Definition]]


def walk_skipping_attrs(node: ast.AST, skip_attrs: Sequence[str] = ()):
    """``ast.walk`` that does not descend into ``x.<attr>`` reads for
    the given attribute names (nor into nested def/class/lambda)."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, ast.Attribute) and n.attr in skip_attrs:
            continue
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            stack.append(child)


class FlowWalker:
    """Flow-sensitive interpreter over one scope (see module docstring).

    ``scope`` is a ``FunctionDef``/``AsyncFunctionDef`` (parameters are
    seeded as definitions), a ``Module`` (script-level statements —
    example scripts live there), or a ``Lambda``.
    """

    def __init__(self, scope: ast.AST):
        self.scope = scope
        self._next_uid = 0
        self.env: Env = {}
        self.state = self.initial_state()
        self.params: Dict[str, Definition] = {}
        self.param_names: List[str] = []         # positional order
        self.defaulted_params: Set[str] = set()  # bound at def time
        #: uid -> the value expression the definition was bound from
        self.def_value: Dict[int, Optional[ast.expr]] = {}

    # -- subclass hooks ---------------------------------------------------

    def initial_state(self):
        return None

    def copy_state(self, state):
        return state

    def merge_states(self, a, b):
        return a

    def on_load(self, node: ast.Name, defs: FrozenSet[Definition]) -> None:
        pass

    def on_call(self, call: ast.Call) -> None:
        """Fires after the call's func/args/keywords were evaluated."""

    def on_def(self, d: Definition) -> None:
        pass

    def on_expr_statement(self, value: ast.expr) -> None:
        pass

    def on_return(self, value: Optional[ast.expr]) -> None:
        pass

    # -- driving ----------------------------------------------------------

    def run(self) -> "FlowWalker":
        if isinstance(self.scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._seed_params(self.scope.args)
            self._exec_block(self.scope.body)
        elif isinstance(self.scope, ast.Lambda):
            self._seed_params(self.scope.args)
            self._eval(self.scope.body)
        else:
            self._exec_block(getattr(self.scope, "body", []))
        return self

    def _seed_params(self, args: ast.arguments) -> None:
        positional = list(args.posonlyargs) + list(args.args)
        n_defaults = len(args.defaults)
        for i, a in enumerate(positional):
            d = self._bind(a.arg, a.lineno, "param")
            self.params[a.arg] = d
            self.param_names.append(a.arg)
            if n_defaults and i >= len(positional) - n_defaults:
                self.defaulted_params.add(a.arg)
        for a, default in zip(args.kwonlyargs, args.kw_defaults):
            d = self._bind(a.arg, a.lineno, "param")
            self.params[a.arg] = d
            if default is not None:
                self.defaulted_params.add(a.arg)
        for a in (args.vararg, args.kwarg):
            if a is not None:
                self.params[a.arg] = self._bind(a.arg, a.lineno, "param")

    def _bind(self, name: str, line: int, kind: str,
              value: Optional[ast.expr] = None,
              index: Optional[int] = None) -> Definition:
        d = Definition(self._next_uid, name, line, kind, index)
        self._next_uid += 1
        self.def_value[d.uid] = value
        self.env[name] = frozenset((d,))
        self.on_def(d)
        return d

    def _snapshot(self):
        return dict(self.env), self.copy_state(self.state)

    def _restore(self, env: Env, state) -> None:
        self.env, self.state = env, state

    @staticmethod
    def _merge_env(a: Env, b: Env) -> Env:
        out = dict(a)
        for name, defs in b.items():
            out[name] = out.get(name, frozenset()) | defs
        return out

    def _merge_into(self, snaps) -> None:
        """Join the non-terminated branch exits in ``snaps``."""
        env, state = snaps[0]
        for e, s in snaps[1:]:
            env = self._merge_env(env, e)
            state = self.merge_states(state, s)
        self._restore(env, state)

    # -- statements -------------------------------------------------------

    def _exec_block(self, stmts: Iterable[ast.stmt]) -> bool:
        for st in stmts:
            if self._exec_stmt(st):
                return True
        return False

    def _exec_stmt(self, st: ast.stmt) -> bool:
        """Interpret one statement; True when the path terminates here
        (return/raise/break/continue or an If whose arms all do)."""
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in st.decorator_list:
                self._eval(dec)
            for dflt in list(st.args.defaults) + \
                    [d for d in st.args.kw_defaults if d is not None]:
                self._eval(dflt)
            self._bind(st.name, st.lineno, "def")
        elif isinstance(st, ast.ClassDef):
            for dec in st.decorator_list:
                self._eval(dec)
            for b in list(st.bases) + [k.value for k in st.keywords]:
                self._eval(b)
            self._bind(st.name, st.lineno, "def")
        elif isinstance(st, ast.Assign):
            self._eval(st.value)
            for t in st.targets:
                self._bind_target(t, st.value, "assign")
        elif isinstance(st, ast.AugAssign):
            if isinstance(st.target, ast.Name):
                self.on_load(st.target,
                             self.env.get(st.target.id, frozenset()))
            else:
                self._eval_store_base(st.target)
            self._eval(st.value)
            if isinstance(st.target, ast.Name):
                self._bind(st.target.id, st.lineno, "aug", st.value)
        elif isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self._eval(st.value)
                self._bind_target(st.target, st.value, "assign")
        elif isinstance(st, ast.Expr):
            self._eval(st.value)
            self.on_expr_statement(st.value)
        elif isinstance(st, ast.Return):
            self._eval(st.value)
            self.on_return(st.value)
            return True
        elif isinstance(st, ast.Raise):
            self._eval(st.exc)
            self._eval(st.cause)
            return True
        elif isinstance(st, (ast.Break, ast.Continue)):
            return True
        elif isinstance(st, ast.If):
            return self._exec_if(st)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            self._exec_loop(st, iter_expr=st.iter, target=st.target)
        elif isinstance(st, ast.While):
            self._exec_loop(st, test_expr=st.test)
        elif isinstance(st, ast.Try):
            return self._exec_try(st)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._eval(item.context_expr)
                if item.optional_vars is not None:
                    self._bind_target(item.optional_vars,
                                      item.context_expr, "with")
            return self._exec_block(st.body)
        elif isinstance(st, ast.Delete):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    self.env.pop(t.id, None)
                else:
                    self._eval_store_base(t)
        elif isinstance(st, (ast.Import, ast.ImportFrom)):
            for alias in st.names:
                local = alias.asname or alias.name.split(".")[0]
                if local != "*":
                    self._bind(local, st.lineno, "import")
        elif isinstance(st, ast.Assert):
            self._eval(st.test)
            self._eval(st.msg)
        elif isinstance(st, (ast.Global, ast.Nonlocal, ast.Pass)):
            pass
        else:
            # unknown statement kind (e.g. Match): over-approximate —
            # evaluate child expressions, run child blocks sequentially
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    self._eval(child)
            for field in ("body", "orelse", "finalbody", "cases"):
                sub = getattr(st, field, None)
                for item in sub or []:
                    if isinstance(item, ast.stmt):
                        self._exec_stmt(item)
                    else:                      # match_case
                        for s in getattr(item, "body", []) or []:
                            self._exec_stmt(s)
        return False

    def _exec_if(self, st: ast.If) -> bool:
        self._eval(st.test)
        fork = self._snapshot()
        t_body = self._exec_block(st.body)
        body_exit = self._snapshot()
        self._restore(*fork)
        t_else = self._exec_block(st.orelse)
        else_exit = self._snapshot()
        if t_body and t_else:
            return True
        if t_body:
            self._restore(*else_exit)
        elif t_else:
            self._restore(*body_exit)
        else:
            self._merge_into([body_exit, else_exit])
        return False

    def _exec_loop(self, st, iter_expr: Optional[ast.expr] = None,
                   target: Optional[ast.expr] = None,
                   test_expr: Optional[ast.expr] = None) -> None:
        if iter_expr is not None:
            self._eval(iter_expr)
        if test_expr is not None:
            self._eval(test_expr)
        entry = self._snapshot()
        if target is not None:
            self._bind_target(target, iter_expr, "for")
        self._exec_block(st.body)
        once = self._snapshot()
        # back-edge pass: reaching defs join entry ∪ first-iteration
        # exit, while the aux state continues from the first iteration
        # (iteration 2 definitely followed iteration 1 — that is how a
        # key consumed in iteration 1 and reused in iteration 2 is seen)
        self._restore(self._merge_env(entry[0], once[0]),
                      self.copy_state(once[1]))
        if target is not None:
            self._bind_target(target, iter_expr, "for")
        self._exec_block(st.body)
        twice = self._snapshot()
        # after the loop: zero, one, or more iterations all reach here
        self._merge_into([entry, once, twice])
        self._exec_block(st.orelse)

    def _exec_try(self, st: ast.Try) -> bool:
        entry = self._snapshot()
        t_body = self._exec_block(st.body)
        body_exit = self._snapshot()
        exits = []
        if not t_body:
            t_else = self._exec_block(st.orelse)
            if not t_else:
                exits.append(self._snapshot())
        # an exception may fire anywhere in the body: handlers start
        # from the join of entry and body-complete
        handler_entry = (self._merge_env(entry[0], body_exit[0]),
                         self.merge_states(self.copy_state(entry[1]),
                                           self.copy_state(body_exit[1])))
        for h in st.handlers:
            self._restore(dict(handler_entry[0]),
                          self.copy_state(handler_entry[1]))
            if h.type is not None:
                self._eval(h.type)
            if h.name:
                self._bind(h.name, h.lineno, "except")
            if not self._exec_block(h.body):
                exits.append(self._snapshot())
        if not exits:
            # every path raised/returned; run finalbody for its effects
            self._restore(*handler_entry)
            self._exec_block(st.finalbody)
            return True
        self._merge_into(exits)
        terminated = self._exec_block(st.finalbody)
        return terminated

    # -- binding targets --------------------------------------------------

    def _bind_target(self, target: ast.expr, value: Optional[ast.expr],
                     kind: str, index: Optional[int] = None) -> None:
        if isinstance(target, ast.Name):
            self._bind(target.id, target.lineno, kind, value, index)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for i, elt in enumerate(target.elts):
                self._bind_target(elt, value, kind,
                                  index=i if index is None else None)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, value, kind)
        else:                       # x.attr = ... / x[i] = ...: the base
            self._eval_store_base(target)   # is READ, nothing is bound

    def _eval_store_base(self, target: ast.expr) -> None:
        if isinstance(target, ast.Attribute):
            self._eval(target.value)
        elif isinstance(target, ast.Subscript):
            self._eval(target.value)
            self._eval(target.slice)

    # -- expressions ------------------------------------------------------

    def _eval(self, expr: Optional[ast.expr]) -> None:
        if expr is None:
            return
        if isinstance(expr, ast.Name):
            if isinstance(expr.ctx, ast.Load):
                self.on_load(expr, self.env.get(expr.id, frozenset()))
            return
        if isinstance(expr, ast.Call):
            self._eval(expr.func)
            for a in expr.args:
                self._eval(a)
            for kw in expr.keywords:
                self._eval(kw.value)
            self.on_call(expr)
            return
        if isinstance(expr, ast.Lambda):
            for dflt in list(expr.args.defaults) + \
                    [d for d in expr.args.kw_defaults if d is not None]:
                self._eval(dflt)
            saved = self._snapshot()
            for a in (list(expr.args.posonlyargs) + list(expr.args.args)
                      + list(expr.args.kwonlyargs)
                      + [x for x in (expr.args.vararg, expr.args.kwarg)
                         if x is not None]):
                self._bind(a.arg, expr.lineno, "param")
            self._eval(expr.body)
            self._restore(*saved)
            return
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            saved = self._snapshot()
            for gen in expr.generators:
                self._eval(gen.iter)
                self._bind_target(gen.target, gen.iter, "comp")
                for cond in gen.ifs:
                    self._eval(cond)
            if isinstance(expr, ast.DictComp):
                self._eval(expr.key)
                self._eval(expr.value)
            else:
                self._eval(expr.elt)
            self.env = saved[0]     # comp targets scope out; keep state
            return
        if isinstance(expr, ast.IfExp):
            self._eval(expr.test)
            fork = self._snapshot()
            self._eval(expr.body)
            body_exit = self._snapshot()
            self._restore(*fork)
            self._eval(expr.orelse)
            self._merge_into([body_exit, self._snapshot()])
            return
        if isinstance(expr, ast.NamedExpr):
            self._eval(expr.value)
            self._bind_target(expr.target, expr.value, "assign")
            return
        for child in ast.iter_child_nodes(expr):
            if isinstance(child, ast.expr):
                self._eval(child)
            elif isinstance(child, ast.comprehension):  # unreachable
                self._eval(child.iter)


class DefUse(FlowWalker):
    """Def-use chains for one scope: every load with its reaching
    definitions, calls/returns/bare-expressions in execution order."""

    def __init__(self, scope: ast.AST):
        super().__init__(scope)
        self._loads: Dict[int, Tuple[ast.Name, Set[Definition]]] = {}
        self.calls: List[ast.Call] = []
        self._seen_calls: Set[int] = set()
        self.expr_statements: List[ast.expr] = []
        self.returns: List[Optional[ast.expr]] = []
        self.defs: List[Definition] = []

    @classmethod
    def of(cls, scope: ast.AST) -> "DefUse":
        return cls(scope).run()     # type: ignore[return-value]

    def on_load(self, node, defs):
        slot = self._loads.setdefault(id(node), (node, set()))
        slot[1].update(defs)

    def on_call(self, call):
        if id(call) not in self._seen_calls:
            self._seen_calls.add(id(call))
            self.calls.append(call)

    def on_def(self, d):
        self.defs.append(d)

    def on_expr_statement(self, value):
        if value not in self.expr_statements:
            self.expr_statements.append(value)

    def on_return(self, value):
        self.returns.append(value)

    # -- chain queries ----------------------------------------------------

    def defs_of(self, name_node: ast.Name) -> FrozenSet[Definition]:
        slot = self._loads.get(id(name_node))
        return frozenset(slot[1]) if slot else frozenset()

    def loads_in(self, expr: Optional[ast.AST],
                 skip_attrs: Sequence[str] = ()) -> Set[Definition]:
        """Definitions reaching any ``Name`` load inside ``expr``."""
        out: Set[Definition] = set()
        if expr is None:
            return out
        for n in walk_skipping_attrs(expr, skip_attrs):
            if isinstance(n, ast.Name):
                slot = self._loads.get(id(n))
                if slot:
                    out.update(slot[1])
        return out

    def derived_from(self, seeds: Iterable[Definition],
                     skip_attrs: Sequence[str] = ()) -> Set[Definition]:
        """Close ``seeds`` over value expressions: a definition whose
        bound expression reads a derived definition is derived."""
        derived = set(seeds)
        changed = True
        while changed:
            changed = False
            for d in self.defs:
                if d in derived:
                    continue
                value = self.def_value.get(d.uid)
                if value is not None and \
                        self.loads_in(value, skip_attrs) & derived:
                    derived.add(d)
                    changed = True
        return derived

    def alias_origins(self, param_indices: Dict[str, int]
                      ) -> Dict[int, Set[int]]:
        """uid -> parameter indices, propagated ONLY through pure
        aliases (``b = a``; the matching element of ``a, b = x, y``).
        This is the consumption-tracking map: a value merely *derived*
        from a parameter (``x = jnp.zeros((n,)))`` is a fresh object —
        consuming/donating it does not consume the parameter."""
        origins: Dict[int, Set[int]] = {}
        for name, idx in param_indices.items():
            d = self.params.get(name)
            if d is not None:
                origins[d.uid] = {idx}
        changed = True
        while changed:
            changed = False
            for d in self.defs:
                value = self.def_value.get(d.uid)
                if (d.index is not None
                        and isinstance(value, (ast.Tuple, ast.List))
                        and d.index < len(value.elts)):
                    value = value.elts[d.index]
                if not isinstance(value, ast.Name):
                    continue
                merged: Set[int] = set()
                for src in self.loads_in(value):
                    merged |= origins.get(src.uid, set())
                if merged - origins.get(d.uid, set()):
                    origins[d.uid] = origins.get(d.uid, set()) | merged
                    changed = True
        return origins

    def param_origins(self, param_indices: Dict[str, int],
                      skip_attrs: Sequence[str] = ()
                      ) -> Dict[int, Set[int]]:
        """uid -> set of parameter indices the definition derives from."""
        origins: Dict[int, Set[int]] = {}
        for name, idx in param_indices.items():
            d = self.params.get(name)
            if d is not None:
                origins[d.uid] = {idx}
        changed = True
        while changed:
            changed = False
            for d in self.defs:
                value = self.def_value.get(d.uid)
                if value is None:
                    continue
                merged: Set[int] = set()
                for src in self.loads_in(value, skip_attrs):
                    merged |= origins.get(src.uid, set())
                if merged - origins.get(d.uid, set()):
                    origins[d.uid] = origins.get(d.uid, set()) | merged
                    changed = True
        return origins


# ---------------------------------------------------------------------------
# interprocedural parameter summaries
# ---------------------------------------------------------------------------


@dataclass
class ParamSummary:
    """What one function does with its parameters, as seen by dataflow."""

    returned: Set[int]               # param indices flowing to a return
    consumed: Dict[int, str]         # param index -> reason text


#: a rule-supplied detector: (defuse, call, func) -> [(arg_expr, reason)]
#: for the call's arguments the rule considers consumed at that site
ConsumeDetector = Callable[[DefUse, ast.Call, FunctionInfo],
                           List[Tuple[ast.expr, str]]]


def positional_param_indices(func_node: ast.AST) -> Dict[str, int]:
    """name -> positional index for a function's parameters."""
    args = func_node.args
    names = [a.arg for a in list(args.posonlyargs) + list(args.args)]
    return {n: i for i, n in enumerate(names)}


def map_args_to_params(call: ast.Call, callee: FunctionInfo
                       ) -> Dict[int, ast.expr]:
    """callee positional-param index -> caller argument expression,
    accounting for the implicit ``self`` when a method is called
    through an attribute receiver."""
    args = callee.node.args
    names = [a.arg for a in list(args.posonlyargs) + list(args.args)]
    offset = 1 if (callee.cls is not None
                   and isinstance(call.func, ast.Attribute)) else 0
    out: Dict[int, ast.expr] = {}
    for i, a in enumerate(call.args):
        if isinstance(a, ast.Starred):
            break
        idx = i + offset
        if idx < len(names):
            out[idx] = a
    by_name = {n: i for i, n in enumerate(names)}
    for kw in call.keywords:
        if kw.arg is not None and kw.arg in by_name:
            out[by_name[kw.arg]] = kw.value
    return out


class Analysis:
    """Memoized dataflow over one :class:`Project`: shared
    :class:`DefUse` per scope plus per-detector parameter summaries."""

    def __init__(self, project: Project):
        self.project = project
        self._defuse: Dict[int, DefUse] = {}
        self._summaries: Dict[Tuple[int, str], ParamSummary] = {}

    @classmethod
    def of(cls, project: Project) -> "Analysis":
        """One shared instance per project, so the five dataflow rules
        interpret each function once, not five times."""
        cached = getattr(project, "_dataflow_analysis", None)
        if cached is None:
            cached = cls(project)
            project._dataflow_analysis = cached   # type: ignore[attr-defined]
        return cached

    def defuse(self, scope: ast.AST) -> DefUse:
        du = self._defuse.get(id(scope))
        if du is None:
            du = DefUse.of(scope)
            self._defuse[id(scope)] = du
        return du

    def summary(self, func: FunctionInfo, detector: ConsumeDetector,
                detector_key: str, depth: int = 0,
                _stack: Optional[Set[str]] = None) -> ParamSummary:
        """Which of ``func``'s parameters are consumed (per
        ``detector``, composed through resolved calls) or returned."""
        key = (id(func.node), detector_key)
        cached = self._summaries.get(key)
        if cached is not None:
            return cached
        summary = ParamSummary(returned=set(), consumed={})
        self._summaries[key] = summary       # cycle guard: publish early
        stack = _stack if _stack is not None else set()
        stack.add(func.qualname)
        du = self.defuse(func.node)
        indices = positional_param_indices(func.node)
        # alias-only on purpose: "consumed" must mean THIS value was
        # handed over, not a fresh value computed from it
        origins = du.alias_origins(indices)

        def params_of(expr: ast.expr) -> Set[int]:
            out: Set[int] = set()
            for d in du.loads_in(expr):
                out |= origins.get(d.uid, set())
            return out

        for call in du.calls:
            for arg_expr, reason in detector(du, call, func):
                for p in params_of(arg_expr):
                    summary.consumed.setdefault(p, reason)
            if depth >= DEFAULT_CALL_DEPTH:
                continue
            callee = self.project.resolve_call(call, func)
            if callee is None or callee.qualname in stack:
                continue
            sub = self.summary(callee, detector, detector_key,
                               depth + 1, stack)
            if sub.consumed:
                arg_map = map_args_to_params(call, callee)
                for cidx, reason in sub.consumed.items():
                    if cidx in arg_map:
                        for p in params_of(arg_map[cidx]):
                            summary.consumed.setdefault(
                                p, f"{reason} (via {callee.name})")
        for ret in du.returns:
            if ret is not None:
                summary.returned |= params_of(ret)
        stack.discard(func.qualname)
        return summary


def scopes_in(tree: ast.AST) -> List[ast.AST]:
    """The dataflow scopes of one module: the module body itself
    (example scripts run there) plus every function/method, nested
    defs included — each analyzed independently."""
    out: List[ast.AST] = [tree]
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(n)
    return out
