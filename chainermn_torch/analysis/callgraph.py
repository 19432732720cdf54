"""Whole-program symbol table and call graph for the dlint project passes.

The per-file AST passes (:mod:`.ast_passes`) are deliberately
intra-function: a branch calling ``sync_helper()`` is not credited with
the ``comm.barrier()`` inside it. This module gives the interprocedural
rules (DL113–DL116, :mod:`.sequence` / :mod:`.locks`) the missing piece:
a :class:`Project` built once per lint run over every parsed file, with

* a **module table** — file path → dotted module name (derived by
  walking ``__init__.py`` packages up from the file, so fixture
  directories without packages still resolve as flat modules);
* a **symbol table** — every module-level function and every method,
  keyed ``module:func`` / ``module:Class.method``, plus per-class
  method maps, base-class links, and ``self.attr`` types harvested from
  ``self.attr = ClassName(...)`` assignments;
* **call resolution** — :meth:`Project.resolve_call` maps a call site
  to a :class:`FunctionInfo` through plain names, ``import`` /
  ``from .. import`` bindings (absolute and relative), ``self.method``
  dispatch (bases included), attribute chains (``mod.sub.fn``), and
  locally-typed receivers (``eng = Engine(...); eng.step()`` or an
  annotated parameter).

Resolution is deliberately CONSERVATIVE: a receiver whose class is not
statically known resolves to nothing (the interprocedural passes then
treat the call as opaque) rather than guessing by method name across
every class in the repo. That keeps the project rules' findings
high-confidence at the cost of missing dynamically-dispatched chains —
the same precision/recall trade every pass in this package documents
(docs/static_analysis.md#whole-program-engine).

Call-DEPTH bounding lives in the consumers: each project pass expands
callee summaries through :meth:`Project.resolve_call` down to a fixed
depth (:data:`DEFAULT_CALL_DEPTH`) with a cycle guard, so recursion and
deep chains cannot blow up a lint run.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: how many call hops the interprocedural passes follow before treating
#: a callee as opaque (summaries are memoized, so this bounds reported
#: chain length, not runtime)
DEFAULT_CALL_DEPTH = 6

#: wrappers that forward calls to their first positional argument:
#: ``g = partial(f, x)`` / ``g = jax.jit(f)`` — calling ``g`` runs
#: ``f``. NOT ``wraps``: ``functools.wraps(f)`` returns a decorator
#: for some OTHER function, not a callable forwarding to ``f``.
_WRAPPER_NAMES = {"partial", "jit", "pjit", "pmap", "vmap",
                  "lru_cache", "cache", "checkpoint", "remat"}

#: alias-chain resolution depth cap (``h = partial(g)``;
#: ``g = jit(f)`` …) — bounds lazy re-resolution, not graph size
_ALIAS_DEPTH = 4


@dataclass
class FunctionInfo:
    """One function or method the project knows by name."""

    qualname: str                    # "module:func" | "module:Class.meth"
    module: str
    name: str                        # terminal name
    cls: Optional[str]               # owning class name, if a method
    node: ast.AST                    # the FunctionDef / AsyncFunctionDef
    path: str


@dataclass
class ClassInfo:
    name: str
    module: str
    methods: Dict[str, FunctionInfo] = field(default_factory=dict)
    bases: List[str] = field(default_factory=list)      # base-class names
    attr_types: Dict[str, str] = field(default_factory=dict)
    # ``self.attr = ClassName(...)`` → attr → ClassName (project classes
    # only; harvested after every class is indexed)


@dataclass
class ModuleInfo:
    name: str
    path: str
    tree: ast.AST
    #: import bindings visible at module scope: local name → dotted
    #: module name, or (module, symbol) for ``from m import f``
    imports: Dict[str, object] = field(default_factory=dict)
    functions: Dict[str, FunctionInfo] = field(default_factory=dict)
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    #: ``g = wrapper(f, ...)`` module-level assignments: local name →
    #: the Call node, resolved LAZILY (the wrapped symbol may live in a
    #: module indexed later, and non-wrapper calls are filtered at
    #: resolution time, not here)
    alias_calls: Dict[str, ast.Call] = field(default_factory=dict)


def module_name_for(path: str) -> str:
    """Dotted module name, derived by walking enclosing packages."""
    path = os.path.abspath(path)
    base = os.path.splitext(os.path.basename(path))[0]
    parts = [] if base == "__init__" else [base]
    d = os.path.dirname(path)
    while d and os.path.exists(os.path.join(d, "__init__.py")):
        parts.insert(0, os.path.basename(d))
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return ".".join(parts) if parts else base


def _attr_chain(node: ast.expr) -> Optional[List[str]]:
    """``a.b.c`` → ``["a", "b", "c"]``; None when any link is not a
    plain name/attribute (e.g. a call or subscript in the chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.insert(0, node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.insert(0, node.id)
        return parts
    return None


def _ann_name(ann: Optional[ast.expr]) -> Optional[str]:
    """Terminal class name of an annotation (``Engine``,
    ``serving.Engine``, ``"Engine"``)."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.split(".")[-1].strip()
    chain = _attr_chain(ann)
    if chain:
        return chain[-1]
    return None


class Project:
    """Symbol table + call graph over one set of parsed files."""

    def __init__(self):
        self.modules: Dict[str, ModuleInfo] = {}       # name → module
        self.by_path: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}   # qualname → info
        self.classes: Dict[str, List[ClassInfo]] = {}  # name → candidates
        self._local_types: Dict[str, Dict[str, str]] = {}  # memo
        self._local_aliases: Dict[int, Dict[str, ast.Call]] = {}  # memo

    # -- construction -----------------------------------------------------

    @classmethod
    def build(cls, files: Dict[str, Tuple[ast.AST, str]]) -> "Project":
        """``files``: path → (parsed tree, source). Files that failed to
        parse must be filtered out by the caller (core.py reports DL000
        for them)."""
        proj = cls()
        for path in sorted(files):
            tree, _src = files[path]
            name = module_name_for(path)
            if name in proj.modules:      # collision: first (sorted) wins
                name = f"{name}@{len(proj.modules)}"
            mod = ModuleInfo(name=name, path=path, tree=tree)
            proj.modules[name] = mod
            proj.by_path[path] = mod
            proj._index_module(mod)
        proj._link_attr_types()
        return proj

    def _index_module(self, mod: ModuleInfo) -> None:
        pkg = mod.name.rsplit(".", 1)[0] if "." in mod.name else ""
        for node in mod.tree.body:
            self._index_stmt(mod, node, pkg)

    def _index_stmt(self, mod: ModuleInfo, node: ast.stmt,
                    pkg: str) -> None:
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                target = alias.name if alias.asname else \
                    alias.name.split(".")[0]
                mod.imports[local] = target
                if alias.asname is None and "." in alias.name:
                    # ``import a.b.c`` also makes the full dotted chain
                    # resolvable through attribute access on ``a``
                    mod.imports[alias.name] = alias.name
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                # relative import: climb from this module's package
                parts = mod.name.split(".")
                climb = len(parts) - node.level
                prefix = ".".join(parts[:climb]) if climb > 0 else ""
                base = f"{prefix}.{base}".strip(".") if base else prefix
            for alias in node.names:
                if alias.name == "*":
                    continue
                local = alias.asname or alias.name
                mod.imports[local] = (base, alias.name)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info = FunctionInfo(
                qualname=f"{mod.name}:{node.name}", module=mod.name,
                name=node.name, cls=None, node=node, path=mod.path)
            mod.functions[node.name] = info
            self.functions[info.qualname] = info
        elif isinstance(node, ast.ClassDef):
            ci = ClassInfo(name=node.name, module=mod.name)
            for b in node.bases:
                chain = _attr_chain(b)
                if chain:
                    ci.bases.append(chain[-1])
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    info = FunctionInfo(
                        qualname=f"{mod.name}:{node.name}.{item.name}",
                        module=mod.name, name=item.name, cls=node.name,
                        node=item, path=mod.path)
                    ci.methods[item.name] = info
                    self.functions[info.qualname] = info
            mod.classes[node.name] = ci
            self.classes.setdefault(node.name, []).append(ci)
        elif isinstance(node, ast.Assign):
            # candidate wrapper alias: ``g = something(f, ...)`` with a
            # name/attr first argument. Whether ``something`` actually
            # forwards calls is decided lazily in _through_wrapper.
            if (isinstance(node.value, ast.Call) and node.value.args
                    and _attr_chain(node.value.args[0]) is not None):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        mod.alias_calls[t.id] = node.value
        elif isinstance(node, (ast.If, ast.Try)):
            # module-level try/if wrappers around imports/defs (the
            # optional-dependency idiom) still contribute symbols
            for blk in ([node.body] + [getattr(node, "orelse", [])]
                        + [h.body for h in getattr(node, "handlers", [])]
                        + [getattr(node, "finalbody", [])]):
                for sub in blk or []:
                    self._index_stmt(mod, sub, pkg)

    def _link_attr_types(self) -> None:
        """Second pass: harvest ``self.attr = ClassName(...)`` so a
        later ``self.attr.method()`` resolves when ClassName is a
        project class with an unambiguous name."""
        for mod in self.modules.values():
            for ci in mod.classes.values():
                for meth in ci.methods.values():
                    for n in ast.walk(meth.node):
                        if not (isinstance(n, ast.Assign)
                                and isinstance(n.value, ast.Call)):
                            continue
                        callee = self._class_of_call(mod, n.value)
                        if callee is None:
                            continue
                        for t in n.targets:
                            if (isinstance(t, ast.Attribute)
                                    and isinstance(t.value, ast.Name)
                                    and t.value.id == "self"):
                                ci.attr_types[t.attr] = callee.name

    # -- lookup helpers ---------------------------------------------------

    def class_named(self, name: str,
                    prefer_module: Optional[str] = None
                    ) -> Optional[ClassInfo]:
        cands = self.classes.get(name) or []
        if not cands:
            return None
        if prefer_module:
            for ci in cands:
                if ci.module == prefer_module:
                    return ci
        return cands[0] if len(cands) == 1 else None

    def _class_of_call(self, mod: ModuleInfo,
                       call: ast.Call) -> Optional[ClassInfo]:
        """The project class a constructor call instantiates, if any."""
        chain = _attr_chain(call.func)
        if not chain:
            return None
        name = chain[-1]
        if len(chain) == 1:
            if name in mod.classes:
                return mod.classes[name]
            bound = mod.imports.get(name)
            if isinstance(bound, tuple):
                target = self.modules.get(bound[0])
                if target and bound[1] in target.classes:
                    return target.classes[bound[1]]
            return None
        # mod_alias.Class(...) — resolve the module prefix
        target = self._module_for_chain(mod, chain[:-1])
        if target and name in target.classes:
            return target.classes[name]
        return None

    def _module_for_chain(self, mod: ModuleInfo,
                          chain: List[str]) -> Optional[ModuleInfo]:
        """Resolve ``["pkg", "sub"]`` (an attribute chain minus the
        terminal symbol) to a known module via the import table."""
        dotted = ".".join(chain)
        bound = mod.imports.get(dotted)
        if isinstance(bound, str):
            return self.modules.get(bound)
        bound = mod.imports.get(chain[0])
        if isinstance(bound, str):
            full = ".".join([bound] + chain[1:])
            return self.modules.get(full)
        if isinstance(bound, tuple):   # from pkg import sub
            full = ".".join([f"{bound[0]}.{bound[1]}".strip(".")]
                            + chain[1:])
            return self.modules.get(full)
        return None

    def _method_on(self, ci: ClassInfo, name: str,
                   depth: int = 0) -> Optional[FunctionInfo]:
        if name in ci.methods:
            return ci.methods[name]
        if depth >= 4:
            return None
        for base in ci.bases:
            bi = self.class_named(base, prefer_module=ci.module)
            if bi is not None:
                hit = self._method_on(bi, name, depth + 1)
                if hit is not None:
                    return hit
        return None

    def local_types(self, func: FunctionInfo) -> Dict[str, str]:
        """name → class-name for locals whose type is statically known:
        annotated parameters and ``v = ClassName(...)`` assignments.
        Memoized — the interprocedural passes revisit functions once
        per caller."""
        cached = self._local_types.get(func.qualname)
        if cached is not None:
            return cached
        mod = self.modules[func.module]
        out: Dict[str, str] = {}
        args = func.node.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            ann = _ann_name(a.annotation)
            if ann and self.classes.get(ann):
                out[a.arg] = ann
        for n in ast.walk(func.node):
            if (isinstance(n, ast.Assign)
                    and isinstance(n.value, ast.Call)):
                ci = self._class_of_call(mod, n.value)
                if ci is None:
                    continue
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = ci.name
            elif (isinstance(n, ast.AnnAssign)
                    and isinstance(n.target, ast.Name)):
                ann = _ann_name(n.annotation)
                if ann and self.classes.get(ann):
                    out[n.target.id] = ann
        self._local_types[func.qualname] = out
        return out

    def local_aliases(self, func: FunctionInfo) -> Dict[str, ast.Call]:
        """``g = wrapper(f, ...)`` assignments inside ``func``: name →
        the Call node (same lazy contract as
        :attr:`ModuleInfo.alias_calls`). Memoized by node identity so
        synthetic contexts (module bodies wrapped as functions by the
        dataflow rules) are safe."""
        cached = self._local_aliases.get(id(func.node))
        if cached is not None:
            return cached
        out: Dict[str, ast.Call] = {}
        for n in ast.walk(func.node):
            if (isinstance(n, ast.Assign)
                    and isinstance(n.value, ast.Call) and n.value.args
                    and _attr_chain(n.value.args[0]) is not None):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = n.value
        self._local_aliases[id(func.node)] = out
        return out

    # -- the resolver -----------------------------------------------------

    def resolve_call(self, call: ast.Call, ctx: FunctionInfo,
                     local_types: Optional[Dict[str, str]] = None
                     ) -> Optional[FunctionInfo]:
        """Map one call site inside ``ctx`` to a known function, or
        None when the callee is not statically known. Sees through
        forwarding wrappers: ``g = partial(f, x)`` / ``g = jax.jit(f)``
        aliases (module-level and local), inline ``jit(f)(args)``
        application, and single-level project decorators whose body
        provably forwards (returns its function parameter or a nested
        def)."""
        mod = self.modules.get(ctx.module)
        if mod is None:
            return None
        if local_types is None:
            local_types = self.local_types(ctx)
        return self._resolve_func_expr(mod, call.func, ctx,
                                       local_types, 0)

    def _decorator_forwards(self, deco: FunctionInfo) -> bool:
        """True when ``deco`` is a single-level decorator shape: it
        takes exactly ONE positional parameter (the function) and
        either returns it (identity decorator) or returns a nested def
        while CALLING the parameter somewhere in its body (the standard
        closure decorator). A factory that returns a closure over
        config it never calls (``make_step(cfg)``) is NOT a decorator —
        treating it as one would invent edges from the closure to the
        config's constructor."""
        node = deco.node
        args = node.args
        pos = list(args.posonlyargs) + list(args.args)
        if len(pos) != 1 or args.kwonlyargs:
            return False
        fn_param = pos[0].arg
        nested = {n.name for n in ast.iter_child_nodes(node)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        returns_nested = False
        param_called = False
        for n in ast.walk(node):
            if isinstance(n, ast.Return) and isinstance(n.value, ast.Name):
                if n.value.id == fn_param:
                    return True
                if n.value.id in nested:
                    returns_nested = True
            elif (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Name)
                    and n.func.id == fn_param):
                param_called = True
        return returns_nested and param_called

    def _through_wrapper(self, mod: ModuleInfo, call: ast.Call,
                         ctx: FunctionInfo, local_types: Dict[str, str],
                         depth: int) -> Optional[FunctionInfo]:
        """Resolve the function a wrapper application forwards to:
        ``partial(f, x)`` / ``jit(f)`` → ``f``. Unknown callees only
        count when they resolve to a project function that provably
        forwards (see :meth:`_decorator_forwards`) — a plain data call
        ``x = compute(y)`` is NOT an alias."""
        if depth > _ALIAS_DEPTH or not call.args:
            return None
        chain = _attr_chain(call.func)
        if chain is None:
            # decorator-factory application: ``lru_cache(None)(f)``
            inner = call.func
            if (isinstance(inner, ast.Call)
                    and (_attr_chain(inner.func) or [""])[-1]
                    in _WRAPPER_NAMES):
                return self._resolve_func_expr(mod, call.args[0], ctx,
                                               local_types, depth + 1)
            return None
        if chain[-1] not in _WRAPPER_NAMES:
            deco = self._resolve_func_expr(mod, call.func, ctx,
                                           local_types, depth + 1)
            if deco is None or not self._decorator_forwards(deco):
                return None
        return self._resolve_func_expr(mod, call.args[0], ctx,
                                       local_types, depth + 1)

    def _resolve_func_expr(self, mod: ModuleInfo, expr: ast.expr,
                           ctx: FunctionInfo,
                           local_types: Dict[str, str],
                           depth: int) -> Optional[FunctionInfo]:
        if depth > _ALIAS_DEPTH:
            return None
        if isinstance(expr, ast.Call):
            # inline application: ``jit(f)(args)`` / ``partial(f, 1)()``
            return self._through_wrapper(mod, expr, ctx,
                                         local_types, depth)
        chain = _attr_chain(expr)
        if not chain:
            return None

        if len(chain) == 1:
            name = chain[0]
            if name in mod.functions:
                return mod.functions[name]
            bound = mod.imports.get(name)
            if isinstance(bound, tuple):
                target = self.modules.get(bound[0])
                if target is not None:
                    if bound[1] in target.functions:
                        return target.functions[bound[1]]
                    # ``from m import Class`` then ``Class()`` — the
                    # constructor body runs: resolve to __init__
                    if bound[1] in target.classes:
                        return self._method_on(
                            target.classes[bound[1]], "__init__")
                    if bound[1] in target.alias_calls:
                        return self._through_wrapper(
                            target, target.alias_calls[bound[1]],
                            ctx, local_types, depth + 1)
            if name in mod.classes:
                return self._method_on(mod.classes[name], "__init__")
            local = self.local_aliases(ctx)
            if name in local:
                return self._through_wrapper(mod, local[name], ctx,
                                             local_types, depth + 1)
            if name in mod.alias_calls:
                return self._through_wrapper(mod, mod.alias_calls[name],
                                             ctx, local_types, depth + 1)
            return None

        head, meth = chain[0], chain[-1]
        if head == "self" and ctx.cls is not None:
            ci = self.class_named(ctx.cls, prefer_module=ctx.module)
            if ci is None:
                return None
            if len(chain) == 2:
                return self._method_on(ci, meth)
            if len(chain) == 3 and chain[1] in ci.attr_types:
                owner = self.class_named(ci.attr_types[chain[1]],
                                         prefer_module=ctx.module)
                if owner is not None:
                    return self._method_on(owner, meth)
            return None
        if len(chain) == 2 and head in local_types:
            ci = self.class_named(local_types[head],
                                  prefer_module=ctx.module)
            if ci is not None:
                return self._method_on(ci, meth)
        target = self._module_for_chain(mod, chain[:-1])
        if target is not None:
            if meth in target.functions:
                return target.functions[meth]
            if meth in target.classes:
                return self._method_on(target.classes[meth], "__init__")
            if meth in target.alias_calls:
                return self._through_wrapper(target,
                                             target.alias_calls[meth],
                                             ctx, local_types, depth + 1)
        return None
