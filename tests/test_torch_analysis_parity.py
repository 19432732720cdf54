"""Parity of the port's dlint (``chainermn_torch.analysis``) with the JAX
package's (``chainermn_tpu.analysis``) on the JAX package's own fixtures.

The fixture sources are taken with ``ast`` from
``tests/analysis_tests/*.py``: every string passed to ``lint_source``,
``run_lint_sources`` or a local ``_lint``/``_lint_files`` helper. Each one
runs through both packages, and every rule the port keeps gives the same
``(rule, path, line)`` set, exactly. The fixtures whose result the port's
rules rightly change are listed in :data:`PORT_DIFFERS` with the change
and its reason. For DL118, DL121 and DL125, each JAX fixture rewritten in
the port's idiom (:data:`TWINS`) trips the port's rule on the lines JAX's
rule flags on the original, and the clean twins stay quiet. The two
output modules give the same SARIF results and fingerprints for the same
findings, and a baseline either one writes filters the other's run.

Pure-AST tests: no devices, no torch tensors.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import ast
import glob
import os
import textwrap

import pytest

import chainermn_torch.analysis as port
import chainermn_tpu.analysis as jax_lint

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIXTURE_FILES = sorted(glob.glob(os.path.join(
    _REPO, "tests", "analysis_tests", "test_*.py")))
_HELPERS = {"_lint", "lint_source", "_lint_files", "run_lint_sources"}


# ---------------------------------------------------------------------------
# fixture extraction
# ---------------------------------------------------------------------------


def _value(node, env):
    """The string (or dict of strings) an expression builds from literals
    and names bound to literals: concatenation, ``textwrap.dedent(..)``,
    ``str.replace(..)`` with literal arguments, dict displays and
    ``dict(k=...)``; None when it is not static."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _value(node.left, env), _value(node.right, env)
        return a + b if isinstance(a, str) and isinstance(b, str) else None
    if isinstance(node, ast.Dict):
        out = {}
        for i, (k, v) in enumerate(zip(node.keys, node.values)):
            key, src = _value(k, env), _value(v, env)
            if not isinstance(src, str):
                return None
            # a key built at run time (a tmp path) names the i-th file
            out[key if isinstance(key, str) else f"file{i}.py"] = src
        return out
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr == "dedent" and node.args:
        return _value(node.args[0], env)
    if isinstance(fn, ast.Attribute) and fn.attr == "replace":
        base = _value(fn.value, env)
        args = [_value(a, env) for a in node.args]
        if isinstance(base, str) and len(args) == 2 \
                and all(isinstance(a, str) for a in args):
            return base.replace(*args)
        return None
    if isinstance(fn, ast.Name) and fn.id == "dict" and not node.args:
        out = {kw.arg: _value(kw.value, env) for kw in node.keywords}
        if all(isinstance(k, str) and isinstance(v, str)
               for k, v in out.items()):
            return out
    return None


def _bindings(stmts, env):
    for st in stmts:
        if (isinstance(st, ast.Assign) and len(st.targets) == 1
                and isinstance(st.targets[0], ast.Name)):
            v = _value(st.value, env)
            if v is not None:
                env[st.targets[0].id] = v


def _sources_of(call, env):
    """The ``{path: source}`` one lint call analyses, or None."""
    fn = call.func
    name = fn.id if isinstance(fn, ast.Name) else getattr(fn, "attr", None)
    if name in ("_lint", "lint_source"):
        src = _value(call.args[0], env) if call.args else None
        return ({"fixture.py": textwrap.dedent(src)}
                if isinstance(src, str) else None)
    if name == "_lint_files":
        files = {}
        for kw in call.keywords:
            if kw.arg == "rules":
                continue
            v = _value(kw.value, env)
            if kw.arg is None and isinstance(v, dict):
                pairs = v.items()
            elif isinstance(v, str):
                pairs = [(kw.arg, v)]
            else:
                return None
            for mod, src in pairs:
                files[mod.replace(".", "/") + ".py"] = textwrap.dedent(src)
        return files
    files = _value(call.args[0], env) if call.args else None
    return files if isinstance(files, dict) else None


def extract_fixtures():
    """``[(fixture id, {path: source} or None)]`` for every lint call in
    a test function of ``tests/analysis_tests/``, in file order; the id is
    ``file::test[k]`` for the test's k-th lint call."""
    out = []
    for path in _FIXTURE_FILES:
        tree = ast.parse(open(path, encoding="utf-8").read())
        module_env = {}
        _bindings(tree.body, module_env)
        for fn in tree.body:
            if not (isinstance(fn, ast.FunctionDef)
                    and fn.name.startswith("test")):
                continue
            assigns = sorted((n for n in ast.walk(fn)
                              if isinstance(n, ast.Assign)),
                             key=lambda n: n.lineno)
            calls = sorted(
                (n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and (getattr(n.func, "id", None) in _HELPERS
                      or getattr(n.func, "attr", None) in _HELPERS)),
                key=lambda n: (n.lineno, n.col_offset))
            for k, call in enumerate(calls, 1):
                # the names as they stand where the call is made
                env = dict(module_env)
                _bindings([a for a in assigns if a.lineno < call.lineno],
                          env)
                fid = f"{os.path.basename(path)}::{fn.name}[{k}]"
                out.append((fid, _sources_of(call, env)))
    return out


FIXTURES = extract_fixtures()
_BY_ID = dict(FIXTURES)

#: the rules the port keeps with JAX's names (extended): every source
#: rule it registers
KEPT = sorted(r for r, rule in port.RULES.items()
              if rule.kind in ("ast", "project") and r in jax_lint.RULES)

#: fixtures whose result the port's rules rightly change: id ->
#: (findings only JAX's rule gives, findings only the port's gives, why)
PORT_DIFFERS = {
    "test_ast_rules.py::test_dl103_flags_device_rank_as_object_root[1]": (
        {("DL103", "fixture.py", 2)}, set(),
        "the port's object collectives take communicator ranks, so "
        "comm.rank is the right root of bcast_obj there"),
    "test_ast_rules.py::test_dl103_clean_roots[1]": (
        set(), {("DL103", "fixture.py", 4)},
        "the port's object collectives take communicator ranks, so "
        "comm.inter_rank (a node index) is the wrong root of bcast_obj"),
}


def _lines(lint, files, rules=KEPT):
    return {(f.rule, f.path, f.line)
            for f in lint.run_lint_sources(files).findings
            if f.rule in rules}


def test_fixtures_are_extracted_from_every_rule_file():
    resolved = [fid for fid, files in FIXTURES if files is not None]
    assert len(resolved) >= 190, len(resolved)
    assert {fid.split("::")[0] for fid in resolved} >= {
        "test_ast_rules.py", "test_dataflow_rules.py",
        "test_interprocedural.py", "test_locks.py", "test_output.py"}
    # every lint call's sources are static: none is dropped silently
    assert [fid for fid, files in FIXTURES if files is None] == []
    assert set(PORT_DIFFERS) <= set(_BY_ID)


def test_the_port_keeps_every_jax_source_rule_it_registers():
    jax_source = {r for r, rule in jax_lint.RULES.items()
                  if rule.kind in ("ast", "project")}
    assert set(KEPT) == jax_source - set(port.NOT_APPLICABLE)
    assert set(port.NOT_APPLICABLE) == {"DL108", "DL119", "DL122"}


def test_the_port_exports_jaxs_names_but_the_hlo_parsers():
    hlo_only = {"parse_computations", "scheduled_entry_ops",
                "check_pipeline_permute_overlap",
                "check_fsdp_gather_liveness", "check_quantized_wire_dtype"}
    jax_names = {n for n in vars(jax_lint) if not n.startswith("_")}
    port_names = {n for n in vars(port) if not n.startswith("_")}
    assert jax_names - hlo_only - {"hlo_passes"} <= port_names
    assert {"NOT_APPLICABLE", "NOT_YET_PORTED", "trace_passes"} \
        <= port_names


@pytest.mark.parametrize("fid", [fid for fid, files in FIXTURES
                                 if files is not None])
def test_port_gives_jaxs_rule_lines_on_jaxs_fixture(fid):
    files = _BY_ID[fid]
    want = _lines(jax_lint, files)
    got = _lines(port, files)
    jax_only, port_only, _why = PORT_DIFFERS.get(fid, (set(), set(), ""))
    assert (want - got, got - want) == (jax_only, port_only)


# ---------------------------------------------------------------------------
# DL118, DL121, DL125: JAX's fixtures rewritten in the port's idiom
# ---------------------------------------------------------------------------

#: JAX fixture id -> the same program in the port's idiom; each trips the
#: port's rule on the lines JAX's rule flags on the original (none for a
#: clean twin)
_DF = "test_dataflow_rules.py::"

TWINS = {
    _DF + "test_dl118_flags_straight_line_key_reuse[1]": """\
    from chainermn_torch.serving.sampling import sample_tokens

    def sample(logits, keys, t, k):
        a, _ = sample_tokens(logits, keys, t, k)
        b, _ = sample_tokens(logits, keys, t, k)
        return a, b
    """,
    _DF + "test_dl118_flags_reuse_across_loop_iterations[1]": """\
    from chainermn_torch.serving.sampling import sample_tokens

    def sample(logits, keys, t, k, xs):
        out = []
        for x in xs:
            out.append(sample_tokens(x, keys, t, k)[0])
        return out
    """,
    _DF + "test_dl118_flags_discarded_split_result[1]": """\
    from chainermn_torch.serving.sampling import split_keys

    def advance(keys):
        split_keys(keys)
        return keys
    """,
    _DF + "test_dl118_flags_reuse_through_a_callee[1]": """\
    from chainermn_torch.serving.sampling import sample_tokens

    def draw(k, logits):
        return sample_tokens(logits, k, 1.0, 0)[0]

    def sample(keys, logits):
        a = draw(keys, logits)
        b = draw(keys, logits)
        return a, b
    """,
    _DF + "test_dl118_clean_split_and_rebind[1]": """\
    from chainermn_torch.serving.sampling import sample_tokens, split_keys

    def sample(keys, logits, t, k):
        keys, sub = split_keys(keys)
        a, _ = sample_tokens(logits, sub, t, k)
        keys, sub = split_keys(keys)
        b, _ = sample_tokens(logits, sub, t, k)
        return a, b
    """,
    _DF + "test_dl118_clean_distinct_split_indices[1]": """\
    from chainermn_torch.serving.sampling import sample_tokens, split_keys

    def sample(keys, logits, t, k):
        ks = split_keys(keys)
        a, _ = sample_tokens(logits, ks[1], t, k)
        nxt, _ = split_keys(ks[0])
        return a, nxt
    """,
    _DF + "test_dl118_clean_fold_in_per_iteration[1]": """\
    from chainermn_torch.ops.dropout import dropout, fold_in

    def forward(key, xs):
        out = []
        for i, x in enumerate(xs):
            k = fold_in(key, i)
            out.append(dropout(x, 0.1, k, True))
        return out
    """,
    _DF + "test_dl118_clean_one_consumer_per_branch_arm[1]": """\
    from chainermn_torch.serving.sampling import sample_tokens

    def sample(keys, logits, t, k, greedy):
        if greedy:
            return sample_tokens(logits, keys, 0.0, 0)
        return sample_tokens(logits, keys, t, k)
    """,
    _DF + "test_dl121_flags_np_asarray_in_decode_root[1]": """\
    import torch

    def decode_k_step(tokens, logits):
        host = logits.cpu()
        return host
    """,
    _DF + "test_dl121_flags_host_pull_reached_through_callee[1]": """\
    def _pull(v):
        return v.tolist()

    def decode_k_loop(logits):
        return _pull(logits)
    """,
    _DF + "test_dl121_flags_item_in_serving_step_method[1]": """\
    class ServingStep:
        def step(self, tokens):
            return tokens.numpy()
    """,
    _DF + "test_dl121_clean_device_resident_decode[1]": """\
    import torch

    def decode_k_step(logits):
        return logits.argmax(-1)
    """,
    _DF + "test_dl121_clean_self_state_pull[1]": """\
    import torch

    class ServingStep:
        def cursors(self):
            return self.cache.cpu()
    """,
    _DF + "test_dl121_clean_test_functions_are_not_roots[1]": """\
    import torch

    def test_decode_k_eos_masks(logits):
        return logits.cpu()
    """,
    _DF + "test_dl125_flags_unverified_draft_commit[1]": """\
    from chainermn_torch.serving.sampling import draft_shadow_keys, \\
        sample_tokens

    def round(self, req, logits, keys, temps, topks):
        shadow = draft_shadow_keys(keys)
        tok, shadow = sample_tokens(logits, shadow, temps, topks)
        self._emit(req, tok)
    """,
    _DF + "test_dl125_flags_commit_of_rebound_shadow_sample[1]": """\
    from chainermn_torch.serving.sampling import draft_shadow_keys, \\
        sample_tokens

    def round(model, cache, logits, keys, temps, topks, spec_k):
        shadow = draft_shadow_keys(keys)
        tok, shadow = sample_tokens(logits, shadow, temps, topks)
        nxt, shadow = sample_tokens(model(tok), shadow, temps, topks)
        cache.append(nxt)
    """,
    _DF + "test_dl125_clean_verified_draft_commit[1]": """\
    from chainermn_torch.serving.sampling import draft_shadow_keys, \\
        sample_tokens

    def round(self, req, logits, keys, temps, topks):
        shadow = draft_shadow_keys(keys)
        tok, shadow = sample_tokens(logits, shadow, temps, topks)
        ok = self.verify_apply(tok)
        if ok:
            self._emit(req, tok)
    """,
    _DF + "test_dl125_clean_real_key_sampling[1]": """\
    from chainermn_torch.serving.sampling import sample_tokens

    def round(self, req, logits, keys, temps, topks):
        tok, keys = sample_tokens(logits, keys, temps, topks)
        self._emit(req, tok)
    """,
    _DF + "test_dl125_clean_verify_on_one_branch_only_still_flags[1]": """\
    from chainermn_torch.serving.sampling import draft_shadow_keys, \\
        sample_tokens

    def round(self, req, logits, keys, temps, topks, fast):
        shadow = draft_shadow_keys(keys)
        tok, shadow = sample_tokens(logits, shadow, temps, topks)
        if fast:
            pass
        else:
            self.verify_apply(tok)
        self._emit(req, tok)
    """,
}


def test_every_jax_fixture_of_the_three_rules_has_a_twin():
    ours = {fid for fid, files in FIXTURES
            if files is not None and fid.startswith("test_dataflow_rules.py")
            and any(f"test_dl{n}_" in fid for n in (118, 121, 125))}
    assert ours == set(TWINS)


@pytest.mark.parametrize("fid", sorted(TWINS))
def test_port_idiom_twin_trips_the_port_rule_on_jaxs_lines(fid):
    rule = "DL" + fid.split("test_dl")[1][:3]
    want = {line for _r, _p, line in _lines(jax_lint, _BY_ID[fid], [rule])}
    got = {line for _r, _p, line in _lines(
        port, {"fixture.py": textwrap.dedent(TWINS[fid])}, [rule])}
    assert got == want


# ---------------------------------------------------------------------------
# the output modules: one SARIF, one fingerprint, one baseline
# ---------------------------------------------------------------------------

_SOURCES = {
    "a.py": ("def f(comm):\n"
             "    if comm.rank == 0:\n"
             "        comm.barrier()\n"),
    "b.py": ("def g(comm, x):\n"
             "    if comm.rank == 1:\n"
             "        comm.psum(x)\n"
             "        comm.psum(x)  # dlint: disable=DL101 — fixture\n"),
}


@pytest.fixture
def tree(tmp_path):
    for name, src in _SOURCES.items():
        (tmp_path / name).write_text(src)
    return tmp_path


def _run(lint, tree):
    return lint.run_lint([str(tree / n) for n in sorted(_SOURCES)])


def test_same_findings_give_the_same_sarif_results_and_fingerprints(tree):
    run = _run(jax_lint, tree)
    assert [f.rule for f in run.findings] == ["DL101", "DL101"]
    assert [(f.rule, f.line) for f in _run(port, tree).findings] \
        == [(f.rule, f.line) for f in run.findings]
    j = jax_lint.to_sarif(run.findings, root=str(tree),
                          suppressions=run.suppressions)
    p = port.to_sarif(run.findings, root=str(tree),
                      suppressions=run.suppressions)
    (jrun,), (prun,) = j["runs"], p["runs"]
    assert prun["results"] == jrun["results"]
    assert prun["properties"] == jrun["properties"]
    assert prun["originalUriBaseIds"] == jrun["originalUriBaseIds"]
    assert (p["version"], p["$schema"]) == (j["version"], j["$schema"])
    # one catalogue of IDs, so a result's ruleIndex names the same rule
    assert [r["id"] for r in prun["tool"]["driver"]["rules"]] \
        == [r["id"] for r in jrun["tool"]["driver"]["rules"]]
    assert port.fingerprints(run.findings, root=str(tree)) \
        == jax_lint.fingerprints(run.findings, root=str(tree))
    # each reads the other's log back to the same findings
    def rows(findings):
        return [(f.rule, f.path, f.line, f.message) for f in findings]

    assert rows(port.from_sarif(j)[0]) == rows(jax_lint.from_sarif(p)[0])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_baseline_either_writes_filters_the_others_run(tree, writer):
    mods = {"jax": jax_lint, "port": port}
    reader = mods["port" if writer == "jax" else "jax"]
    base = tree / "baseline.json"
    mods[writer].write_baseline(str(base), _run(mods[writer], tree).findings,
                                root=str(tree))
    known = reader.load_baseline(str(base))
    assert len(known) == 2
    assert reader.filter_new(_run(reader, tree).findings, known,
                             root=str(tree)) == []
    # a new finding still gates
    (tree / "c.py").write_text("def h(comm):\n    if comm.rank:\n"
                               "        comm.barrier()\n")
    new = reader.run_lint([str(tree / n) for n in ("a.py", "b.py", "c.py")])
    assert [(f.path, f.line) for f in reader.filter_new(
        new.findings, known, root=str(tree))] == [(str(tree / "c.py"), 3)]
