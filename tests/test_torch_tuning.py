"""The port's schedule tuner (``chainermn_torch.tuning``) against the JAX
package's (``chainermn_tpu.tuning``), on the same inputs.

* Topology: built with JAX's tier constants (and JAX's storage wire), the
  port's estimates equal JAX's to 1e-12 relative for every strategy and
  wire, its fingerprint and description are JAX's; its defaults carry the
  port's H100 fit, and ``CostModel.as_topology`` is the same estimator as
  ``CostModel.estimate_us`` (every wire: both price the port's int32
  codes).
* Profile DB: the same versioned JSON; a model's key over the flax
  layout equals JAX's key of the converted parameters.
* Tuner: ``tune_canned`` gives JAX's plans field for field (flat, 1 MiB,
  ``size`` order at overlap 0.96875 on one tier of 8; the synthesized
  ``cascade-1`` at 0.984375 on 4 x 2) and JAX's candidate rows at the
  ResNet-50 default of 51 MiB; ``schedtune`` gives JAX's JSON for the
  same flags, up to the numbers the re-tiered defaults change.
* Tuned optimizer: on a 2-rank gloo world a tuned optimizer's MNIST steps
  equal the flat reducer's bit for bit (gradients rounded to multiples
  of 2^-16, so every sum is exact); a DB written by JAX's
  ``tools/schedtune.py`` drives the port, and the port's loads in JAX; a
  stale fingerprint and a missing entry are refused with JAX's texts.
* ``TuningReport`` gives JAX's observations and line.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

import chainermn_tpu.tuning as jt
from chainermn_tpu.collectives import CostModel as JCost
from chainermn_tpu.training.reports import TuningReport as JReport
from chainermn_torch import tuning as tt
from chainermn_torch.collectives import AutoReducer, CostModel, quantized
from chainermn_torch.tuning import topology as ttopo
from tests.test_torch_mp import REPO, assert_ranks_ok, run_world

GRAD_BYTES = 51 << 20
WIRES = ("f32", "bf16", "int8", "int8-block", "int4-block")


def port_topology(j, wire="storage"):
    """The port's Topology with a JAX Topology's tiers and constants."""
    return tt.Topology(
        tuple(tt.Tier(t.name, t.size, t.latency_us, t.bw_gbps)
              for t in j.tiers),
        platform=j.platform, device_kind=j.device_kind,
        quant_overhead_us=j.quant_overhead_us, wire=wire)


def jax_three_tier():
    return jt.Topology((jt.Tier("ici", 2, 1.0, 100.0),
                        jt.Tier("nvl", 2, 10.0, 50.0),
                        jt.Tier("dcn", 2, 100.0, 25.0)))


FIXTURES = {"8": jt.single_tier(8), "4x2": jt.two_tier(4, 2),
            "2x2x2": jax_three_tier(),
            "kind": jt.Topology((jt.Tier("ici", 4, 2.5, 80.0),),
                                platform="tpu", device_kind="TPU v5 lite")}


def _stub_comm(n, intra, device="cpu"):
    """What ``Topology.from_comm`` reads of a single-axis communicator."""
    return types.SimpleNamespace(device=torch.device(device),
                                 axis_names=("r",), size=n,
                                 intra_size=intra, mesh_shape={"r": n})


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_main(main, argv, monkeypatch):
    """(stdout, stderr, exit status) of a tool's ``main`` on ``argv``."""
    out, err = io.StringIO(), io.StringIO()
    monkeypatch.setattr(sys, "argv", ["tool", *argv])
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            ret = main()
            code = ret or 0
        except SystemExit as e:
            code = e.code
    return out.getvalue(), err.getvalue(), code


# -- topology -----------------------------------------------------------------

@pytest.mark.parametrize("name", list(FIXTURES))
def test_topology_estimates_and_fingerprint_are_jaxs(name):
    """Every strategy and wire at sizes from 1 B to 64 MiB, to 1e-12
    relative; the same fingerprint, shape and description."""
    j = FIXTURES[name]
    p = port_topology(j)
    assert (p.n, p.intra, p.inter) == (j.n, j.intra, j.inter)
    assert p.fingerprint() == j.fingerprint()
    assert p.describe() == j.describe()
    for nbytes in (1, 4096, 1 << 20, 3 * (1 << 20) + 7, 64 << 20):
        for s in ("flat", "hierarchical"):
            assert p.estimate_us(s, nbytes) == pytest.approx(
                j.estimate_us(s, nbytes), rel=1e-12)
        for wf in WIRES:
            assert p.estimate_us("quantized", nbytes, wf) == pytest.approx(
                j.estimate_us("quantized", nbytes, wf), rel=1e-12)
    for bad in (("psum_scatter", {}), ("quantized", {"wire_format": "fp8"})):
        with pytest.raises(ValueError):
            p.estimate_us(bad[0], 1024, **bad[1])


def test_wire_tables_and_defaults_are_the_ports():
    """JAX's storage table is the codec's ``wire_ratio``; the collective
    table is ``collective_wire_ratio``; the defaults are the H100 fit of
    ``collectives.auto.CostModel`` and a one-tier topology of the port
    prices int32 codes."""
    for wf in WIRES:
        assert ttopo.WIRE_RATIO[wf] == jt.topology.WIRE_RATIO[wf] \
            == quantized.wire_ratio(wf)
        assert ttopo.COLLECTIVE_WIRE_RATIO[wf] == \
            quantized.collective_wire_ratio(wf)
    cost = CostModel()
    assert (ttopo.ICI_LATENCY_US, ttopo.ICI_BW_GBPS,
            ttopo.QUANT_OVERHEAD_US) == (55.31, 368.22, 138.77) == (
        cost.ici_latency_us, cost.ici_bw_gbps, cost.quant_overhead_us)
    assert (ttopo.DCN_LATENCY_US, ttopo.DCN_BW_GBPS) == (
        cost.dcn_latency_us, cost.dcn_bw_gbps) == (100.0, 25.0)
    t = tt.two_tier(4, 2)
    assert t.fingerprint() == "gpu:generic/nvlink:4+net:2"
    assert t.wire == "collective"
    assert t.estimate_us("quantized", 1 << 20, "int8-block") > \
        port_topology(jt.two_tier(4, 2)).estimate_us(
            "quantized", 1 << 20, "int8-block")
    with pytest.raises(ValueError, match="at least one tier"):
        tt.Topology(())
    with pytest.raises(ValueError, match="wire accounting"):
        tt.Topology(t.tiers, wire="packed")


@pytest.mark.parametrize("intra", [None, 4, 8, 1])
def test_from_comm_factors_as_jaxs(intra):
    """A single-axis communicator of 8 factors as JAX's (``nvlink``/
    ``net`` in place of ``ici``/``dcn``), with the tier constants
    forwarded; the device names the platform and kind."""
    import jax

    from chainermn_tpu.comm.xla import XlaCommunicator

    jcomm = XlaCommunicator(mesh=jax.sharding.Mesh(
        np.asarray(jax.devices()[:8]), ("r",)))
    kw = dict(ici_latency_us=3.0, ici_bw_gbps=42.0, dcn_latency_us=9.0,
              dcn_bw_gbps=7.0, quant_overhead_us=5.0)
    j = jt.Topology.from_comm(jcomm, intra=intra, **kw)
    p = tt.Topology.from_comm(_stub_comm(8, jcomm.intra_size),
                              intra=intra, **kw)
    rename = {"ici": "nvlink", "dcn": "net"}
    assert [(rename[t.name], t.size, t.latency_us, t.bw_gbps)
            for t in j.tiers] == [(t.name, t.size, t.latency_us, t.bw_gbps)
                                  for t in p.tiers]
    assert (p.platform, p.device_kind, p.quant_overhead_us) == (
        "cpu", "cpu", 5.0)
    with pytest.raises(ValueError, match="must divide"):
        tt.Topology.from_comm(_stub_comm(8, 4), intra=3)


def test_cost_model_as_topology_is_the_same_estimator():
    """``CostModel.as_topology`` and ``CostModel.estimate_us`` agree to
    1e-12 relative for every strategy and wire, one tier and two; JAX's
    pair agrees where its wires are JAX's (bf16 and f32)."""
    cost = CostModel(ici_bw_gbps=42.0, dcn_latency_us=9.0)
    jcost = JCost(**dataclasses.asdict(cost))
    for intra in (4, 8):
        topo = cost.as_topology(_stub_comm(8, 4), intra=intra)
        for s in ("flat", "hierarchical"):
            assert topo.estimate_us(s, 8 << 20) == pytest.approx(
                cost.estimate_us(s, 8 << 20, topo), rel=1e-12)
            assert topo.estimate_us(s, 8 << 20) == pytest.approx(
                jcost.estimate_us(s, 8 << 20, topo), rel=1e-12)
        for wf in WIRES:
            assert topo.estimate_us("quantized", 8 << 20, wf) == \
                pytest.approx(cost.estimate_us("quantized", 8 << 20, topo,
                                               wire_format=wf), rel=1e-12)


# -- the profile DB -------------------------------------------------------------

#: one tier of 8 CPU devices, as JAX describes its test mesh
CPU8 = jt.Topology((jt.Tier("ici", 8, 1.0, 100.0),), platform="cpu",
                   device_kind="cpu")


def _plan(mod, **kw):
    base = dict(fingerprint="cpu:cpu/ici:8", model_key="rn50",
                strategy="hierarchical", bucket_bytes=1 << 20,
                bucket_order="size", overlap_fraction=0.96875,
                est_exposed_us=12.5, buckets=(("flat", 1 << 20),))
    base.update(kw)
    return mod.SchedulePlan(**base)


def test_profile_db_files_are_jaxs(tmp_path, monkeypatch):
    """A DB written by either package reads back in the other, byte for
    byte the same JSON; the environment variable and default path are
    JAX's; a corrupt file is an empty DB."""
    prog = {"name": "cascade-1", "tier_sizes": [4, 2],
            "steps": [["reduce_scatter", 0, "f32"],
                      ["all_reduce", 1, "f32"], ["all_gather", 0, "f32"]]}
    for mod, other in ((jt, tt), (tt, jt)):
        path = str(tmp_path / f"{mod.__name__}.json")
        db = mod.ProfileDB(path)
        db.put_plan(_plan(mod))
        db.put_plan(_plan(mod, model_key="default", strategy="synth",
                          program=prog, source="trace"))
        db.put_measured(CPU8, {("flat", 1 << 20): 42.5})
        db.save()
        back = other.ProfileDB(path)
        assert back.plan_for(CPU8, "rn50").to_dict() == \
            _plan(mod).to_dict()
        assert back.plan_for(CPU8).program == prog
        assert back.measured_for(CPU8) == {("flat", 1 << 20): 42.5}
        assert back.plan_for(jt.single_tier(4)) is None
    assert (tmp_path / "chainermn_tpu.tuning.json").read_text() == (
        tmp_path / "chainermn_torch.tuning.json").read_text()
    (tmp_path / "bad.json").write_text("{not json")
    assert tt.ProfileDB(str(tmp_path / "bad.json")).plan_for(CPU8) is None
    monkeypatch.setenv("CHAINERMN_TPU_PROFILE_DB", str(tmp_path / "e.json"))
    assert tt.default_db_path() == jt.default_db_path() == str(
        tmp_path / "e.json")
    monkeypatch.delenv("CHAINERMN_TPU_PROFILE_DB")
    assert tt.default_db_path() == jt.default_db_path()


def test_model_key_is_jaxs_over_the_flax_layout():
    """The port keys the MLP and the TransformerLM over their parameters
    in flax's layout and paths (``models.convert.flax_params``), so a
    model's key equals JAX's key of its converted flax parameters; a
    dict is keyed as JAX keys it; values do not matter, shapes do."""
    import jax
    import jax.numpy as jnp

    from chainermn_tpu.models import MLP as JMLP
    from chainermn_tpu.models.transformer import TransformerLM as JLM
    from chainermn_torch.models import MLP
    from chainermn_torch.models.transformer import TransformerLM

    jp = JMLP(n_units=32).init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 28, 28)))["params"]
    assert tt.model_key_for(MLP(n_units=32, device="cpu")) == \
        jt.model_key_for(jp)
    lm = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_len=16, pos_emb="rope")
    jlp = JLM(**lm).init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 16), jnp.int32))["params"]
    assert tt.model_key_for(TransformerLM(**lm, device="cpu")) == \
        jt.model_key_for(jlp)
    tree = {"w": np.zeros((4, 3), np.float32),
            "b": {"x": np.zeros((3,), np.float32)}}
    assert tt.model_key_for(tree) == jt.model_key_for(tree)
    assert tt.model_key_for({k: torch.ones(3) for k in "ab"}) == \
        jt.model_key_for({k: np.ones(3, np.float32) for k in "ab"})
    assert tt.model_key_for(MLP(n_units=32, device="cpu")) != \
        tt.model_key_for(MLP(n_units=16, device="cpu"))


# -- the tuner --------------------------------------------------------------------

def test_canned_plans_are_jaxs_field_for_field():
    """One tier of 8: flat at 1 MiB in ``size`` order, overlap 0.96875;
    4 x 2: the synthesized ``cascade-1`` at 0.984375 (JAX's plans, as its
    CHANGES.md records them); every field equal, the untuned default's
    row too."""
    cpu8 = jt.Topology((jt.Tier("ici", 8, 1.0, 100.0),), platform="cpu",
                       device_kind="cpu")
    for j, want in ((cpu8, ("flat", 1 << 20, "size", 0.96875)),
                    (jt.two_tier(4, 2),
                     ("synth", 1 << 20, "size", 0.984375))):
        jr = jt.tune_canned(j, GRAD_BYTES)
        pr = tt.tune_canned(port_topology(j), GRAD_BYTES)
        assert pr.plan.to_dict() == jr.plan.to_dict()
        p = pr.plan
        assert (p.strategy, p.bucket_bytes, p.bucket_order,
                p.overlap_fraction) == want
        assert pr.default == jr.default
        assert pr.improves_overlap and jr.improves_overlap
    assert tt.tune_canned(port_topology(jt.two_tier(4, 2)),
                          GRAD_BYTES).plan.program["name"] == "cascade-1"


@pytest.mark.parametrize("lossy,stale", [(False, False), (True, False),
                                         (False, True)])
@pytest.mark.parametrize("name", ["8", "4x2", "2x2x2"])
def test_candidate_rows_are_jaxs_at_51_mib(name, lossy, stale):
    """Every candidate row (candidate, overlap fraction, modeled and
    exposed microseconds, score) of the 51 MiB search, in order."""
    j = FIXTURES[name]
    kw = dict(lossy=lossy, allow_stale=stale)
    jr = jt.tune_canned(j, GRAD_BYTES, **kw)
    pr = tt.tune_canned(port_topology(j), GRAD_BYTES, **kw)
    assert len(pr.rows) == len(jr.rows)
    for a, b in zip(pr.rows, jr.rows):
        assert a["candidate"] == b["candidate"]
        for k in ("overlap_fraction", "comm_us", "exposed_us",
                  "permute_penalty_us", "n_buckets"):
            assert a[k] == pytest.approx(b[k], rel=1e-12, abs=1e-9), k
        assert a["score"] == pytest.approx(b["score"], rel=1e-12)
    assert pr.plan.to_dict() == jr.plan.to_dict()


def test_canned_hlo_and_scores_are_jaxs():
    """The emulator's text and the two parsers' results are JAX's; a
    measured table replaces the model; a trace's evidence replaces both
    the parser and the model."""
    from chainermn_tpu.analysis.hlo_passes import (
        check_pipeline_permute_overlap as jd203, dp_overlap_fraction as jf)
    from chainermn_torch.tuning import hlo

    for k in (1, 2, 13, 64, 100):
        for order in ("emission", "size"):
            for db in (False, True):
                for staged in (False, True):
                    a = tt.canned_schedule_hlo(k, order, db, staged=staged)
                    assert a == jt.canned_schedule_hlo(k, order, db,
                                                       staged=staged)
                    assert hlo.dp_overlap_fraction(a) == jf(a)
                    assert hlo.check_pipeline_permute_overlap(a) == \
                        jd203(a)
    topo = port_topology(jt.single_tier(8))
    cand = tt.Candidate("flat", GRAD_BYTES)
    assert tt.estimate_comm_us(topo, cand, GRAD_BYTES, measured={
        ("flat", GRAD_BYTES): 123.0}) == 123.0
    row = tt.score_candidate(topo, tt.Candidate("flat", 4 << 20),
                             tt.TraceEvidence(0.25, 400.0), GRAD_BYTES)
    assert (row["overlap_fraction"], row["comm_us"], row["exposed_us"],
            row["n_buckets"]) == (0.25, 400.0, 300.0, 13)
    with pytest.raises(ValueError, match="no candidate"):
        tt.tune(topo, GRAD_BYTES, lambda c: None)


def test_schedtune_json_is_jaxs(tmp_path, monkeypatch):
    """``schedtune`` with the same flags prints JAX's JSON, key for key
    and number for number, once its two-tier topology carries JAX's
    constants; with the port's own defaults the candidates, overlap
    fractions and bucket counts stay JAX's, the fingerprint and prices
    are the port topology's, and the plan is the best of its rows. A
    measured sweep in the DB is read; unknown arguments and ``--aot`` are
    refused (``--aot`` naming ``--trace``); ``--no-write`` writes
    nothing."""
    from chainermn_torch.tools import schedtune

    jtool = _load_tool("schedtune")
    port_defaults = tt.two_tier

    def run(main, flags, name):
        db = str(tmp_path / name / "db.json")
        out, err, code = _run_main(main, flags + ["--db", db], monkeypatch)
        assert code == 0 and "chosen schedule" in err
        return json.loads(out.strip().splitlines()[-1])

    for flags in (["--intra", "8"], ["--intra", "4", "--inter", "2"],
                  ["--intra", "4", "--inter", "2", "--lossy",
                   "--grad-bytes", str(25 << 20)],
                  ["--intra", "2", "--inter", "2", "--allow-stale"]):
        j = run(jtool.main, flags, "jax")
        monkeypatch.setattr(tt, "two_tier", lambda a, b: port_topology(
            jt.two_tier(a, b)))
        same = run(schedtune.main, flags, "same")
        monkeypatch.setattr(tt, "two_tier", port_defaults)
        p = run(schedtune.main, flags, "port")
        assert same.pop("db") == str(tmp_path / "same" / "db.json")
        j.pop("db")
        assert same == j
        assert set(p) == set(j) | {"db"}
        for k in ("ok", "source", "grad_bytes", "n_candidates"):
            assert p[k] == j[k], k
        topo = tt.two_tier(int(flags[1]),
                           int(flags[3]) if "--inter" in flags else 1)
        assert p["topology"] == p["chosen"]["fingerprint"] == \
            topo.fingerprint()
        for a, b in zip(p["candidates"], j["candidates"]):
            assert a["candidate"] == b["candidate"]
            assert a["overlap_fraction"] == b["overlap_fraction"]
            assert a["n_buckets"] == b["n_buckets"]
        best = min(p["candidates"], key=lambda r: r["score"])
        assert best["candidate"]["strategy"] == p["chosen"]["strategy"]
        assert best["candidate"]["bucket_bytes"] == \
            p["chosen"]["bucket_bytes"]
        assert tt.ProfileDB(p["db"]).plan_for(topo).to_dict() == \
            p["chosen"]
    # a measured sweep stored for the topology replaces the model
    db = tt.ProfileDB(str(tmp_path / "m.json"))
    db.put_measured(tt.two_tier(8, 1), {("flat", 1 << 10): 1e9})
    db.save()
    out, _, _ = _run_main(schedtune.main, ["--intra", "8", "--db",
                                           db.path, "--no-write"],
                          monkeypatch)
    assert json.loads(out)["default"]["comm_us"] == 13e9
    assert json.loads(out)["db"] is None
    _, _, code = _run_main(schedtune.main, ["--bogus"], monkeypatch)
    assert "unknown arguments" in str(code)
    with pytest.raises(NotImplementedError, match="--trace"):
        _run_main(schedtune.main, ["--aot=v5e:2x4"], monkeypatch)


def test_schedtune_trace_refuses_a_cpu_world(monkeypatch):
    """``--trace`` measures NCCL on CUDA ranks or refuses; it never falls
    back to the canned source."""
    from chainermn_torch.tools import schedtune

    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    _, _, code = _run_main(schedtune.main, ["--trace"], monkeypatch)
    assert "N >= 2 CUDA ranks" in str(code)


# -- the tuned optimizer and the reports -----------------------------------------

@pytest.fixture(scope="module")
def comm():
    from chainermn_torch.comm import create_communicator

    c = create_communicator("pure_nccl", device="cpu")
    yield c
    c.finalize()


def test_tuned_optimizer_refusals_are_jaxs(comm, tmp_path):
    """A stale fingerprint and a missing entry are refused with JAX's
    texts; an explicit topology must have the communicator's ranks; an
    explicit reducer wins over the plan; the untuned optimizer has no
    plan."""
    from chainermn_torch.models import MLP
    from chainermn_torch.optimizers import create_multi_node_optimizer

    model = MLP(n_units=8, device="cpu")

    def sgd():
        return torch.optim.SGD(model.parameters(), lr=0.1)

    here = tt.Topology.from_comm(comm)
    assert here.fingerprint() == "cpu:cpu/nvlink:1"
    stale = tt.SchedulePlan(fingerprint="gpu:nvidia-h100/nvlink:4",
                            model_key="default", strategy="flat",
                            bucket_bytes=1 << 16)
    with pytest.raises(ValueError,
                       match="stale schedule profile: plan was tuned for "
                             "'gpu:nvidia-h100/nvlink:4' but this mesh is "
                             "'cpu:cpu/nvlink:1'"):
        create_multi_node_optimizer(sgd(), comm, tune=stale)
    empty = str(tmp_path / "empty.json")
    with pytest.raises(ValueError,
                       match=r"no tuned schedule for topology "
                             r"'cpu:cpu/nvlink:1' \(model_key='m'\) in "
                             r"profile DB"):
        create_multi_node_optimizer(sgd(), comm, tune=empty, model_key="m")
    with pytest.raises(ValueError, match="explicit topology has 8 ranks"):
        create_multi_node_optimizer(sgd(), comm, tune=empty,
                                    topology=tt.two_tier(4, 2))
    plan = dataclasses.replace(stale, fingerprint=here.fingerprint(),
                               bucket_order="size", double_buffering=True)
    opt = create_multi_node_optimizer(sgd(), comm, tune=plan)
    assert opt.plan == plan and opt.double_buffering
    assert (opt.grad_reducer.name, opt.grad_reducer.bucket_bytes,
            opt.grad_reducer.bucket_order) == ("flat", 1 << 16, "size")
    opt = create_multi_node_optimizer(sgd(), comm, tune=plan,
                                      grad_reducer="hierarchical")
    assert opt.grad_reducer.name == "hierarchical" and opt.plan == plan
    assert create_multi_node_optimizer(sgd(), comm).plan is None


def test_auto_reducer_profile_and_measured_sweeps(comm, tmp_path):
    """``AutoReducer(profile=)`` seeds ``measured`` from the DB entry of
    its topology (an explicit entry wins per key); ``topology=`` prices
    with the given tiers; ``measure_strategies(db=)`` on the CPU returns
    ``{}`` and persists nothing."""
    from chainermn_torch.collectives import measure_strategies

    path = str(tmp_path / "db.json")
    db = tt.ProfileDB(path)
    db.put_measured(tt.Topology.from_comm(comm), {
        ("flat", 1 << 20): 11.0, ("hierarchical", 1 << 20): 7.0})
    db.save()
    red = AutoReducer(comm, profile=path,
                      measured={("flat", 1 << 20): 5.0})
    assert red.measured == {("flat", 1 << 20): 5.0,
                            ("hierarchical", 1 << 20): 7.0}
    assert red.choose(1 << 20) == "flat"
    assert AutoReducer(comm, profile=tt.ProfileDB(path)).choose(
        1 << 20) == "hierarchical"
    topo = tt.single_tier(1, latency_us=0.0, bw_gbps=1e-3)
    assert AutoReducer(comm, topology=topo).topo_desc is topo
    out = str(tmp_path / "sweep.json")
    assert measure_strategies(comm, db=out) == {}
    assert not os.path.exists(out)


def test_tuning_report_is_jaxs(capsys):
    """The same line, printed once, and the same observations, from a
    plan or an optimizer carrying one; nothing without a plan."""
    got = []
    for mod, report in ((jt, JReport),
                        (tt, __import__(
                            "chainermn_torch.training",
                            fromlist=["TuningReport"]).TuningReport)):
        plan = _plan(mod, wire_format="int8-block", double_buffering=True)
        rep = report(types.SimpleNamespace(plan=plan))
        trainer = types.SimpleNamespace(observation={})
        rep(trainer)
        rep(trainer)
        got.append((capsys.readouterr().out, trainer.observation))
        quiet = types.SimpleNamespace(observation={})
        report(None)(quiet)
        assert quiet.observation == {}
    assert got[0] == got[1]
    assert got[0][0].count("schedtune: hierarchical") == 1
    assert got[0][1] == {"tuning/overlap_frac": 0.96875,
                         "tuning/bucket_bytes": 1 << 20,
                         "tuning/strategy": "hierarchical"}


_WORKER = r'''
import json, os, pickle, sys
import numpy as np
import torch
from chainermn_torch.comm import create_communicator
from chainermn_torch.models import MLP
from chainermn_torch.optimizers import create_multi_node_optimizer
from chainermn_torch.training import classifier_loss
from chainermn_torch.training.step import make_data_parallel_train_step
from chainermn_torch.tuning import ProfileDB, Tier, Topology, tune_canned

out, jax_db = sys.argv[1], sys.argv[2]
comm = create_communicator("pure_nccl", device="cpu")
r = comm.rank
db = os.path.join(out, "port.json")
if r == 0:
    res = tune_canned(Topology.from_comm(comm), 51 << 20, model_key="mnist")
    pdb = ProfileDB(db)
    pdb.put_plan(res.plan)
    pdb.save()
comm.barrier()


def steps(**kw):
    torch.manual_seed(0)
    model = MLP(n_units=64, device="cpu")
    for p in model.parameters():
        # multiples of 2^-16 under 2^7: every sum of two is exact
        p.register_hook(lambda g: torch.round(g * 65536) / 65536)
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), comm, **kw)
    step = make_data_parallel_train_step(model, opt, comm,
                                         loss_fn=classifier_loss)
    rs = np.random.RandomState(10 + r)
    for _ in range(3):
        x = torch.tensor(rs.rand(16, 28, 28).astype(np.float32))
        y = torch.tensor(rs.randint(0, 10, 16))
        step(x, y)
    return opt, [p.detach().clone() for p in model.parameters()]


_, flat = steps(grad_reducer="flat")
tuned, got = steps(tune=db, model_key="mnist")
jtopo = Topology((Tier("ici", 2, 1.0, 100.0),), platform="tpu")
jtuned, jgot = steps(tune=jax_db, topology=jtopo)
res = {"plan": tuned.plan.to_dict(), "reducer": tuned.grad_reducer.name,
       "bitwise": all(torch.equal(a, b) for a, b in zip(got, flat)),
       "jax_plan": jtuned.plan.to_dict(),
       "jax_bitwise": all(torch.equal(a, b) for a, b in zip(jgot, flat)),
       "fingerprint": Topology.from_comm(comm).fingerprint()}
with open(os.path.join(out, f"rank{r}.pkl"), "wb") as f:
    pickle.dump(res, f)
comm.barrier()
comm.finalize()
print(f"RANK{r} OK", flush=True)
'''


def test_tuned_optimizer_steps_equal_flat_and_dbs_cross_packages(
        tmp_path, monkeypatch):
    """2 gloo ranks: rank 0 writes the canned plan for the world's
    fingerprint, and every rank's tuned optimizer takes 3 MNIST steps
    equal to the flat reducer's bit for bit; a DB written by JAX's
    ``tools/schedtune.py`` (``--intra 2``) drives the port's optimizer
    with JAX's plan; the port's DB loads in JAX and builds JAX's
    reducer from the plan."""
    import chainermn_tpu

    jdb = str(tmp_path / "jax.json")
    _, _, code = _run_main(_load_tool("schedtune").main,
                           ["--intra", "2", "--db", jdb], monkeypatch)
    assert code == 0
    assert_ranks_ok(run_world(_WORKER, 2, timeout=240,
                              args=[str(tmp_path), jdb]))
    res = [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())
           for r in range(2)]
    jplan = jt.ProfileDB(jdb).plan_for(jt.two_tier(2, 1))
    for w in res:
        assert w["bitwise"] and w["jax_bitwise"]
        assert w["fingerprint"] == "cpu:cpu/nvlink:2"
        assert w["jax_plan"] == jplan.to_dict()
        assert w["plan"] == res[0]["plan"]
    plan = res[0]["plan"]
    here = tt.Topology((tt.Tier("nvlink", 2, 55.31, 368.22),),
                       platform="cpu", device_kind="cpu")
    assert plan == tt.tune_canned(here, GRAD_BYTES,
                                  model_key="mnist").plan.to_dict()
    assert plan["strategy"] == "flat"
    # the port's DB in JAX: the plan loads, and JAX's optimizer builds
    # its reducer from it against the same fingerprint
    import jax

    from chainermn_tpu.comm.xla import XlaCommunicator

    jcomm = XlaCommunicator(mesh=jax.sharding.Mesh(
        np.asarray(jax.devices()[:2]), ("r",)))
    topo = jt.Topology((jt.Tier("nvlink", 2, 55.31, 368.22),),
                       platform="cpu", device_kind="cpu")
    import optax

    opt = chainermn_tpu.create_multi_node_optimizer(
        optax.sgd(0.1), jcomm, tune=str(tmp_path / "port.json"),
        model_key="mnist", topology=topo)
    assert opt.plan.to_dict() == plan
    assert opt.grad_reducer.bucket_bytes == plan["bucket_bytes"]


def _measured(samples):
    """A compile_fn returning each candidate's canned measurements
    (NCCL µs a step of five repeats, by bucket size; overlap 0.0)."""
    def fn(cand):
        s = samples.get(cand.bucket_bytes)
        if s is None:
            return None
        return tt.TraceEvidence(0.0, float(np.median(s)), tuple(s))
    return fn


def test_trace_ranking_orders_only_outside_the_spread():
    """``--trace``'s ranking: candidates measured several times tie where
    their spreads (interquartile ranges of the samples) overlap the least
    median's spread; the tie goes to the first of them in the canned
    search's ranking (here 1 MiB, 4 MiB, 16 MiB), whatever the noise
    inside the spreads or the stray samples outside them; a gap between
    spreads orders them by median; a candidate that overlaps only a tied
    one does not tie; when every candidate ties the trace decided
    nothing, and the plan is the canned pick with ``source`` canned.
    Every row lists its samples, its spread and its tie set."""
    topo = port_topology(jt.single_tier(4))
    mib = 1 << 20
    cands = [tt.Candidate("flat", b * mib) for b in (1, 4, 16)]

    def run(samples):
        return tt.tune(topo, GRAD_BYTES, _measured(samples),
                       candidates=cands, source="trace")

    noisy = {mib: (90.0, 104.0, 108.0, 112.0, 160.0),
             4 * mib: (60.0, 95.0, 100.0, 105.0, 150.0),
             16 * mib: (300.0, 305.0, 310.0, 315.0, 320.0)}
    res = run(noisy)
    # 4 MiB has the least median and 1 MiB's spread [104, 112] overlaps
    # its [95, 105]; 16 MiB's does not; the canned ranking names 1 MiB
    assert res.plan.bucket_bytes == mib and res.plan.source == "trace"
    assert res.decided and res.tie_set == [0, 1]
    by = {r["candidate"]["bucket_bytes"]: r for r in res.rows}
    assert by[4 * mib]["comm_us"] == 100.0
    assert by[mib]["samples_us"] == list(noisy[mib])
    # the spread in score terms: the quartiles plus the buckets' launches
    assert by[mib]["score_spread"][0] == pytest.approx(104.0, abs=0.1)
    assert by[mib]["score_spread"][1] == pytest.approx(112.0, abs=0.1)
    assert by[4 * mib]["tie_set"] == by[mib]["tie_set"] == [0, 1]
    assert by[16 * mib]["tie_set"] == [2]
    # other noise inside the same spreads, and strays outside: one plan
    shuffled = {k: tuple(reversed(v)) for k, v in noisy.items()}
    shuffled[4 * mib] = (400.0, 95.0, 105.0, 10.0, 100.0)
    assert run(shuffled).plan.bucket_bytes == mib
    # a gap between the spreads orders by median, the canned rank aside
    apart = dict(noisy)
    apart[mib] = (200.0, 210.0, 205.0, 220.0, 215.0)
    res = run(apart)
    assert res.plan.bucket_bytes == 4 * mib and res.tie_set == [1]
    # no chains: 16 MiB leads and ties with 4 MiB, whose spread also
    # overlaps 1 MiB's; 1 MiB does not overlap 16 MiB, so it is no tie
    # and 4 MiB, the first of the tie in the canned ranking, wins
    chain = {mib: (100.0, 115.0, 120.0, 125.0, 150.0),
             4 * mib: (90.0, 103.0, 110.0, 118.0, 130.0),
             16 * mib: (95.0, 100.0, 102.0, 104.0, 110.0)}
    res = run(chain)
    assert res.plan.bucket_bytes == 4 * mib and res.decided
    assert res.tie_set == [1, 2]
    by = {r["candidate"]["bucket_bytes"]: r for r in res.rows}
    assert by[mib]["tie_set"] == [0, 1]
    assert by[4 * mib]["tie_set"] == [0, 1, 2]
    # every candidate ties with the leader: the canned pick, not a trace's
    flat = {mib: (100.0, 105.0, 110.0, 115.0, 120.0),
            4 * mib: (100.0, 104.0, 108.0, 112.0, 120.0),
            16 * mib: (95.0, 100.0, 106.0, 110.0, 130.0)}
    res = run(flat)
    assert res.tie_set == [0, 1, 2] and not res.decided
    assert res.plan.bucket_bytes == mib and res.plan.source == "canned"
    # one measurement a candidate: no spread, the least score wins
    res = run({k: (v[2],) for k, v in noisy.items()})
    assert res.plan.bucket_bytes == 4 * mib and res.tie_set is None
    assert res.decided and res.plan.source == "trace"
