"""The port's dlint rules in the port's idiom, and its trace passes.

Each name the port adds to a rule gets a fixture that trips it and a
clean twin (``new_group`` under a rank branch, ``dist.all_reduce`` on
``p.grad``, ``.cpu()``/``.item()`` on decode results, a ``try_recv_obj``
receive, ...). The rules with no port form are absent from the registry
and listed with their reason. DL201 and DL202 run on synthetic Chrome
traces in the shape ``training/profiling.py``'s readers take: an
overlapped step, a serialized one, one with no NCCL kernel, a count over
its budget.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import json
import os
import subprocess
import sys
import textwrap

import pytest

from chainermn_torch.analysis import (NOT_APPLICABLE, NOT_YET_PORTED, RULES,
                                      check_collective_budget,
                                      check_dp_overlap,
                                      dp_overlap_fraction, lint_source,
                                      nccl_kind)
from chainermn_torch.training.profiling import (backward_events,
                                                profiler_steps)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lint(src, path="fixture.py"):
    return lint_source(textwrap.dedent(src), path)


def _lines(src, rule, path="fixture.py"):
    return [f.line for f in _lint(src, path) if f.rule == rule]


# ---------------------------------------------------------------------------
# each added name: a fixture that trips the rule and its clean twin
# ---------------------------------------------------------------------------

#: (rule, failing fixture, the lines it flags, clean twin)
CASES = {
    "new_group-under-rank-branch": ("DL101", """\
        import torch.distributed as dist

        def build(comm):
            if dist.get_rank() == 0:
                g = dist.new_group([0, 1])
            return comm
        """, [5], """\
        import torch.distributed as dist

        def build(comm):
            g = dist.new_group([0, 1])
            if dist.get_rank() == 0:
                print("leader")
            return g
        """),
    "rank-from-the-environment": ("DL101", """\
        import os

        def sync(comm, x):
            if int(os.environ["RANK"]) == 0:
                x = comm.reduce_flat(x, "sum")
            return x
        """, [5], """\
        import os

        def sync(comm, x):
            x = comm.reduce_flat(x, "sum")
            if int(os.environ.get("LOCAL_RANK", 0)) == 0:
                print(x)
            return x
        """),
    "recv_tree-pairs-eager_send": ("DL101", """\
        def stage(comm, y):
            if comm.rank == 0:
                y = y * 2
            else:
                y = recv_tree(comm, 0, y, tag=5)
            return y
        """, [5], """\
        def stage(comm, y, anchor):
            if comm.rank == 0:
                eager_send(y, comm, 1, tag=5)
            else:
                y = recv_tree(comm, 0, anchor, tag=5)
            return y
        """),
    "all_reduce-on-p.grad": ("DL106", """\
        import torch.distributed as dist

        def train_step(model, opt, x):
            loss = model(x).sum()
            loss.backward()
            for p in model.parameters():
                dist.all_reduce(p.grad)
            opt.step()
        """, [7], """\
        def train_step(model, opt, comm, x):
            loss = model(x).sum()
            loss.backward()
            comm.allreduce_grad(model)
            opt.step()
        """),
    "reduce_scatter_tensor-on-autograd-grads": ("DL106", """\
        import torch
        import torch.distributed as dist

        def zero_step(params, loss, out):
            grads = torch.autograd.grad(loss, params)
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.reduce_scatter_tensor(out, flat)
        """, [7], """\
        import torch
        import torch.distributed as dist

        def zero_step(params, loss, out, flat, metric):
            grads = torch.autograd.grad(loss, params)
            dist.all_reduce(metric)
            return grads
        """),
    "cpu-of-decode-logits-in-a-token-loop": ("DL110", """\
        def generate(steps, cur, n):
            out = []
            for _ in range(n):
                logits = steps.decode(cur)
                out.append(logits.cpu())
            return out
        """, [5], """\
        def generate(steps, cur, n):
            out = []
            for _ in range(n):
                logits = steps.decode(cur)
                out.append(logits.argmax(-1).cpu())
            return out
        """),
    "item-in-a-decode-loop": ("DL121", """\
        def decode_k(tokens, logits, n):
            done = 0
            for i in range(n):
                done += logits[i].item()
            return done
        """, [4], """\
        def decode_k(tokens, logits, n):
            return (logits[:n].argmax(-1) == tokens).sum()
        """),
    "try_recv_obj-receives-a-send": ("DL114", """\
        def ping(plane):
            plane.send_obj({"n": 1}, 1, tag=32)
        """, [2], """\
        def ping(plane):
            plane.send_obj({"n": 1}, 1, tag=31)

        def pong(plane):
            return plane.try_recv_obj(0, tag=31, timeout_ms=100)
        """),
    "a-bounded-probe-never-waits-forever": ("DL114", """\
        def pong(plane):
            return plane.recv_obj(0, tag=33)
        """, [2], """\
        def pong(plane):
            try:
                return plane.try_recv_obj(0, tag=33, timeout_ms=10)
            except TimeoutError:
                return None
        """),
    "exchange-cycle": ("DL114", """\
        def a(comm):
            got = comm.recv(src=1, tag=43)
            comm.exchange(sends=[(1, 44, got)])

        def b(comm):
            got = comm.exchange(recvs=[(0, 44)])[0]
            comm.send(got, dest=0, tag=43)
        """, [2], """\
        def swap(comm, x):
            return comm.exchange(sends=[(1, 41, x)], recvs=[(1, 41)])
        """),
    "world-rank-as-a-root": ("DL103", """\
        import torch.distributed as dist

        def share(sub, x):
            return sub.bcast_obj(x, root=dist.get_rank())
        """, [4], """\
        def share(sub, x):
            return sub.bcast_obj(x, root=sub.rank)
        """),
    "env-rank-as-a-root": ("DL103", """\
        import os

        def share(sub, x):
            return sub.bcast_data(x, root=int(os.environ["RANK"]))
        """, [4], """\
        def share(sub, x):
            return sub.bcast_data(x, root=0)
        """),
    "step-loop-synced-by-cuda": ("DL104", """\
        def run(step, x, y, n):
            for _ in range(n):
                step(x, y)
        """, [3], """\
        import torch

        def run(step, x, y, n):
            for _ in range(n):
                step(x, y)
                torch.cuda.synchronize()
        """),
    "over_mesh-axis-outside-the-tiers": ("DL112", """\
        def plan(comm, mesh):
            tiers = [Tier("nvlink", 4, 1.0, 450.0), Tier("net", 2, 5.0, 25.0)]
            return comm.over_mesh(mesh, axes=("tp",))
        """, [3], """\
        def plan(comm, mesh):
            tiers = [Tier("nvlink", 4, 1.0, 450.0), Tier("net", 2, 5.0, 25.0)]
            return comm.over_mesh(mesh, axes=("nvlink",))
        """),
    "fold_in-twice-on-one-key-and-datum": ("DL118", """\
        from chainermn_torch.ops.dropout import fold_in

        def keys(key):
            a = fold_in(key, 0)
            b = fold_in(key, 0)
            return a, b
        """, [5], """\
        from chainermn_torch.ops.dropout import fold_in

        def keys(key):
            a = fold_in(key, 0)
            b = fold_in(key, 1)
            return a, b
        """),
    "discarded-fold_in": ("DL118", """\
        from chainermn_torch.ops.dropout import fold_in

        def advance(key, step):
            fold_in(key, step)
            return key
        """, [4], """\
        from chainermn_torch.ops.dropout import fold_in

        def advance(key, step):
            return fold_in(key, step)
        """),
    "new_group-ranks-from-a-set": ("DL120", """\
        import torch.distributed as dist

        def group(ranks):
            members = set(ranks)
            return dist.new_group(list(members))
        """, [5], """\
        import torch.distributed as dist

        def group(ranks):
            members = set(ranks)
            return dist.new_group(sorted(members))
        """),
    "sync-save-beside-a-port-step": ("DL109", """\
        def train(model, opt, comm, data):
            step = make_data_parallel_train_step(model, opt, comm)
            ckpt = create_multi_node_checkpointer("run", comm)
            for x, y in data:
                float(step(x, y)["main/loss"])
                ckpt.save(model)
        """, [6], """\
        def train(model, opt, comm, data):
            step = make_data_parallel_train_step(model, opt, comm)
            plane = AsyncSnapshotPlane(
                create_multi_node_checkpointer("run", comm))
            for x, y in data:
                float(step(x, y)["main/loss"])
                plane.save(model)
        """),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_idiom_fixture_trips_and_its_twin_stays_quiet(case):
    rule, bad, lines, good = CASES[case]
    assert _lines(bad, rule) == lines
    assert _lines(good, rule) == []


def test_the_reducers_own_collectives_are_not_hand_rolled():
    rule, bad, lines, _ = CASES["all_reduce-on-p.grad"]
    assert _lines(bad, rule, "chainermn_torch/collectives/flat.py") == []
    assert _lines(bad, rule, "chainermn_torch/optimizers/x.py") == lines


# ---------------------------------------------------------------------------
# the rules with no port form
# ---------------------------------------------------------------------------

#: JAX's fixtures of the rules the port does not register: the port is
#: silent on each
_JAX_ONLY = {
    "DL108": """\
        import jax

        def serve(step, toks, n):
            for t in range(n):
                f = jax.jit(step)
                f(toks)
        """,
    "DL119": """\
        import jax

        step = jax.jit(lambda x: x + 1, donate_argnums=(0,))

        def run(x):
            y = step(x)
            return x + y
        """,
    "DL122": """\
        import jax

        @jax.jit
        def f(x):
            if x > 0:
                return x
            return -x
        """,
}


@pytest.mark.parametrize("rule", sorted(_JAX_ONLY))
def test_a_rule_with_no_port_form_is_listed_with_its_reason(rule):
    import chainermn_tpu.analysis as jax_lint

    assert rule not in RULES
    name, reason = NOT_APPLICABLE[rule]
    assert name == jax_lint.RULES[rule].name and len(reason) > 20
    src = textwrap.dedent(_JAX_ONLY[rule])
    assert [f.rule for f in jax_lint.lint_source(src)
            if f.rule == rule] == [rule]
    assert [f for f in lint_source(src) if f.rule == rule] == []


def test_list_rules_shows_every_jax_rule():
    import chainermn_tpu.analysis as jax_lint

    out = subprocess.run(
        [sys.executable, "-m", "chainermn_torch.tools.dlint",
         "--list-rules"],
        capture_output=True, text=True, timeout=120, cwd=_REPO)
    assert out.returncode == 0, out.stderr
    rows = {ln.split()[0]: ln for ln in out.stdout.splitlines()}
    assert set(rows) == set(jax_lint.RULES)
    for rule in NOT_APPLICABLE:
        assert "not applicable:" in rows[rule]
    for rule in NOT_YET_PORTED:
        assert "[trace, to port]" in rows[rule]
    assert "[trace]" in rows["DL201"] and "[trace]" in rows["DL202"]
    assert all("docs/static_analysis_torch.md#" in RULES[r].doc
               for r in RULES)


# ---------------------------------------------------------------------------
# DL201 and DL202 on synthetic traces
# ---------------------------------------------------------------------------

_AR = "ncclDevKernel_AllReduce_Sum_f32_RING_LL"


def _trace(kernels, steps=0):
    """A Chrome trace in ``torch.profiler``'s shape: ``kernels`` are
    ``(name, start_us, duration_us, backward)``; each gets its runtime
    launch (the same ``correlation``) on the main thread, or, for a
    backward one, on the autograd thread inside an
    ``autograd::engine::evaluate_function`` span."""
    events = [{"ph": "X", "cat": "user_annotation",
               "name": f"ProfilerStep#{i}", "pid": 1, "tid": 1,
               "ts": 1000.0 * i, "dur": 900.0} for i in range(steps)]
    for corr, (name, ts, dur, bwd) in enumerate(kernels, 1):
        tid = 2 if bwd else 1
        launch = ts - 5.0
        if bwd:
            events.append({"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 2,
                           "name": "autograd::engine::evaluate_function: "
                                   "MmBackward0",
                           "ts": launch - 1.0, "dur": 3.0})
        events.append({"ph": "X", "cat": "cuda_runtime", "pid": 1,
                       "tid": tid, "name": "cudaLaunchKernel", "ts": launch,
                       "dur": 2.0, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
                       "name": name, "ts": float(ts), "dur": float(dur),
                       "args": {"correlation": corr}})
    return {"traceEvents": events}


def _step_kernels(reduce_at):
    """Three backward GEMMs over [0, 300) µs and one all-reduce of 100 µs
    at ``reduce_at``."""
    return [("sm90_xmma_gemm_bf16", 0, 100, True),
            ("sm90_xmma_gemm_bf16", 100, 100, True),
            ("sm90_xmma_gemm_bf16", 200, 100, True),
            (_AR, reduce_at, 100, False)]


def test_backward_events_are_the_kernels_backward_functions_launched():
    trace = _trace(_step_kernels(300)
                   + [("elementwise_kernel", 400, 10, False)])
    assert [s for _, s, _ in backward_events(trace)] == [0.0, 100.0, 200.0]
    assert profiler_steps(_trace([], steps=3)) == 3


def test_dl201_passes_a_step_whose_all_reduce_overlaps_backward():
    out = check_dp_overlap(_trace(_step_kernels(150)))
    assert out["ok"] is True
    assert out["n_allreduce"] == 1 and out["n_backward"] == 3
    # the third backward GEMM starts at 200 µs, inside [150, 250)
    assert out["backward_kernels_during_reduction"] == 1
    assert out["overlap_fraction"] == 1.0
    assert dp_overlap_fraction(_trace(_step_kernels(150))) == 1.0


def test_dl201_fails_a_serialized_step():
    out = check_dp_overlap(_trace(_step_kernels(300)))
    assert out["ok"] is False and out["overlap_fraction"] == 0.0
    assert out["backward_kernels_during_reduction"] == 0
    assert "#dl201" in out["fix"]


def test_dl201_reads_serialized_steps_of_one_trace_as_serialized():
    # step 1's all-reduce precedes step 2's backward, but no backward
    # kernel runs while a reduction is in flight
    kernels = [(k, 1000 * i + s, d, b) for i in range(3)
               for k, s, d, b in _step_kernels(300)]
    out = check_dp_overlap(_trace(kernels, steps=3))
    assert out["ok"] is False and out["n_allreduce"] == 3
    assert out["n_backward"] == 9


def test_dl201_skips_a_step_with_no_nccl_kernel():
    out = check_dp_overlap(_trace(_step_kernels(300)[:3]))
    assert out["ok"] is None and "one rank" in out["skip"]


def test_a_trace_with_no_device_event_fails_both_passes():
    for out in (check_dp_overlap({"traceEvents": []}),
                check_collective_budget({"traceEvents": []}, 4)):
        assert out["ok"] is False and out["n_device_events"] == 0


def test_dl202_counts_nccl_kernels_per_step():
    kernels = []
    for i in range(2):
        kernels += [(k, 1000 * i + s, d, b)
                    for k, s, d, b in _step_kernels(150)]
        kernels.append(("ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL",
                        1000 * i + 500, 50, False))
    trace = _trace(kernels, steps=2)
    out = check_collective_budget(trace, 2)
    assert out["ok"] is True and out["steps"] == 2
    assert out["per_step"] == 2.0
    assert out["by_kind"] == {"AllReduce": 2, "ReduceScatter": 2}
    over = check_collective_budget(trace, 1)
    assert over["ok"] is False and "#dl202" in over["fix"]
    # the caller's count overrides the trace's step spans
    assert check_collective_budget(trace, 2, steps=1)["ok"] is False
    no_nccl = _trace(_step_kernels(150)[:3])
    assert check_collective_budget(no_nccl, 0)["ok"] is True


def test_nccl_kernel_names_of_both_forms():
    assert nccl_kind(_AR) == "AllReduce"
    assert nccl_kind("ncclKernel_AllGather_RING_LL_Sum_int8_t") \
        == "AllGather"
    assert nccl_kind("ampere_sgemm") == "other"


@pytest.mark.parametrize("reduce_at,ok,rc", [(150, True, 0),
                                              (300, False, 1)])
def test_cli_trace_runs_dl201_and_counts_a_failure(tmp_path, reduce_at,
                                                   ok, rc):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_trace(_step_kernels(reduce_at), steps=1)))
    out = subprocess.run(
        [sys.executable, "-m", "chainermn_torch.tools.dlint", "--trace",
         str(path)],
        capture_output=True, text=True, timeout=120, cwd=_REPO)
    rows = [json.loads(ln) for ln in out.stdout.splitlines()]
    # DL203-DL205 run too and find nothing of theirs in a DP trace
    assert [(r["rule"], r["ok"]) for r in rows] == [
        ("DL201", ok), ("DL203", None), ("DL204", None), ("DL205", None)]
    assert out.returncode == rc
