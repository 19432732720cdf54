"""The port's trace window and trace readers
(``chainermn_torch.training.profiling``) and ``profile_lm`` on the CPU.

* ``Profile`` opens and closes its window on the same iterations as the
  JAX extension (JAX's ``jax.profiler`` calls recorded on the same
  sequence of iterations), writes one Chrome trace for [start, stop) and
  none before start, and ``close()`` ends a window the run left open.
* The readers: device events of a Chrome trace, kernel families by name
  (the port's kernels, cuBLAS, torch's elementwise kernels, NCCL), the
  busy share and the NCCL overlap fraction, on hand-made events with
  hand-computed answers (the CPU's traces hold no device events).
* ``profile_lm`` at a small width on the CPU: the fused loss runs, the
  roofline counts are the formula's, and no device number is claimed.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import json
import os
import types

import pytest
import torch

from chainermn_torch.training import Profile
from chainermn_torch.training import profiling as tp


@pytest.fixture(scope="module")
def comm():
    from chainermn_torch.comm import create_communicator

    c = create_communicator("pure_nccl", device="cpu")
    yield c
    c.finalize()


def _trainer(comm, iterations):
    from chainermn_torch.datasets.toy import synthetic_mnist
    from chainermn_torch.iterators import SerialIterator
    from chainermn_torch.models import MLP
    from chainermn_torch.optimizers import create_multi_node_optimizer
    from chainermn_torch.training import (StandardUpdater, Trainer,
                                          make_data_parallel_train_step)

    model = MLP(n_units=16, device="cpu")
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), comm)
    it = SerialIterator(synthetic_mnist(256, seed=0), 32, shuffle=False)
    return Trainer(StandardUpdater(
        it, make_data_parallel_train_step(model, opt, comm), comm,
        model=model, optimizer=opt), stop_trigger=(iterations, "iteration"))


def test_profile_windows_follow_jaxs(monkeypatch, tmp_path):
    """On the same iteration counts the port opens and closes its trace
    where the JAX extension calls ``start_trace``/``stop_trace``."""
    import jax

    from chainermn_tpu.training.profiling import Profile as JProfile

    calls = []
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda d: calls.append("start"))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda: calls.append("stop"))

    def at(it):
        return types.SimpleNamespace(updater=types.SimpleNamespace(
            iteration=it))

    for start, stop in ((3, 8), (1, 2), (5, 6), (0, 20)):
        calls.clear()
        jp, port = JProfile("d", start, stop), Profile(
            str(tmp_path / f"{start}-{stop}"), start, stop, device="cpu")
        got = []
        for it in range(1, 10):
            jp(at(it))
            calls.append(it)
            was = port._active
            port(at(it))
            if port._active != was:
                got.append("start" if port._active else "stop")
            got.append(it)
        assert got == calls, (start, stop)
        port.close()
        jp.close()
    with pytest.raises(ValueError, match="stop > start"):
        Profile("d", 3, 3)


def test_profile_writes_one_trace_for_its_window(comm, tmp_path):
    """Iterations 2 to 4 of six: no file before the window closes, one
    Chrome trace after, with the CPU's ops of the steps inside; a window
    still open when the run ends is closed by the Trainer."""
    d = str(tmp_path / "prof")
    trainer = _trainer(comm, 6)
    prof = Profile(d, start=2, stop=4, device="cpu")
    seen = []
    trainer.extend(prof, trigger=(1, "iteration"))
    trainer.extend(lambda t: seen.append(
        (t.updater.iteration, sorted(os.listdir(d)) if os.path.isdir(d)
         else [])), trigger=(1, "iteration"))
    trainer.run()
    assert seen == [(1, []), (2, []), (3, []),
                    (4, ["trace_iter2-4.json"]), (5, ["trace_iter2-4.json"]),
                    (6, ["trace_iter2-4.json"])]
    assert prof.path == os.path.join(d, "trace_iter2-4.json")
    with open(prof.path) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)
    assert tp.kernel_events(prof.path) == []  # no device on the CPU

    d2 = str(tmp_path / "open")
    trainer = _trainer(comm, 5)
    trainer.extend(Profile(d2, start=3, stop=100, device="cpu"),
                   trigger=(1, "iteration"))
    trainer.run()
    assert os.listdir(d2) == ["trace_iter3-5.json"]


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_readers_on_hand_made_events():
    trace = {"traceEvents": [
        _ev("void flash_fwd_mma<64>(Params)", 0, 10),
        _ev("void flash_bwd_mma<64>(Params)", 10, 20),
        _ev("ce_fwd_wgmma(CUtensorMap, CUtensorMap)", 30, 5),
        _ev("void ce_bwd_mma<false, BwdLayout<768> >(...)", 35, 5),
        _ev("void ce_bwd_mma<true, BwdLayout<768> >(...)", 40, 5),
        _ev("nvjet_tst_128x256_64x4_1x2_h_bz_TNT", 45, 10),
        _ev("void at::native::vectorized_elementwise_kernel<4, ...>", 60,
            5),
        _ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)", 50, 20),
        _ev("Memcpy DtoD (Device -> Device)", 90, 10, cat="gpu_memcpy"),
        _ev("some_other_kernel", 100, 10),
        _ev("aten::mm", 0, 500, cat="cpu_op"),
        {"ph": "M", "name": "process_name"},
    ]}
    ev = tp.kernel_events(trace)
    assert len(ev) == 10
    fams = tp.family_ms(ev)
    assert fams == {"flash_fwd": 0.01, "flash_bwd": 0.02, "ce_fwd": 0.005,
                    "ce_dh": 0.005, "ce_dw": 0.005, "GEMM": 0.01,
                    "elementwise": 0.015, "NCCL": 0.02, "other": 0.01}
    # busy: [0, 70) and [90, 110) of the 110 µs span; or of a 200 µs window
    assert tp.busy_share(ev) == pytest.approx(90 / 110)
    assert tp.busy_share(ev, 200.0) == pytest.approx(90 / 200)
    # NCCL [50, 70): GEMM covers [50, 55), elementwise [60, 65)
    assert tp.nccl_overlap(ev) == (pytest.approx(0.5), 20.0)
    assert tp.nccl_overlap(ev[:7]) == (0.0, 0.0)
    assert tp.busy_share([]) == 0.0


def test_capture_records_the_body(comm):
    with tp.capture("cpu") as rec:
        torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.get("name", "") for e in rec["trace"]["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names


def test_profile_lm_runs_small_on_the_cpu(monkeypatch):
    """The fused-loss step at d 64, 2 layers, L 32: finite loss, the
    step's FLOPs and bytes by the formula, no device numbers on the
    CPU, and no hand-written kernel launched (plain versions there)."""
    from chainermn_torch.tools import profile_lm

    monkeypatch.setenv("PROFILE_LOSS", "fused")
    monkeypatch.setenv("PROFILE_BATCH", "2")
    monkeypatch.setenv("PROFILE_QKV_LAYOUT", "bhld")
    args = profile_lm.parse_args(["--device", "cpu", "--d-model", "64",
                                  "--n-layers", "2", "--seq-len", "32",
                                  "--vocab", "128"])
    out = profile_lm.profile(args, warm=1, timed=1)
    cfg = out["config"]
    assert (cfg["d_model"], cfg["batch"], cfg["loss"], cfg["qkv_layout"],
            cfg["ranks"]) == (64, 2, "fused", "bhld", 1)
    assert out["device"] == "cpu" and out["busy_share"] is None
    assert out["device_ms_by_family"] is None
    assert all(v == 0 for v in out["launches"].values())
    assert 0 < out["loss"] < 10
    tokens, d, layers, vocab = 64, 64, 2, 128
    dense = 2 * tokens * (12 * d * d * layers + d * vocab)
    attn = 2 * 2 * 2 * 32 * 32 * d / 2 * layers
    assert out["flops_per_step"] == 3 * dense + 3.5 * attn
    assert out["bytes_per_step"] == 24 * cfg["n_params"] + 16 * tokens
    monkeypatch.setenv("PROFILE_LOSS", "chunked")
    with pytest.raises(SystemExit, match="PROFILE_LOSS"):
        profile_lm.parse_args([])
