"""The port's Frontend, mirroring the JAX package's
``tests/serving_tests/test_frontend.py``: futures that resolve to the
engine's streams (equal to ``generate``'s greedy tokens), concurrent
submitters, RpcPolicy deadlines, ``AdmissionRejected`` at the
queue-depth bound, drain and close, watchdog-bounded aborts, and an
error the engine raises reaching every pending future instead of being
swallowed by the scheduler thread.

Small model (vocab 43, d 32, 1 layer, ``attention="reference"``); a
torch model, no JAX."""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import functools
import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from chainermn_torch.comm.object_plane import JobAbortedError
from chainermn_torch.models.transformer import TransformerLM, generate
from chainermn_torch.resilience.policy import RpcPolicy
from chainermn_torch.serving.engine import Engine, EngineConfig
from chainermn_torch.serving.frontend import (AdmissionRejected,
                                              DeadlineExceeded, Frontend)


@functools.lru_cache(maxsize=None)
def _model():
    torch.manual_seed(0)
    return TransformerLM(vocab=43, d_model=32, n_heads=4, n_layers=1,
                         d_ff=48, max_len=64, attention="reference",
                         pos_emb="rope", device="cpu")


def _engine(**cfg_kw):
    base = dict(n_slots=2, capacity=16, max_new_tokens=4,
                prefill_cohort=1, buckets=[4, 16])
    base.update(cfg_kw)
    return Engine(_model(), EngineConfig(**base), device="cpu")


_POL = RpcPolicy(timeout_ms=60_000, probe_ms=50)


def _oracle(prompt, n):
    out = generate(_model(), torch.as_tensor(prompt)[None], n)
    return out[0, len(prompt):].tolist()


def test_submit_returns_matching_futures():
    eng = _engine()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 43, (4,)).astype(np.int32) for _ in range(3)]
    with Frontend(eng, rpc_policy=_POL) as fe:
        futs = [fe.submit(p) for p in prompts]
        reqs = [fe.result(f, timeout_ms=60_000) for f in futs]
    for p, req in zip(prompts, reqs):
        assert req.tokens == _oracle(p, 4) and req.state == "done"


def test_concurrent_submitters():
    eng = _engine(max_new_tokens=3)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 43, (4,)).astype(np.int32) for _ in range(6)]
    results = {}
    with Frontend(eng, rpc_policy=_POL) as fe:
        def worker(i):
            results[i] = fe.result(fe.submit(prompts[i]), timeout_ms=60_000)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert sorted(results) == list(range(6))
    for i, p in enumerate(prompts):
        assert results[i].tokens == _oracle(p, 3)


def test_deadline_bounded_wait_raises():
    with Frontend(_engine(), rpc_policy=_POL) as fe:
        with pytest.raises(DeadlineExceeded, match="probe"):
            fe.result(Future(), timeout_ms=120)


def test_bad_request_fails_future_not_thread():
    with Frontend(_engine(), rpc_policy=_POL) as fe:
        bad = fe.submit(np.zeros((0,), np.int32))
        with pytest.raises(ValueError, match="empty"):
            fe.result(bad, timeout_ms=5_000)
        ok = fe.submit(np.ones((4,), np.int32))
        assert fe.result(ok, timeout_ms=60_000).state == "done"


def test_admission_rejected_at_queue_depth_bound():
    pol = RpcPolicy(timeout_ms=60_000, probe_ms=50, backoff_base_ms=40)
    with Frontend(_engine(), rpc_policy=pol, max_queue_depth=0) as fe:
        with pytest.raises(AdmissionRejected) as ei:
            fe.submit(np.ones((4,), np.int32))
        assert ei.value.retry_after_ms == 40


def test_queue_depth_bound_admits_and_drains():
    eng = _engine(max_new_tokens=2)
    with Frontend(eng, rpc_policy=_POL, max_queue_depth=8) as fe:
        futs = [fe.submit(np.ones((4,), np.int32)) for _ in range(4)]
        fe.drain(timeout_ms=60_000)
        assert eng.idle()
        for f in futs:
            assert fe.result(f, timeout_ms=60_000).state == "done"


class _TrippableWatchdog:
    def __init__(self):
        self.tripped = threading.Event()

    def check(self):
        if self.tripped.is_set():
            raise JobAbortedError("peer 3 declared dead")


def test_watchdog_bounded_abort_of_in_flight_requests():
    eng = _engine(max_new_tokens=500, capacity=512, buckets=[4, 512])
    wd = _TrippableWatchdog()
    with Frontend(eng, rpc_policy=_POL, watchdog=wd) as fe:
        fut = fe.submit(np.ones((4,), np.int32))
        deadline = 400
        while not eng.active and deadline:
            deadline -= 1
            threading.Event().wait(0.005)
        assert eng.active, "request never entered a slot"
        wd.tripped.set()
        with pytest.raises(JobAbortedError, match="declared dead"):
            fe.result(fut, timeout_ms=30_000)
    assert eng.report.aborted == 1


def test_close_fails_inflight_futures():
    eng = _engine(max_new_tokens=2000, capacity=4096, buckets=[4, 4096])
    fe = Frontend(eng, rpc_policy=_POL)
    fut = fe.submit(np.ones((4,), np.int32))
    fe.close()
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=10)
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit(np.ones((4,), np.int32))


def test_an_engine_error_reaches_every_future():
    """The scheduler thread does not swallow an engine failure: the
    admitted and the queued futures fail with the engine's own error,
    and the frontend refuses new work."""
    eng = _engine(n_slots=1, max_new_tokens=50, capacity=64,
                  buckets=[4, 64])
    boom = RuntimeError("decode dispatch failed")
    calls = {"n": 0}
    real = eng.steps.decode_k

    def failing(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise boom
        return real(*a, **kw)

    eng.steps.decode_k = failing
    fe = Frontend(eng, rpc_policy=_POL)
    futs = [fe.submit(np.ones((4,), np.int32)) for _ in range(3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="decode dispatch failed"):
            fe.result(f, timeout_ms=30_000)
    assert fe.error is boom
    with pytest.raises(RuntimeError, match="serving engine failed"):
        fe.submit(np.ones((4,), np.int32))
    fe.close()
