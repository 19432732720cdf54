"""The port's fake engine, and the checks that it is the JAX package's.

``FakeEngine`` below is ``tests/fleet_tests/fake_engine.py``'s, typed
against the port (``chainermn_torch.serving``'s ``Request``,
``WeightsVersionSkew`` and ``ServingReport``) and exporting the port's
key row, an int64 ``(seed, counter)`` pair. The tests at the end hold
its streams, its handoff pages and its drills to the JAX fake's
(exact: both are integer arithmetic and seeded numpy).

A deterministic stand-in for ``serving.Engine``.

The router only needs the engine's scheduling face (submit / step /
idle / abort_all + the queue/active/prefilling/free_slots attributes),
so the tier-1 fleet drills run against this fake: one token per
``step()`` per active request, with the emitted stream a pure function
of ``(prompt, seed)`` — which makes the router's replay-on-requeue
contract directly checkable (a re-queued request MUST reproduce the
exact stream the dead replica was emitting, because the real engine's
seeded sampler replays identically).

The disaggregated conveyor additionally needs the handoff face
(``hold`` / ``held`` / ``export_handoff`` / ``import_handoff`` /
``release_held`` / ``abort_held``): a held fake slot exports
deterministic "KV pages" derived from (prompt, seed) — real bytes for
the codec to hash, quantize, corrupt, and verify — and an import
CONTINUES ``expected_tokens`` from the handed-off position, so the
tier-1 transport/conveyor tests can pin bitwise adoption and clean
re-prefill without a device."""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import itertools
import time
import types
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from chainermn_torch.serving.engine import Request, WeightsVersionSkew
from chainermn_torch.serving.reports import ServingReport


def expected_tokens(prompt, seed: int, n: int, vocab: int = 43,
                    salt: int = 0) -> List[int]:
    """The stream a FakeEngine emits for (prompt, seed) — the oracle.
    ``salt`` is the fake's "weights": a different salt is a different
    model version emitting a provably different stream (the rollout
    drill's per-version oracle; default 0 keeps every pre-rollout
    expectation unchanged)."""
    base = (int(np.asarray(prompt, np.int64).sum()) + 7 * seed
            + 1009 * int(salt))
    return [(base + 13 * i) % vocab for i in range(n)]


def fake_params(salt: int) -> dict:
    """The params pytree a FakeEngine's 'weights' are: one int leaf —
    enough for ``serving.weights.encode_weights`` to hash, chunk,
    corrupt, and verify like a real snapshot."""
    return {"salt": np.asarray(int(salt), np.int64)}


def fake_salt(params) -> int:
    """Invert :func:`fake_params` (tolerates the flat decoded dict)."""
    if isinstance(params, dict):
        return int(np.asarray(params["salt"]).reshape(()))
    return int(params)


class FakeEngine:
    """Duck-typed ``serving.Engine`` emitting ``expected_tokens``."""

    def __init__(self, n_slots: int = 2, max_new_tokens: int = 8,
                 step_delay_s: float = 0.0, salt: int = 0,
                 weights_version: Optional[str] = None):
        self.n_slots = n_slots
        self.default_max_new = max_new_tokens
        self.step_delay_s = step_delay_s
        self.salt = int(salt)
        self.weights_version = weights_version
        self.queue: deque = deque()
        self.active: Dict[int, Request] = {}
        self.prefilling: Dict[int, Request] = {}
        self.held: Dict[int, Request] = {}
        self.free_slots: List[int] = list(range(n_slots))
        self.report = ServingReport()
        self.iteration = 0
        self._ids = itertools.count()
        # the one config field the conveyor reads off an engine
        self.config = types.SimpleNamespace(max_new_tokens=max_new_tokens)

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_id=None, temperature=None, top_k=None, seed: int = 0,
               hold: bool = False) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        req = Request(request_id=next(self._ids), prompt=prompt,
                      max_new_tokens=(max_new_tokens
                                      if max_new_tokens is not None
                                      else self.default_max_new),
                      eos_id=eos_id, temperature=temperature,
                      top_k=top_k, seed=seed, hold=hold)
        self.queue.append(req)
        self.report.record_submit(req.request_id)
        return req

    def step(self) -> dict:
        if self.step_delay_s:
            time.sleep(self.step_delay_s)
        self.iteration += 1
        admitted = 0
        while self.queue and self.free_slots:
            req = self.queue.popleft()
            req.slot = self.free_slots.pop(0)
            req.state = "running"
            self.active[req.slot] = req
            admitted += 1
        emitted = 0
        for slot, req in list(self.active.items()):
            stream = expected_tokens(req.prompt, req.seed,
                                     req.max_new_tokens, salt=self.salt)
            tok = stream[len(req.tokens)]
            req.tokens.append(tok)
            self.report.record_token(req.request_id)
            self.report.record_host_bytes(4)
            emitted += 1
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if hit_eos or len(req.tokens) >= req.max_new_tokens:
                if getattr(req, "hold", False):
                    # park instead of retiring: the slot stays bound
                    # until export_handoff + release_held (the prefill
                    # side of the disaggregated conveyor)
                    req.state = "held"
                    self.held[slot] = req
                    del self.active[slot]
                else:
                    req.state = "done"
                    self.free_slots.append(slot)
                    del self.active[slot]
                    req.slot = None
                    self.report.record_retire(req.request_id)
        self.report.record_step(len(self.queue),
                                len(self.active) / self.n_slots)
        return {"admitted": admitted, "emitted": emitted,
                "active": len(self.active), "queued": len(self.queue)}

    def idle(self) -> bool:
        return not self.queue and not self.active and not self.prefilling

    # ----------------------------------------------------------------
    # handoff face (fleet/pools.py conveyor)
    # ----------------------------------------------------------------

    def _check_held(self, req: Request) -> None:
        if req.state != "held" or self.held.get(req.slot) is not req:
            raise ValueError(
                f"request {req.request_id} is not held by this engine")

    def export_handoff(self, req: Request) -> dict:
        """Deterministic handoff dict shaped like the real engine's:
        fake KV pages derived from (prompt, seed) — stable bytes, so a
        corrupted/truncated wire frame fails the codec's digest exactly
        as a real cache row would. Pure read: the slot stays held."""
        self._check_held(req)
        fill = int(req.prompt.size + len(req.tokens) - 1)
        rng = np.random.RandomState(
            (int(req.prompt.sum()) + 101 * req.seed) % (2**31))
        pages = {"block0": {
            "k": rng.rand(max(1, fill), 1, 4).astype(np.float32),
            "v": rng.rand(max(1, fill), 1, 4).astype(np.float32)}}
        return {
            "pages": pages,
            "cursor": fill,
            "tokens": list(req.tokens),
            "key": np.asarray([req.seed, len(req.tokens)], np.int64),
            "prompt_len": int(req.prompt.size),
            "eos_id": req.eos_id,
            "temperature": req.temperature,
            "top_k": req.top_k,
            "seed": req.seed,
            "weights_version": self.weights_version,
        }

    def import_handoff(self, handoff: dict, prompt,
                       max_new_tokens: Optional[int] = None) -> Request:
        """Adopt a handed-off stream: the continuation is
        ``expected_tokens`` from the handed-off position — bitwise the
        exporting fake continuing, mirroring the real raw-format
        contract."""
        if not self.free_slots:
            raise RuntimeError("no free slot to import a handoff into")
        hv = handoff.get("weights_version")
        if (hv is not None and self.weights_version is not None
                and hv != self.weights_version):
            raise WeightsVersionSkew(
                f"handoff was minted under weights {hv!r} but this "
                f"engine serves {self.weights_version!r}")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size != int(handoff["prompt_len"]):
            raise ValueError(
                f"handoff prompt_len {handoff['prompt_len']} does not "
                f"match the supplied prompt ({prompt.size})")
        if not handoff["tokens"]:
            raise ValueError("handoff carries no sampled token")
        req = Request(request_id=next(self._ids), prompt=prompt,
                      max_new_tokens=(max_new_tokens
                                      if max_new_tokens is not None
                                      else self.default_max_new),
                      eos_id=handoff["eos_id"],
                      temperature=handoff["temperature"],
                      top_k=handoff["top_k"], seed=handoff["seed"],
                      tokens=list(handoff["tokens"]), state="running")
        self.report.record_submit(req.request_id)
        req.slot = self.free_slots.pop(0)
        if len(req.tokens) >= req.max_new_tokens or (
                req.eos_id is not None and req.tokens[-1] == req.eos_id):
            req.state = "done"
            self.free_slots.append(req.slot)
            req.slot = None
            self.report.record_retire(req.request_id)
        else:
            self.active[req.slot] = req
        return req

    # ----------------------------------------------------------------
    # migration face (fleet/router.py drain) — mirrors the real
    # engine's export_session/import_session/resume_session contract
    # ----------------------------------------------------------------

    def export_session(self, req: Request) -> dict:
        """Freeze an active decode slot (active → held) and export it
        with the remaining budget; the adopting fake continues
        ``expected_tokens`` from the same position — bitwise."""
        if req.state == "held" and self.held.get(req.slot) is req:
            raise ValueError(
                f"request {req.request_id} is a held prefill-handoff "
                "slot — migrate it with export_handoff")
        if req.slot is None or self.active.get(req.slot) is not req:
            raise ValueError(
                f"request {req.request_id} is not actively decoding on "
                f"this engine (state={req.state!r})")
        del self.active[req.slot]
        req.state = "held"
        self.held[req.slot] = req
        out = self.export_handoff(req)
        out["max_new_tokens"] = int(req.max_new_tokens)
        return out

    def resume_session(self, req: Request) -> None:
        self._check_held(req)
        del self.held[req.slot]
        req.state = "running"
        self.active[req.slot] = req

    def import_session(self, session: dict, prompt) -> Request:
        if "max_new_tokens" not in session:
            raise ValueError(
                "not a decode-session export (no max_new_tokens)")
        return self.import_handoff(
            session, prompt,
            max_new_tokens=int(session["max_new_tokens"]))

    def release_held(self, req: Request, aborted: bool = False) -> None:
        self._check_held(req)
        slot = req.slot
        req.state = "aborted" if aborted else "done"
        self.free_slots.append(slot)
        del self.held[slot]
        req.slot = None
        self.report.record_retire(req.request_id, aborted=aborted)

    def abort_held(self, req: Request) -> None:
        """Transport could not deliver this slot's handoff: free it as
        an abort (the receiver's clean re-prefill owns the stream)."""
        self.release_held(req, aborted=True)

    def swap_weights(self, params, weights_version: Optional[str] = None,
                     *, converted: bool = False):
        """The real engine's swap face: quiescence-gated salt change.
        ``params`` is :func:`fake_params`'s pytree (or the flat dict
        ``decode_weights`` returns). Returns ``(old_params,
        old_version)`` for the rollback walk, like the real engine."""
        del converted     # the fake has no layout to convert
        if self.queue or self.active or self.prefilling or self.held:
            raise RuntimeError(
                "swap_weights requires a drained engine — "
                f"{len(self.queue)} queued, {len(self.active)} active, "
                f"{len(self.prefilling)} prefilling, "
                f"{len(self.held)} held")
        old_params = fake_params(self.salt)
        old_version = self.weights_version
        self.salt = fake_salt(params)
        self.weights_version = weights_version
        return old_params, old_version

    def run_until_drained(self, max_steps: int = 100_000) -> None:
        """Step until idle (the canary's off-traffic replay loop)."""
        steps = 0
        while not self.idle():
            self.step()  # dlint: disable=DL104
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(f"not drained in {max_steps} steps")

    def abort_all(self, requeue: bool = False) -> List[Request]:
        hit = []
        for req in list(self.active.values()):
            if requeue:
                req.state = "queued"
                req.tokens = []
                self.free_slots.append(req.slot)
                del self.active[req.slot]
                req.slot = None
                self.queue.appendleft(req)
            else:
                req.state = "aborted"
                self.free_slots.append(req.slot)
                del self.active[req.slot]
                req.slot = None
                self.report.record_retire(req.request_id, aborted=True)
            hit.append(req)
        if not requeue:
            while self.queue:
                req = self.queue.popleft()
                req.state = "aborted"
                self.report.record_retire(req.request_id, aborted=True)
                hit.append(req)
        return hit


# ---------------------------------------------------------------------------
# the fake is the JAX package's fake
# ---------------------------------------------------------------------------

import sys  # noqa: E402

import pytest  # noqa: E402

from tests.fleet_tests import fake_engine as jax_fake  # noqa: E402


@pytest.mark.parametrize("seed,salt", [(0, 0), (5, 0), (3, 2), (11, 7)])
def test_expected_tokens_are_the_jax_fakes(seed, salt):
    rng = np.random.RandomState(seed)
    for n in (1, 4, 9):
        prompt = rng.randint(0, 43, rng.randint(1, 9))
        assert (expected_tokens(prompt, seed, n, salt=salt)
                == jax_fake.expected_tokens(prompt, seed, n, salt=salt))
    assert fake_salt(fake_params(salt)) == jax_fake.fake_salt(
        jax_fake.fake_params(salt)) == salt


def _held(fake_mod, prompt, seed, max_new=1):
    eng = fake_mod.FakeEngine(n_slots=1, max_new_tokens=4)
    req = eng.submit(prompt, max_new_tokens=max_new, seed=seed, hold=True)
    while not eng.held:
        eng.step()  # dlint: disable=DL104 — a fake engine: nothing to sync
    return eng, req


def test_the_handoff_face_is_the_jax_fakes_but_for_the_key_row():
    """Same pages, cursor, tokens and knobs; the key row is the port's
    int64 pair where the JAX fake's is uint32."""
    for prompt, seed in (([3, 1, 4], 9), ([7] * 6, 2)):
        ours = _held(sys.modules[__name__], prompt, seed)
        theirs = _held(jax_fake, prompt, seed)
        a = ours[0].export_handoff(ours[1])
        b = theirs[0].export_handoff(theirs[1])
        assert a.keys() == b.keys()
        for k in a:
            if k == "pages":
                for leaf in ("k", "v"):
                    np.testing.assert_array_equal(
                        a["pages"]["block0"][leaf],
                        b["pages"]["block0"][leaf])
            elif k == "key":
                assert a["key"].dtype == np.int64
                assert b["key"].dtype == np.uint32
                assert a["key"].tolist() == b["key"].tolist()
            else:
                assert a[k] == b[k], k


def test_a_drained_fake_emits_the_jax_fakes_streams():
    ours, theirs = FakeEngine(n_slots=2), jax_fake.FakeEngine(n_slots=2)
    got, want = [], []
    for i in range(5):
        p = [i + 1, 2 * i, 7]
        got.append(ours.submit(p, max_new_tokens=3 + i, seed=i))
        want.append(theirs.submit(p, max_new_tokens=3 + i, seed=i))
    ours.run_until_drained()
    theirs.run_until_drained()
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert ours.report.summary()["tokens_emitted"] == sum(
        len(r.tokens) for r in want)
