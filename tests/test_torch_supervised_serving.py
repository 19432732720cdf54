"""The port's serving replica under the port's supervisor, mirroring the
JAX package's ``tests/serving_tests/test_supervised_serving.py``:
``chainermn_torch/tools/serve_lm.py`` is chaos-killed mid-decode, the
supervisor restarts it, the new incarnation warm-loads the weights the
first published and drains the rest of the queue, and the merged output
equals, token for token, what an unkilled serial ``generate`` gives on
those weights. A second supervised run over the finished file adds
nothing (the output is idempotent). On the CPU, a few seconds a run."""

import json
import os
import signal
import sys

import numpy as np
import torch

from chainermn_torch.models.transformer import TransformerLM, generate
from chainermn_torch.resilience.supervisor import Supervisor
from chainermn_torch.serving.weights import load_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_REQ = 6
MAX_NEW = 8
PROMPT_LEN = 4


def _serve_cmd(out, weights):
    return [sys.executable, "-m", "chainermn_torch.tools.serve_lm",
            "--device", "cpu", "--out", out, "--weights", weights,
            "--requests", str(N_REQ), "--prompt-len", str(PROMPT_LEN),
            "--max-new-tokens", str(MAX_NEW), "--slots", "2",
            "--capacity", "32", "--seed", "0"]


def _rows(out):
    with open(out) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_replica_survives_chaos_kill_mid_decode(tmp_path):
    out = str(tmp_path / "streams.jsonl")
    weights = str(tmp_path / "weights.npz")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    # SIGKILL at scheduler iteration 9, first incarnation only: by then
    # some requests have drained and others are mid-decode in their slots
    env["CHAINERMN_TPU_CHAOS"] = "kill@step=9,run=0"
    env.pop("CHAINERMN_TPU_RESTART_COUNT", None)
    sup = Supervisor(_serve_cmd(out, weights), max_restarts=2,
                     window_s=600, env=env, sleep=lambda _s: None)
    assert sup.run() == 0
    assert [r.kind for r in sup.history] == ["crash", "clean"]
    assert sup.history[0].returncode == -signal.SIGKILL
    assert os.path.exists(weights) and os.path.exists(weights + ".json")
    rows = {r["request_id"]: r for r in _rows(out)}
    assert sorted(rows) == list(range(N_REQ)), "queue did not drain"
    assert len(_rows(out)) == N_REQ        # nothing written twice

    torch.manual_seed(0)
    model = TransformerLM(vocab=43, d_model=32, n_heads=4, n_layers=2,
                          d_ff=64, max_len=32, attention="reference",
                          pos_emb="rope", device="cpu")
    params, _src = load_weights(weights, like=model.state_dict())
    model.load_state_dict(params)
    rng = np.random.RandomState(0)
    for i in range(N_REQ):
        prompt = rng.randint(0, 43, (PROMPT_LEN,)).astype(np.int32)
        assert rows[i]["prompt"] == prompt.tolist()
        ref = generate(model, torch.as_tensor(prompt)[None], MAX_NEW)
        assert rows[i]["tokens"] == ref[0, PROMPT_LEN:].tolist(), (
            f"request {i} diverged after the restart")

    # idempotent: a clean rerun finds every id on disk and adds nothing
    env.pop("CHAINERMN_TPU_CHAOS")
    again = Supervisor(_serve_cmd(out, weights), max_restarts=0,
                       window_s=600, env=env, sleep=lambda _s: None)
    assert again.run() == 0
    assert len(_rows(out)) == N_REQ
