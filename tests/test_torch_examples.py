"""The port's CIFAR example (config #3) on the CPU: ``train_cifar`` in a
2-rank gloo world against one rank fed both ranks' batches
(cross-replica batch norm against batch norm over the concatenated
batch).

Tolerances: the 2-rank run against the 1-rank run: losses at 1e-4
(rtol and atol; one framework, the statistics and gradient sums
all-reduced instead of summed in one pass; the first step's gradients
agree to 7e-6 relative), the final state within 1e-4 relative L2 over all
of it and 1e-3 per element (over SGD steps a few activations at a ReLU's
kink fall on the other side in one of the runs, and each such flip moves
a batch-norm bias by lr·|dy|, ~5e-5; after 8 steps of 256 samples the
worst element measured 3e-4 apart, the whole state 2.2e-5).

The other examples' tests are in ``test_torch_examples_*.py``, one file
an example, so that ``pytest -n --dist loadfile`` spreads them over its
workers.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import os
import pickle

import numpy as np
import torch

from chainermn_torch.datasets import SubDataset, load_cifar, split_indices
from chainermn_torch.iterators import SerialIterator
from chainermn_torch.models.resnet import CifarResNet
from chainermn_torch.training import classifier_loss
from tests.test_torch_mp import assert_ranks_ok, run_world


_CIFAR_WORKER = r'''
import os, pickle, sys
from chainermn_torch.examples import train_cifar
from chainermn_torch.training import LogReport

out = sys.argv[1]
args = train_cifar.parse_args(
    ["--device", "cpu", "--communicator", "naive", "--epoch", "1",
     "--depth", "8", "--n-train", "128", "--batchsize", "16", "--out", out])
trainer, model = train_cifar.build_trainer(args)
comm = trainer.updater.comm
log = LogReport()
trainer.extend(log, trigger=(1, "iteration"))
trainer.run()
with open(os.path.join(out, f"rank{comm.rank}.pkl"), "wb") as f:
    pickle.dump({"losses": [e["main/loss"] for e in log.log],
                 "state": model.state_dict()}, f)
print(f"RANK{comm.rank} OK", flush=True)
comm.finalize()
'''


def test_cifar_two_ranks_match_one_rank_on_both_batches(tmp_path):
    """``chainermn_torch.examples.train_cifar`` in a 2-rank gloo world
    (128 synthetic CIFAR-100 samples in binary batches scattered as
    payloads, per-rank batch 16, CifarResNet depth 8 with cross-replica
    batch norm, one epoch = 4 steps): the parameters and running
    statistics are identical on both ranks, and each step's loss and the
    final state equal a 1-rank run with per-replica batch norm on the two
    ranks' batches concatenated (see the module docstring), with SGD 0.05
    and momentum 0.9."""
    results = run_world(_CIFAR_WORKER, 2, timeout=180,
                        args=[str(tmp_path)])
    assert_ranks_ok(results)
    assert "main/accuracy" in results[0][1]
    got = [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())
           for r in range(2)]
    assert got[0]["losses"] == got[1]["losses"]
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k

    train = load_cifar(str(tmp_path / "cifar-data"), n_classes=100)
    plans = split_indices(len(train), 2, shuffle=True, seed=0)
    its = [SerialIterator(SubDataset(train, p), 16, shuffle=True, seed=0)
           for p in plans]
    torch.manual_seed(0)
    model = CifarResNet(num_classes=100, depth=8, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    losses = []
    for _ in range(len(got[0]["losses"])):
        batch = next(its[0]) + next(its[1])
        x = torch.from_numpy(np.stack([b[0] for b in batch]))
        y = torch.from_numpy(np.stack([b[1] for b in batch]))
        opt.zero_grad()
        loss, _ = classifier_loss(model, x, y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert len(losses) == 4 and its[0].epoch == 1
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-4,
                               atol=1e-4)
    want = model.state_dict()
    assert set(want) == set(got[0]["state"])
    diff = torch.cat([(got[0]["state"][k] - v).reshape(-1)
                      for k, v in want.items()])
    whole = torch.cat([v.reshape(-1) for v in want.values()])
    assert (diff.norm() / whole.norm()).item() < 1e-4
    assert diff.abs().max().item() < 1e-3
