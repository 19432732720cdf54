"""The port stands alone: no module of chainermn_torch, and not
chip_smoke.py, imports JAX, flax, optax or chainermn_tpu, and the entry
points (the MNIST, CIFAR and ImageNet examples, the ResNets, batch norm
and the prefetching loader among them) refuse to fall back to the CPU
when no GPU is present."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chainermn_torch.comm import create_communicator
from chainermn_torch.device import resolve_device
from chainermn_torch.examples import train_cifar, train_imagenet, train_mnist
from chainermn_torch.links import MultiNodeBatchNormalization
from chainermn_torch.models import MLP
from chainermn_torch.models.resnet import CifarResNet, ResNet50
from chainermn_torch.models.transformer import TransformerLM
from chainermn_torch.serving.engine import Engine, EngineConfig
from chainermn_torch.serving.kv_cache import ServingStep
from chainermn_torch.training.loader import PrefetchingLoader

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "chainermn_tpu"}


def _port_files():
    return sorted((REPO / "chainermn_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) >= 20
    offenders = [f"{p.relative_to(REPO)}: {root}" for p in files
                 for root in _imported_roots(p) if root in FORBIDDEN]
    assert offenders == []


def test_importing_the_port_loads_no_jax_module():
    code = ("import sys, chainermn_torch, chainermn_torch.serving, "
            "chainermn_torch.models.convert, chainermn_torch.comm, "
            "chainermn_torch.optimizers, chainermn_torch.training, "
            "chainermn_torch.ops.fused_ce, chainermn_torch.datasets, "
            "chainermn_torch.iterators, chainermn_torch.extensions, "
            "chainermn_torch.resilience, chainermn_torch.models.mlp, "
            "chainermn_torch.examples.train_mnist, chainermn_torch.links, "
            "chainermn_torch.models.resnet, chainermn_torch.ops.native, "
            "chainermn_torch.training.loader, "
            "chainermn_torch.datasets.image_folder, "
            "chainermn_torch.examples.train_cifar, "
            "chainermn_torch.examples.train_imagenet, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _tiny(device):
    return TransformerLM(vocab=16, d_model=16, n_heads=2, n_layers=1,
                         d_ff=32, max_len=16, pos_emb="rope", device=device)


def test_entry_points_raise_without_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _tiny(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_communicator("pure_nccl")
    model = _tiny("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingStep(model, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(model, EngineConfig(n_slots=2, capacity=8))
    eng = Engine(model, EngineConfig(n_slots=2, capacity=8), device="cpu")
    assert eng.device == torch.device("cpu")
    # the MNIST slice: the model, and the example (its communicator)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MLP()
    assert MLP(n_units=4, device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mnist.main(["--epoch", "1", "--out", "unused"])
    args = train_mnist.parse_args(["--device", "cpu", "--grad-reducer",
                                   "auto"])
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        train_mnist.build_trainer(args)


def test_the_resnet_slice_raises_without_cuda_unless_asked_for_cpu(tmp_path):
    """ResNet-50, the CIFAR ResNet, batch norm, the prefetching loader and
    both examples raise without CUDA unless given the CPU; nothing falls
    back on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    files = [p.relative_to(REPO).as_posix() for p in _port_files()]
    for new in ("chainermn_torch/links/batch_normalization.py",
                "chainermn_torch/models/resnet.py",
                "chainermn_torch/training/loader.py",
                "chainermn_torch/ops/native.py",
                "chainermn_torch/datasets/image_folder.py",
                "chainermn_torch/examples/train_cifar.py",
                "chainermn_torch/examples/train_imagenet.py"):
        assert new in files       # covered by the import scan above
    for make in (lambda: ResNet50(num_classes=10),
                 lambda: CifarResNet(depth=8),
                 lambda: MultiNodeBatchNormalization(size=4),
                 lambda: PrefetchingLoader(np.zeros((4, 2), np.uint8),
                                           np.zeros(4, np.int32), 2),
                 lambda: train_cifar.main(["--epoch", "1", "--out",
                                           str(tmp_path)]),
                 lambda: train_imagenet.main(["--iterations", "1", "--out",
                                              str(tmp_path)]),
                 lambda: train_imagenet.main(["--loader", "--iterations",
                                              "1", "--out",
                                              str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert CifarResNet(depth=8, device="cpu").device == torch.device("cpu")
    loader = PrefetchingLoader(np.zeros((4, 2), np.uint8),
                               np.zeros(4, np.int32), 2, device="cpu")
    assert isinstance(next(loader)[0], np.ndarray)
    loader.close()
