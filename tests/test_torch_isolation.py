"""The port stands alone: no module of chainermn_torch, and not
chip_smoke.py, imports JAX, flax, optax or chainermn_tpu, and the entry
points (the MNIST, CIFAR and ImageNet examples, the ResNets, batch norm
and the prefetching loader among them) refuse to fall back to the CPU
when no GPU is present."""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
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
            "chainermn_torch.examples.train_imagenet, "
            "chainermn_torch.functions, chainermn_torch.links.chain_list, "
            "chainermn_torch.models.seq2seq, chainermn_torch.datasets.bpe, "
            "chainermn_torch.comm.p2p, chainermn_torch.parallel, "
            "chainermn_torch.examples.train_seq2seq, "
            "chainermn_torch.examples.train_mnist_model_parallel, "
            "chainermn_torch.examples.train_mnist_eager_p2p, "
            "chainermn_torch.models.vit, chainermn_torch.ops.dropout, "
            "chainermn_torch.extensions.checkpoint, "
            "chainermn_torch.optimizers.zero, "
            "chainermn_torch.optimizers.large_batch, "
            "chainermn_torch.examples.train_lm, "
            "chainermn_torch.serving.speculative, "
            "chainermn_torch.serving.weights, "
            "chainermn_torch.serving.frontend, "
            "chainermn_torch.examples.serve_transformer_lm, "
            "chainermn_torch.tools.serve_lm, chainermn_torch.fleet, "
            "chainermn_torch.comm.socket_plane, "
            "chainermn_torch.tools.fleet_lm, chainermn_torch.tuning, "
            "chainermn_torch.synthesis, chainermn_torch.tuning.hlo, "
            "chainermn_torch.training.profiling, "
            "chainermn_torch.tools.schedtune, chainermn_torch.tools.synth, "
            "chainermn_torch.tools.profile_lm, chip_smoke; "
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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mnist.main(["--epoch", "1", "--grad-reducer", "auto",
                          "--out", "unused"])
    # the tuner's and the profiler's entry points
    from chainermn_torch.tools import profile_lm

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_lm.build_step(profile_lm.parse_args([]))


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


def test_the_model_parallel_and_seq2seq_slice_raises_without_cuda(tmp_path):
    """The communication functions, the chain list, the seq2seq model, BPE
    and the three examples are covered by the import scan; the seq2seq
    model and the examples raise without CUDA unless given the CPU, and
    the host-staged communicator is chosen by its name only."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    from chainermn_torch.examples import (train_mnist_eager_p2p,
                                          train_mnist_model_parallel,
                                          train_seq2seq)
    from chainermn_torch.models.seq2seq import Seq2Seq

    files = [p.relative_to(REPO).as_posix() for p in _port_files()]
    for new in ("chainermn_torch/comm/p2p.py",
                "chainermn_torch/functions/__init__.py",
                "chainermn_torch/functions/point_to_point.py",
                "chainermn_torch/functions/eager_p2p.py",
                "chainermn_torch/functions/collective.py",
                "chainermn_torch/links/chain_list.py",
                "chainermn_torch/models/seq2seq.py",
                "chainermn_torch/datasets/bpe.py",
                "chainermn_torch/examples/train_seq2seq.py",
                "chainermn_torch/examples/train_mnist_model_parallel.py",
                "chainermn_torch/examples/train_mnist_eager_p2p.py"):
        assert new in files       # covered by the import scan above
    for make in (lambda: Seq2Seq(n_units=4, src_vocab=8, tgt_vocab=8),
                 lambda: train_seq2seq.main(["--epoch", "1"]),
                 lambda: train_mnist_model_parallel.main(["--epoch", "1"]),
                 lambda: train_mnist_eager_p2p.worker(
                     train_mnist_eager_p2p.parse_args([])),
                 lambda: create_communicator("non_cuda_aware")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert Seq2Seq(n_units=4, src_vocab=8, tgt_vocab=8,
                   device="cpu").device == torch.device("cpu")


def test_the_vit_and_checkpoint_slice_raises_without_cuda(tmp_path):
    """The ViT, dropout keys and the checkpointer are covered by the
    import scan; the ViT and ``train_imagenet --model vit`` (with
    snapshots) raise without CUDA unless given the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    from chainermn_torch.models.vit import ViT

    files = [p.relative_to(REPO).as_posix() for p in _port_files()]
    for new in ("chainermn_torch/models/vit.py",
                "chainermn_torch/ops/dropout.py",
                "chainermn_torch/extensions/checkpoint.py"):
        assert new in files       # covered by the import scan above
    for make in (lambda: ViT(num_classes=10, image_size=32, patch=8),
                 lambda: train_imagenet.main(
                     ["--model", "vit", "--iterations", "1",
                      "--snapshot-every", "1", "--out", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert ViT(num_classes=10, image_size=32, patch=8, d_model=16,
               n_layers=1, n_heads=2, d_ff=16,
               device="cpu").device == torch.device("cpu")


def test_the_reducer_slice_raises_without_cuda_unless_asked_for_cpu(
        tmp_path):
    """The sub-communicators and the reducers are covered by the import
    scan; the communicator names that shape a mesh raise without CUDA
    unless given the CPU, and ``train_mnist --grad-reducer`` builds on the
    CPU with every strategy (the reducers were refused before this
    slice)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    files = [p.relative_to(REPO).as_posix() for p in _port_files()]
    for new in ("chainermn_torch/collectives/__init__.py",
                "chainermn_torch/collectives/base.py",
                "chainermn_torch/collectives/flat.py",
                "chainermn_torch/collectives/hierarchical.py",
                "chainermn_torch/collectives/quantized.py",
                "chainermn_torch/collectives/auto.py"):
        assert new in files       # covered by the import scan above
    for name in ("hierarchical", "two_dimensional"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_communicator(name)
    for flags in (["--grad-reducer", "hierarchical"],
                  ["--grad-reducer", "quantized", "--wire-format",
                   "int4-block"],
                  ["--grad-reducer", "auto", "--wire-format", "bf16"]):
        trainer, _ = train_mnist.build_trainer(train_mnist.parse_args(
            ["--device", "cpu", "--unit", "4", "--n-train", "64",
             "--out", str(tmp_path), *flags]))
        assert trainer.updater.comm.device == torch.device("cpu")
        trainer.updater.comm.finalize()


def test_the_zero_slice_raises_without_cuda_unless_asked_for_cpu(tmp_path):
    """ZeRO-1/2, LARS/LAMB and ``train_lm`` are covered by the import
    scan; ``train_lm`` (data-parallel and ``--zero``) and ``train_imagenet
    --optimizer lars|lamb`` raise without CUDA unless given the CPU, and
    the CPU builds them (the optimizers were refused before this
    slice)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    from chainermn_torch.examples import train_lm

    files = [p.relative_to(REPO).as_posix() for p in _port_files()]
    for new in ("chainermn_torch/optimizers/zero.py",
                "chainermn_torch/optimizers/large_batch.py",
                "chainermn_torch/examples/train_lm.py"):
        assert new in files       # covered by the import scan above
    for make in (lambda: train_lm.main(["--iterations", "1", "--out",
                                        str(tmp_path)]),
                 lambda: train_lm.main(["--zero", "1", "--iterations", "1",
                                        "--out", str(tmp_path)]),
                 lambda: train_imagenet.main(
                     ["--optimizer", "lars", "--iterations", "1", "--out",
                      str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    trainer, model = train_lm.build_trainer(train_lm.parse_args(
        ["--device", "cpu", "--zero", "2", "--n-train", "64", "--out",
         str(tmp_path)]))
    assert model.device == torch.device("cpu")
    trainer.updater.comm.finalize()
    trainer, _ = train_imagenet.build_trainer(train_imagenet.parse_args(
        ["--device", "cpu", "--optimizer", "lamb", "--model", "vit",
         "--image-size", "32", "--n-train", "8", "--batchsize", "2",
         "--out", str(tmp_path)]))
    assert trainer.updater.comm.device == torch.device("cpu")
    trainer.updater.comm.finalize()


def test_the_serving_slice_raises_without_cuda_unless_asked_for_cpu():
    """The speculative engine, the example and the replica tool default
    to the card; nothing of the rest of serving falls back on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    from chainermn_torch.examples import serve_transformer_lm
    from chainermn_torch.serving.speculative import SpeculativeEngine
    from chainermn_torch.tools import serve_lm

    files = [p.relative_to(REPO).as_posix() for p in _port_files()]
    for new in ("chainermn_torch/serving/speculative.py",
                "chainermn_torch/serving/weights.py",
                "chainermn_torch/serving/frontend.py",
                "chainermn_torch/examples/serve_transformer_lm.py",
                "chainermn_torch/tools/serve_lm.py"):
        assert new in files       # covered by the import scan above
    model = _tiny("cpu")
    cfg = EngineConfig(n_slots=2, capacity=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpeculativeEngine(model, model, cfg, spec_k=2)
    assert SpeculativeEngine(model, model, cfg, spec_k=2,
                             device="cpu").draft.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_transformer_lm.main(["--train-steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_lm.serve(serve_lm.argparse.Namespace(
            vocab=16, d_model=16, n_heads=2, n_layers=1, capacity=8,
            seed=0, device="cuda"))


def test_sharded_serving_and_the_dataset_scripts_stay_on_the_port(tmp_path):
    """The head-sharded engine defaults to the card like the rest of
    serving; JAX's sampling stream runs on the tensors it is given; the
    dataset scripts are covered by the import scan."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    from chainermn_torch.models.transformer import generate

    files = [p.relative_to(REPO).as_posix() for p in _port_files()]
    for new in ("make_mnist_dataset", "make_cifar_dataset",
                "make_jpeg_dataset", "make_corpus"):
        assert f"chainermn_torch/examples/{new}.py" in files
    model = _tiny("cpu")
    comm = create_communicator("pure_nccl", device="cpu")
    try:
        cfg = EngineConfig(n_slots=2, capacity=8)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Engine(model, cfg, mesh=comm)
        eng = Engine(model, cfg, device="cpu", mesh=comm)
        assert eng.steps.cache["block_0"]["k"].device.type == "cpu"
    finally:
        comm.finalize()
    out = generate(model, np.zeros((1, 2), np.int64), 2, rng=0)
    assert out.device.type == "cpu"


def test_the_fleet_slice_raises_without_cuda_unless_asked_for_cpu(tmp_path):
    """The fleet (handoff codec, transports, socket plane, pools, router,
    rollout) and ``fleet_lm`` are covered by the import scan; a Router
    over engines built without a device, and ``fleet_lm`` without
    ``--device cpu``, raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    from chainermn_torch.fleet import DisaggregatedFleet, Router
    from chainermn_torch.tools import fleet_lm

    files = [p.relative_to(REPO).as_posix() for p in _port_files()]
    for new in ("chainermn_torch/fleet/__init__.py",
                "chainermn_torch/fleet/handoff.py",
                "chainermn_torch/fleet/health.py",
                "chainermn_torch/fleet/reports.py",
                "chainermn_torch/fleet/transport.py",
                "chainermn_torch/fleet/pools.py",
                "chainermn_torch/fleet/router.py",
                "chainermn_torch/fleet/rollout.py",
                "chainermn_torch/comm/socket_plane.py",
                "chainermn_torch/tools/fleet_lm.py"):
        assert new in files       # covered by the import scan above
    model = _tiny("cpu")
    cfg = EngineConfig(n_slots=2, capacity=8, buckets=(8,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Router([Engine(model, cfg), Engine(model, cfg)])
    out = str(tmp_path / "s.jsonl")
    for argv in ([], ["--disaggregate"], ["--hosts", "2", "--plane-dir",
                                           str(tmp_path)]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fleet_lm.serve(fleet_lm.parse_args(["--out", out, *argv]))
    engines = [Engine(model, cfg, device="cpu") for _ in range(2)]
    with Router(engines) as router:
        fut = router.submit(np.arange(3, dtype=np.int32), max_new_tokens=2)
        assert len(router.result(fut, timeout_ms=60_000).tokens) == 2
    fleet = DisaggregatedFleet(Engine(model, cfg, device="cpu"),
                               Engine(model, cfg, device="cpu"))
    stream = fleet.submit(np.arange(3, dtype=np.int32), max_new_tokens=2)
    fleet.run_until_drained()
    assert stream.finished and len(stream.tokens) == 2
