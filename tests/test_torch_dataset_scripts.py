"""The port's dataset scripts (``chainermn_torch/examples/make_*.py``)
against the JAX package's (``examples/{mnist,cifar,imagenet,seq2seq}/
make_*.py``): at the same seed and small sizes every file is byte for
byte the same (a gzipped file's content, its header holding the time),
and every JPEG decodes to the same pixels."""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from chainermn_torch.examples import (make_cifar_dataset, make_corpus,
                                      make_jpeg_dataset, make_mnist_dataset)
from tests.test_torch_mp import REPO

CASES = {
    "mnist": (make_mnist_dataset, "examples/mnist/make_mnist_dataset.py",
              ["--n-train", "64", "--n-test", "16", "--seed", "3"]),
    "mnist-gz": (make_mnist_dataset, "examples/mnist/make_mnist_dataset.py",
                 ["--n-train", "32", "--n-test", "8", "--gz"]),
    "cifar10": (make_cifar_dataset, "examples/cifar/make_cifar_dataset.py",
                ["--n-classes", "10", "--n-train", "40", "--n-test", "8"]),
    "cifar100": (make_cifar_dataset, "examples/cifar/make_cifar_dataset.py",
                 ["--n-train", "24", "--n-test", "8", "--seed", "5"]),
    "jpeg": (make_jpeg_dataset, "examples/imagenet/make_jpeg_dataset.py",
             ["--classes", "2", "--per-class", "3", "--image-size", "40",
              "--seed", "1"]),
    "corpus": (make_corpus, "examples/seq2seq/make_corpus.py",
               ["--lines", "50", "--words", "30", "--max-len", "6",
                "--seed", "2"]),
}


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = p
    return out


def _content(path):
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    if path.endswith(".jpg"):
        from PIL import Image

        return np.asarray(Image.open(path)).tobytes()
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_ports_files_are_jaxs(case, tmp_path):
    mod, script, flags = CASES[case]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    # the corpus script writes OUT.src / OUT.tgt; the others a directory
    jout = str(jdir / "c") if case == "corpus" else str(jdir)
    tout = str(tdir / "c") if case == "corpus" else str(tdir)
    proc = subprocess.run([sys.executable, str(REPO / script), jout, *flags],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO, env=dict(os.environ,
                                             JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    mod.main([tout, *flags])
    want, got = _files(jdir), _files(tdir)
    assert sorted(got) == sorted(want) and want
    for rel in want:
        a, b = _content(want[rel]), _content(got[rel])
        assert a == b, rel
        if not rel.endswith((".gz", ".jpg")):
            assert os.path.getsize(want[rel]) == os.path.getsize(got[rel])
