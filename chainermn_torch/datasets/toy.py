"""Self-contained datasets for examples and tests.

The port's own copy of ``chainermn_tpu/datasets/toy.py`` (numpy only),
plus :func:`synth_uint8` and :func:`synth_cifar_uint8`, the copies of
``examples/mnist/make_mnist_dataset.py``'s and
``examples/cifar/make_cifar_dataset.py``'s generators. The same seed gives
the same arrays as the JAX package, so the two packages train on the
same data.

Deterministic synthetic stand-ins shaped exactly like the reference's
datasets (MNIST 28×28 grayscale/10 classes, CIFAR 32×32×3/100 classes);
nothing is downloaded. Real data drops in unchanged: anything indexable
as (image, label) works.
"""

from __future__ import annotations

import numpy as np


class ArrayDataset:
    """Pairs of (x, y) arrays, indexable like the reference's TupleDataset."""

    def __init__(self, xs: np.ndarray, ys: np.ndarray):
        if len(xs) != len(ys):
            raise ValueError(f"{len(xs)} inputs but {len(ys)} labels")
        self.xs = xs
        self.ys = ys

    def __len__(self):
        return len(self.xs)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(zip(self.xs[i], self.ys[i]))
        return self.xs[i], self.ys[i]


def synthetic_mnist(n: int = 4096, seed: int = 0):
    """Class-separable synthetic MNIST: each class has a fixed random
    prototype plus noise, so a model can actually learn (loss decreases,
    accuracy rises) — unlike pure-noise data. Prototypes are seed-independent
    so train/test splits (different seeds) share the same classes."""
    protos = np.random.RandomState(12345).rand(10, 28, 28).astype(np.float32)
    rng = np.random.RandomState(seed)
    ys = rng.randint(0, 10, size=n).astype(np.int32)
    xs = protos[ys] + 0.3 * rng.randn(n, 28, 28).astype(np.float32)
    return ArrayDataset(xs.astype(np.float32), ys)


def synth_uint8(n: int, seed: int):
    """:func:`synthetic_mnist`'s prototype recipe quantized to uint8
    images and labels: the input of ``save_mnist`` (IDX files)."""
    protos = np.random.RandomState(12345).rand(10, 28, 28)
    rng = np.random.RandomState(seed)
    ys = rng.randint(0, 10, size=n)
    xs = protos[ys] + 0.3 * rng.randn(n, 28, 28)
    xs = np.clip(xs, 0.0, 1.5) / 1.5
    return (xs * 255).astype(np.uint8), ys.astype(np.uint8)


def synth_cifar_uint8(n: int, n_classes: int, seed: int):
    """The copy of ``examples/cifar/make_cifar_dataset.py``'s generator:
    :func:`synthetic_cifar`'s prototype recipe (prototypes from
    ``RandomState(54321)``) quantized to uint8 ``[n, 32, 32, 3]`` images
    and uint8 labels, the input of ``save_cifar``."""
    protos = np.random.RandomState(54321).rand(n_classes, 32, 32, 3)
    rng = np.random.RandomState(seed)
    ys = rng.randint(0, n_classes, size=n)
    xs = protos[ys] + 0.3 * rng.randn(n, 32, 32, 3)
    xs = np.clip(xs, 0.0, 1.5) / 1.5
    return (xs * 255).astype(np.uint8), ys.astype(np.uint8)


def synthetic_cifar(n: int = 4096, n_classes: int = 100, seed: int = 0):
    protos = np.random.RandomState(54321).rand(
        n_classes, 32, 32, 3).astype(np.float32)
    rng = np.random.RandomState(seed)
    ys = rng.randint(0, n_classes, size=n).astype(np.int32)
    xs = protos[ys] + 0.3 * rng.randn(n, 32, 32, 3).astype(np.float32)
    return ArrayDataset(xs.astype(np.float32), ys)


def synthetic_translation(n: int = 2048, src_vocab: int = 1000,
                          tgt_vocab: int = 1000, max_len: int = 24,
                          seed: int = 0):
    """Variable-length 'translation' pairs: the target is a deterministic
    transform of the source (reversal mod vocab), so seq2seq training has
    signal. Mirrors the reference's WMT En-De usage shape (lists of int
    arrays of varying length)."""
    rng = np.random.RandomState(seed)
    data = []
    for _ in range(n):
        ln = rng.randint(4, max_len)
        src = rng.randint(3, src_vocab, size=ln).astype(np.int32)
        tgt = ((src[::-1] + 7) % (tgt_vocab - 3) + 3).astype(np.int32)
        data.append((src, tgt))

    class _Seq:
        def __len__(self):
            return len(data)

        def __getitem__(self, i):
            return data[i]

    return _Seq()
