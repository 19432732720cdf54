"""Readers/writers for the standard on-disk dataset formats the reference's
examples consume: IDX (MNIST ``train-images-idx3-ubyte``) and the CIFAR
binary batch layout.

The port's own copy of ``chainermn_tpu/datasets/standard_formats.py``
(numpy only): files either package writes, the other reads back
byte-identical.

The reference's MNIST/CIFAR examples parse real dataset files (upstream
``examples/mnist/train_mnist.py`` via ``chainer.datasets.get_mnist`` — the
LeCun IDX format; CIFAR via the binary batches). This environment has no
network egress, so the writers here produce byte-identical layouts locally
and the examples *parse* them — the executed input path is always the real
format parser, never an in-memory synthetic array.

IDX format (the canonical spec, as written by the original MNIST files)::

    [0x00 0x00] [dtype code] [ndim]      -- 4-byte magic, big-endian
    ndim x uint32 big-endian dimensions
    row-major payload, big-endian for multi-byte dtypes

dtype codes: 0x08 uint8, 0x09 int8, 0x0B int16, 0x0C int32, 0x0D float32,
0x0E float64.

CIFAR binary (per record, no header, fixed-size records)::

    CIFAR-10  : [label u8]               [3072 bytes: 3x32x32 channel-major]
    CIFAR-100 : [coarse u8] [fine u8]    [3072 bytes: 3x32x32 channel-major]

Files: CIFAR-10 ``data_batch_{1..5}.bin`` + ``test_batch.bin``; CIFAR-100
``train.bin`` + ``test.bin``.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Tuple

import numpy as np

from chainermn_torch.datasets.toy import ArrayDataset

_IDX_DTYPES = {
    0x08: np.dtype(np.uint8),
    0x09: np.dtype(np.int8),
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}
_IDX_CODES = {
    np.dtype(np.uint8): 0x08,
    np.dtype(np.int8): 0x09,
    np.dtype(np.int16): 0x0B,
    np.dtype(np.int32): 0x0C,
    np.dtype(np.float32): 0x0D,
    np.dtype(np.float64): 0x0E,
}


def _open_maybe_gz(path: str):
    """The distributed MNIST files are gzipped (``*-ubyte.gz``); accept
    both the unpacked and the gzipped form transparently."""
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def load_idx(path: str) -> np.ndarray:
    """Parse one IDX file (optionally ``.gz``) into a native-endian array."""
    with _open_maybe_gz(path) as f:
        magic = f.read(4)
        if len(magic) != 4 or magic[0] != 0 or magic[1] != 0:
            raise ValueError(
                f"{path}: not an IDX file (magic starts "
                f"{magic[:2].hex() if magic else '<empty>'}, expected 0000)")
        code, ndim = magic[2], magic[3]
        if code not in _IDX_DTYPES:
            raise ValueError(
                f"{path}: unknown IDX dtype code 0x{code:02x}")
        dims_raw = f.read(4 * ndim)
        if len(dims_raw) != 4 * ndim:
            raise ValueError(f"{path}: truncated IDX dimension header")
        dims = struct.unpack(f">{ndim}I", dims_raw)
        dtype = _IDX_DTYPES[code]
        count = int(np.prod(dims, initial=1))
        payload = f.read(count * dtype.itemsize)
        if len(payload) != count * dtype.itemsize:
            raise ValueError(
                f"{path}: truncated IDX payload ({len(payload)} bytes, "
                f"expected {count * dtype.itemsize} for shape {dims})")
        arr = np.frombuffer(payload, dtype=dtype).reshape(dims)
        # native-endian copy (frombuffer views are read-only big-endian)
        return arr.astype(dtype.newbyteorder("="), copy=True)


def save_idx(path: str, arr: np.ndarray) -> None:
    """Write ``arr`` in IDX layout (big-endian payload, spec-exact)."""
    arr = np.asarray(arr)
    code = _IDX_CODES.get(np.dtype(arr.dtype.name))
    if code is None:
        raise ValueError(f"dtype {arr.dtype} has no IDX code")
    if arr.ndim > 255:
        raise ValueError("IDX ndim is a single byte")
    with open(path, "wb") as f:
        f.write(bytes([0, 0, code, arr.ndim]))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(np.ascontiguousarray(
            arr, dtype=arr.dtype.newbyteorder(">")).tobytes())


def _find_idx(data_dir: str, stem: str) -> str:
    """Resolve ``stem`` under ``data_dir`` accepting the two distributed
    spellings (``-idx3-ubyte`` / ``.idx3-ubyte``) and optional ``.gz``."""
    for name in (stem, stem + ".gz",
                 stem.replace("-idx", ".idx"),
                 stem.replace("-idx", ".idx") + ".gz"):
        p = os.path.join(data_dir, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"{data_dir}: no {stem}[.gz] (expected the standard MNIST file "
        "names; write one with save_mnist and synth_uint8)")


def load_mnist(data_dir: str, train: bool = True,
               normalize: bool = True) -> ArrayDataset:
    """Load an MNIST-layout directory (``train-images-idx3-ubyte`` etc.,
    plain or gzipped) into an :class:`ArrayDataset` of
    (float32 [28,28] in [0,1], int32 label) pairs — the reference's
    ``get_mnist`` output shape."""
    prefix = "train" if train else "t10k"
    images = load_idx(_find_idx(data_dir, f"{prefix}-images-idx3-ubyte"))
    labels = load_idx(_find_idx(data_dir, f"{prefix}-labels-idx1-ubyte"))
    if images.ndim != 3:
        raise ValueError(
            f"images file has ndim={images.ndim}, expected 3 (N, H, W)")
    if labels.ndim != 1 or len(labels) != len(images):
        raise ValueError(
            f"labels/images mismatch: {labels.shape} vs {images.shape}")
    xs = images.astype(np.float32)
    if normalize:
        xs /= 255.0
    return ArrayDataset(xs, labels.astype(np.int32))


def save_mnist(data_dir: str, xs: np.ndarray, ys: np.ndarray,
               train: bool = True, gz: bool = False) -> None:
    """Write (uint8 images [N,28,28], labels [N]) as standard MNIST IDX
    files under ``data_dir``."""
    os.makedirs(data_dir, exist_ok=True)
    prefix = "train" if train else "t10k"
    ipath = os.path.join(data_dir, f"{prefix}-images-idx3-ubyte")
    lpath = os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte")
    save_idx(ipath, np.asarray(xs, np.uint8))
    save_idx(lpath, np.asarray(ys, np.uint8))
    if gz:
        for p in (ipath, lpath):
            with open(p, "rb") as src, gzip.open(p + ".gz", "wb") as dst:
                dst.write(src.read())
            os.remove(p)


_CIFAR_REC = 3 * 32 * 32  # channel-major pixel payload per record


def _parse_cifar_records(raw: bytes, label_bytes: int, path: str
                         ) -> Tuple[np.ndarray, np.ndarray]:
    rec = label_bytes + _CIFAR_REC
    if len(raw) == 0 or len(raw) % rec != 0:
        raise ValueError(
            f"{path}: size {len(raw)} is not a multiple of the "
            f"{rec}-byte record ({label_bytes} label byte(s) + 3072 pixels)")
    a = np.frombuffer(raw, np.uint8).reshape(-1, rec)
    # fine label is the LAST label byte (CIFAR-100: [coarse, fine])
    labels = a[:, label_bytes - 1].astype(np.int32)
    # channel-major [3,32,32] -> NHWC
    imgs = a[:, label_bytes:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return imgs, labels


def load_cifar(data_dir: str, n_classes: int = 100, train: bool = True,
               normalize: bool = True) -> ArrayDataset:
    """Load a CIFAR binary-layout directory into an :class:`ArrayDataset`
    of (float32 NHWC [32,32,3] in [0,1], int32 fine label) pairs.

    ``n_classes=100`` reads ``train.bin``/``test.bin`` (2 label bytes per
    record, fine label used); ``n_classes=10`` reads
    ``data_batch_{1..5}.bin``/``test_batch.bin`` (1 label byte)."""
    if n_classes == 100:
        files = ["train.bin"] if train else ["test.bin"]
        label_bytes = 2
        optional = set()
    elif n_classes == 10:
        files = ([f"data_batch_{i}.bin" for i in range(1, 6)]
                 if train else ["test_batch.bin"])
        label_bytes = 1
        # the real distribution always has all five train batches; a
        # small locally-generated set may hold fewer (save_cifar skips
        # empty parts), so only batch 1 is mandatory
        optional = set(files[1:]) if train else set()
    else:
        raise ValueError(f"n_classes must be 10 or 100, got {n_classes}")
    imgs, labels = [], []
    for name in files:
        path = os.path.join(data_dir, name)
        if not os.path.exists(path):
            if name in optional:
                continue
            raise FileNotFoundError(
                f"{path}: missing CIFAR-{n_classes} binary batch "
                "(generate locally with save_cifar)")
        with open(path, "rb") as f:
            i, l = _parse_cifar_records(f.read(), label_bytes, path)
        imgs.append(i)
        labels.append(l)
    xs = np.concatenate(imgs).astype(np.float32)
    if normalize:
        xs /= 255.0
    return ArrayDataset(xs, np.concatenate(labels))


def save_cifar(data_dir: str, xs: np.ndarray, ys: np.ndarray,
               n_classes: int = 100, train: bool = True,
               coarse: np.ndarray = None) -> None:
    """Write (uint8 NHWC images, fine labels) as CIFAR binary batches.

    CIFAR-100 records carry [coarse, fine] label bytes; ``coarse``
    defaults to ``fine // 5`` (the real file's 20 superclasses also
    partition the 100 classes 5-to-1)."""
    os.makedirs(data_dir, exist_ok=True)
    xs = np.asarray(xs, np.uint8)
    ys = np.asarray(ys, np.uint8)
    pix = xs.transpose(0, 3, 1, 2).reshape(len(xs), _CIFAR_REC)
    if n_classes == 100:
        if coarse is None:
            coarse = ys // 5
        recs = np.concatenate(
            [np.asarray(coarse, np.uint8)[:, None], ys[:, None], pix],
            axis=1)
        files = {("train.bin" if train else "test.bin"): recs}
    elif n_classes == 10:
        recs = np.concatenate([ys[:, None], pix], axis=1)
        if train:
            if len(recs) == 0:
                raise ValueError("cannot save an empty CIFAR-10 set")
            # skip empty parts for tiny locally-generated sets (a 0-byte
            # batch file would fail the loader's record-size check);
            # load_cifar treats batches 2..5 as optional accordingly
            parts = [p for p in np.array_split(recs, 5) if len(p)]
            files = {f"data_batch_{i + 1}.bin": p
                     for i, p in enumerate(parts)}
        else:
            files = {"test_batch.bin": recs}
    else:
        raise ValueError(f"n_classes must be 10 or 100, got {n_classes}")
    for name, r in files.items():
        with open(os.path.join(data_dir, name), "wb") as f:
            f.write(r.tobytes())
