"""Dataset scattering across ranks.

Counterpart of ``chainermn_tpu/datasets/__init__.py`` (reference:
chainermn/datasets/scatter_dataset.py). The root shuffles a global index
permutation, splits it into ``comm.size`` parts and gives each rank its
part; ``create_empty_dataset`` stubs ranks that hold no data.

The JAX package splits over processes (``inter_size``/``inter_rank``),
because there one process drives every local device. In the port one
process drives one GPU, so the split is over ranks (``size``/``rank``), as
ChainerMN's was: rank r's shard is ``split_indices(...)[r]``, which is the
JAX package's shard of process r in a run with one process per device.
"""

from __future__ import annotations

import pickle
from typing import Optional, Sequence

import numpy as np

from chainermn_torch.comm.base import CommunicatorBase
from chainermn_torch.datasets.bpe import (BPETokenizer, train_bpe,
                                          train_bpe_file)
from chainermn_torch.datasets.standard_formats import (load_cifar, load_idx,
                                                       load_mnist,
                                                       save_cifar, save_idx,
                                                       save_mnist)
from chainermn_torch.datasets.image_folder import (ImageFolderDataset,
                                                   write_image_folder)
from chainermn_torch.datasets.toy import (ArrayDataset, synth_cifar_uint8,
                                          synth_uint8, synthetic_cifar,
                                          synthetic_mnist,
                                          synthetic_translation)

__all__ = ["SubDataset", "ListDataset", "split_indices", "scatter_dataset",
           "create_empty_dataset", "ArrayDataset", "synth_uint8",
           "synth_cifar_uint8", "ImageFolderDataset", "write_image_folder",
           "synthetic_mnist", "synthetic_cifar", "synthetic_translation",
           "load_idx", "save_idx", "load_mnist", "save_mnist", "load_cifar",
           "save_cifar", "BPETokenizer", "train_bpe", "train_bpe_file"]

# tag of scatter_dataset's payload stream (the JAX package's)
_SCATTER_TAG = 0x5CA77E0


class SubDataset:
    """A view of ``dataset`` at ``order`` (chainer.datasets.SubDataset
    semantics)."""

    def __init__(self, dataset, order: Sequence[int]):
        self._dataset = dataset
        self._order = np.asarray(order, dtype=np.int64)

    def __len__(self):
        return len(self._order)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._dataset[int(j)] for j in self._order[i]]
        return self._dataset[int(self._order[i])]


def split_indices(n: int, k: int, shuffle: bool = False,
                  seed: Optional[int] = None,
                  force_equal_length: bool = True):
    """The root's index plan: a permutation of ``range(n)`` split into
    ``k`` parts. ``force_equal_length`` pads the tail parts by wrapping
    (the reference's behaviour: every rank's epoch has one length)."""
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    if force_equal_length:
        per = -(-n // k)
        padded = np.resize(order, per * k)   # wraps around
        return [padded[r * per:(r + 1) * per] for r in range(k)]
    base, rem = divmod(n, k)
    out, at = [], 0
    for r in range(k):
        ln = base + (1 if r < rem else 0)
        out.append(order[at:at + ln])
        at += ln
    return out


def scatter_dataset(dataset, comm: CommunicatorBase, shuffle: bool = False,
                    root: int = 0, seed: Optional[int] = None,
                    max_buf_len: int = 256 * 1024 * 1024,
                    force_equal_length: bool = True,
                    shared_storage: bool = True):
    """This rank's shard of ``dataset``.

    One rank: the whole dataset (a shuffled view if asked). Several,
    ``shared_storage=True`` (default): the root scatters the index plan
    and every rank views its own storage through it.
    ``shared_storage=False``: the reference's semantics: the root pickles
    each shard's samples and streams them in messages of at most about
    ``max_buf_len`` pickled bytes (a message is sent once the running
    size reaches the bound), so the root holds the dataset and one
    message at a time; other ranks may pass ``dataset=None`` and get a
    :class:`ListDataset`."""
    k = comm.size
    if k == 1:
        return SubDataset(dataset, split_indices(
            len(dataset), 1, shuffle, seed, force_equal_length)[0])
    is_root = comm.rank == root
    plans = (split_indices(len(dataset), k, shuffle, seed,
                           force_equal_length) if is_root else None)
    if shared_storage:
        return SubDataset(dataset, comm.scatter_obj(plans, root=root))
    if is_root:
        for r in range(k):
            if r == root:
                continue
            buf, sz = [], 0
            for i in plans[r]:
                b = pickle.dumps(dataset[int(i)], pickle.HIGHEST_PROTOCOL)
                buf.append(b)
                sz += len(b)
                if sz >= max_buf_len:
                    comm.send_obj(buf, dest=r, tag=_SCATTER_TAG)
                    buf, sz = [], 0
            if buf:
                comm.send_obj(buf, dest=r, tag=_SCATTER_TAG)
            comm.send_obj(None, dest=r, tag=_SCATTER_TAG)   # end of stream
        return ListDataset(dataset[int(i)] for i in plans[root])
    samples = []
    while True:
        part = comm.recv_obj(src=root, tag=_SCATTER_TAG)
        if part is None:
            break
        # samples the root pickled above
        samples.extend(pickle.loads(b) for b in part)
    return ListDataset(samples)


class ListDataset:
    """A shard whose samples were received and live on this rank."""

    def __init__(self, samples):
        self._samples = list(samples)

    def __len__(self):
        return len(self._samples)

    def __getitem__(self, i):
        return self._samples[i]


class _EmptyDataset:
    def __len__(self):
        return 0

    def __getitem__(self, i):
        raise IndexError("empty dataset")


def create_empty_dataset(dataset=None):
    """A stub dataset for ranks that hold no data."""
    return _EmptyDataset()
