"""The port's iterators against the JAX package's: ``SerialIterator``
gives the same batches for a seed over several epochs (the short last
batch's wrap included), stops the same way with ``repeat=False`` and
resumes exactly from ``state_dict``; the multi-node and synchronized
iterators run in a real 2-rank gloo world. Batches are sample indices:
compared exactly."""

import pickle

import numpy as np
import pytest

from chainermn_tpu.iterators import SerialIterator as JaxSerialIterator
from chainermn_torch.comm import create_communicator
from chainermn_torch.iterators import (SerialIterator,
                                       create_multi_node_iterator)
from tests.test_torch_mp import assert_ranks_ok, run_world


def _drain(it, n):
    out = []
    for _ in range(n):
        batch = next(it)
        out.append(([int(b) for b in batch], it.epoch, it.is_new_epoch,
                    it.epoch_detail))
    return out


@pytest.mark.parametrize("n,batch", [(10, 3), (12, 4), (7, 7), (5, 8)])
@pytest.mark.parametrize("shuffle,seed", [(True, 0), (True, 77),
                                          (False, None)])
def test_serial_iterator_batches_are_the_jax_packages(n, batch, shuffle,
                                                      seed):
    """Three epochs (and a bit) of batches, epoch counters and
    ``epoch_detail`` equal JAX's."""
    ds = list(range(n))
    steps = -(-3 * n // batch) + 1
    got = _drain(SerialIterator(ds, batch, shuffle=shuffle, seed=seed),
                 steps)
    want = _drain(JaxSerialIterator(ds, batch, shuffle=shuffle, seed=seed),
                  steps)
    assert got == want


@pytest.mark.parametrize("n,batch", [(10, 3), (12, 4), (5, 8)])
def test_serial_iterator_without_repeat_stops_as_jaxs(n, batch):
    ds = list(range(n))
    got = [[int(b) for b in bt] for bt in SerialIterator(
        ds, batch, repeat=False, shuffle=True, seed=5)]
    want = [[int(b) for b in bt] for bt in JaxSerialIterator(
        ds, batch, repeat=False, shuffle=True, seed=5)]
    assert got == want and sorted(sum(got, [])) == ds


def test_serial_iterator_state_dict_round_trip_and_set_position():
    """A restored iterator continues with the exact next batches (through
    epoch ends, so the restored RNG reshuffles alike); a state of another
    dataset size is refused; ``set_position`` jumps like JAX's."""
    ds = list(range(11))
    it = SerialIterator(ds, 4, shuffle=True, seed=3)
    _drain(it, 5)
    state = pickle.loads(pickle.dumps(it.state_dict()))
    ahead = _drain(it, 9)
    fresh = SerialIterator(ds, 4, shuffle=True, seed=999)
    fresh.load_state_dict(state)
    assert _drain(fresh, 9) == ahead
    with pytest.raises(ValueError, match="dataset of 11 samples"):
        SerialIterator(list(range(5)), 4).load_state_dict(state)
    a, b = (SerialIterator(ds, 4, seed=8), JaxSerialIterator(ds, 4, seed=8))
    a.set_position(13, epoch=2)
    b.set_position(13, epoch=2)
    assert _drain(a, 6) == _drain(b, 6)


_WORLD = r'''
import numpy as np
from chainermn_torch.comm import create_communicator
from chainermn_torch.iterators import (SerialIterator,
                                       create_multi_node_iterator,
                                       create_synchronized_iterator)

comm = create_communicator("pure_nccl", device="cpu")
r = comm.rank
data = list(range(100, 110))

# multi-node: the master iterates, every rank gets its batches and
# epoch counters, and StopIteration ends every rank's loop together
inner = SerialIterator(data, 4, repeat=False, shuffle=True, seed=1) \
    if r == 0 else None
it = create_multi_node_iterator(inner, comm, rank_master=0)
seen = [(list(b), it.epoch, it.is_new_epoch) for b in it]
ref = SerialIterator(data, 4, repeat=False, shuffle=True, seed=1)
want = []
for b in ref:
    want.append((list(b), ref.epoch, ref.is_new_epoch))
assert seen == want, (r, seen)
assert it.epoch == 1 and len(seen) == 3
st = it.state_dict()
assert (st["inner"] is None) == (r != 0) and st["epoch"] == 1

# master on rank 1, repeating: the same stream on both ranks
inner = SerialIterator(data, 3, shuffle=True, seed=4) if r == 1 else None
it = create_multi_node_iterator(inner, comm, rank_master=1)
got = [list(next(it)) for _ in range(5)]
assert comm.allgather_obj(got)[0] == got
ref = SerialIterator(data, 3, shuffle=True, seed=4)
assert got == [list(next(ref)) for _ in range(5)]

# synchronized: ranks seeded apart draw the same batches afterwards
it = create_synchronized_iterator(
    SerialIterator(data, 4, shuffle=True, seed=10 + r), comm)
mine = [list(next(it)) for _ in range(6)]
both = comm.allgather_obj(mine)
assert both[0] == both[1]
comm.finalize()
print(f"RANK{r} OK", flush=True)
'''


def test_multi_node_and_synchronized_iterators_two_ranks():
    """``create_multi_node_iterator`` (master 0 without repeat: the
    master's batches, epoch counters and stop on both ranks; master 1
    repeating) and ``create_synchronized_iterator`` (ranks seeded apart
    draw equal batches) in a 2-rank world."""
    assert_ranks_ok(run_world(_WORLD, 2, timeout=90))


def test_multi_node_iterator_of_one_rank_is_the_inner_one():
    comm = create_communicator("naive", device="cpu")
    try:
        inner = SerialIterator(list(range(4)), 2)
        assert create_multi_node_iterator(inner, comm) is inner
    finally:
        comm.finalize()
