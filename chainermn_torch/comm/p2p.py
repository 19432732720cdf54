"""Array point-to-point messages: structure, header and sequence guard.

A message is a tensor or a nested structure (dicts, lists, tuples,
named tuples) of tensors, as a pytree is in the JAX package's
``XlaCommunicator.send``. The receiver does not declare what it expects:
the sender first sends a header, over a gloo group that matches tags,
holding the structure, each leaf's shape and dtype, the tag and a
sequence number of the (sender, receiver) pair; the leaves follow.

Over gloo every ``(tag, src, dest)`` is an ordered channel of its own, as
in the JAX package. NCCL matches no tags: its payloads between two ranks
arrive in the order they were sent, whatever the tag. A receiver that
takes tag 1 before tag 0 would get tag 1's header with tag 0's payload, so
on an ordered (NCCL) route :meth:`Channels.accept` compares the header's
pair sequence number with the one it expects and raises on a mismatch
rather than return another message's data.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

__all__ = ["flatten", "unflatten", "Channels", "MAX_TAG", "wire_tags",
           "check_tag", "parse_dtype"]

#: user tags lie in [0, MAX_TAG); the functions' gradient channels use
#: [MAX_TAG, 2 MAX_TAG), and each tag t rides gloo tags 2t (header) and
#: 2t + 1 (payload), all below gloo's 2^32
MAX_TAG = 1 << 28


class _Leaf:
    """Position of a tensor in a flattened structure."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __reduce__(self):
        return (_Leaf, (self.index,))


def flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """``(leaves, spec)``: the tensors of ``tree`` in order, and the tree
    with each tensor replaced by its position (picklable). Any leaf that
    is not a dict, list or tuple goes through ``torch.as_tensor``; None
    stays as an empty node."""
    leaves: List[torch.Tensor] = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(v) for v in node]
            if isinstance(node, list):
                return out
            return (type(node)(*out) if hasattr(node, "_fields")
                    else tuple(out))
        leaves.append(torch.as_tensor(node))
        return _Leaf(len(leaves) - 1)

    return leaves, walk(tree)


def unflatten(spec, leaves: Sequence[torch.Tensor]):
    """The structure :func:`flatten` described, holding ``leaves``."""
    if isinstance(spec, _Leaf):
        return leaves[spec.index]
    if spec is None:
        return None
    if isinstance(spec, dict):
        return {k: unflatten(v, leaves) for k, v in spec.items()}
    out = [unflatten(v, leaves) for v in spec]
    if isinstance(spec, list):
        return out
    return type(spec)(*out) if hasattr(spec, "_fields") else tuple(out)


def parse_dtype(name: str) -> torch.dtype:
    """``str(dtype)`` back to the torch dtype."""
    dt = getattr(torch, name.split(".")[-1], None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in a message header")
    return dt


def check_tag(tag: int) -> int:
    """A channel tag: an int in ``[0, 2 MAX_TAG)``."""
    if not isinstance(tag, int) or not 0 <= tag < 2 * MAX_TAG:
        raise ValueError(f"tag must be an int in [0, {2 * MAX_TAG}), got "
                         f"{tag!r}")
    return tag


def wire_tags(tag: int) -> Tuple[int, int]:
    """The gloo tags of a channel's headers and payloads."""
    return 2 * tag, 2 * tag + 1


class Channels:
    """Header bookkeeping of one rank: a sequence number per (sender,
    receiver) pair, counted over every tag.

    ``ordered``: the payload route delivers one pair's messages in send
    order whatever their tags (NCCL), so a header whose sequence number is
    not the next one expected means the receiver took the channels out
    of send order; :meth:`accept` raises instead of pairing the header
    with another message's payload.
    """

    def __init__(self, ordered: bool):
        self.ordered = ordered
        self._sent: Dict[int, int] = {}
        self._received: Dict[int, int] = {}

    def header(self, dest: int, tag: int, spec,
               leaves: Sequence[torch.Tensor]) -> dict:
        """The header of the next message to ``dest``."""
        seq = self._sent.get(dest, 0)
        self._sent[dest] = seq + 1
        return {"tag": tag, "seq": seq, "spec": spec,
                "shapes": [tuple(t.shape) for t in leaves],
                "dtypes": [str(t.dtype) for t in leaves]}

    def accept(self, src: int, tag: int,
               header: dict) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
        """Check a header received from ``src`` on ``tag``; returns each
        leaf's ``(shape, dtype)``."""
        if header["tag"] != tag:
            raise RuntimeError(f"message header from rank {src} carries "
                               f"tag {header['tag']}, received on {tag}")
        want = self._received.get(src, 0)
        if self.ordered and header["seq"] != want:
            raise RuntimeError(
                f"out-of-order receive from rank {src}: tag {tag} carries "
                f"message {header['seq']} of the pair, but message {want} "
                f"is the next one on the wire. NCCL matches no tags, so "
                f"its payload would be another message's data; receive "
                f"in the order the sender sent")
        self._received[src] = header["seq"] + 1
        return [(tuple(s), parse_dtype(d))
                for s, d in zip(header["shapes"], header["dtypes"])]
