"""Byte-level BPE tokenizer: the reference seq2seq vocabulary path.

The port's own copy of ``chainermn_tpu/datasets/bpe.py`` (pure Python;
the port imports nothing of the JAX package). The vocabulary file keeps
the JAX package's format name, so a file trained by either package loads
in the other.

Reference parity: upstream ``examples/seq2seq/seq2seq.py`` (SURVEY.md
§3.4) builds word vocabularies from WMT text files and encodes source/
target corpora before scattering them. This is the same role with the
modern construction — byte-level BPE (GPT-2 style base alphabet of all
256 bytes, so ANY unicode text round-trips exactly, no UNK) trained
locally on the corpus it will encode.

Pure Python on purpose: training is a one-shot preprocessing step
(pair-count + merge loop over a word-frequency table, the original BPE
algorithm), not hot-path work. Encoded corpora are arrays; the hot path
never touches the tokenizer.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# specials come FIRST so pad=0 matches the models' masking convention
PAD, BOS, EOS = 0, 1, 2
_N_SPECIAL = 3


class BPETokenizer:
    """Byte-level BPE: ids [0, 3) are PAD/BOS/EOS, [3, 259) the raw
    bytes, and beyond that one id per learned merge, in merge order."""

    def __init__(self, merges: Sequence[Tuple[int, int]]):
        self.merges: List[Tuple[int, int]] = [tuple(m) for m in merges]
        # rank of each pair = merge priority (lower merges first)
        self._rank: Dict[Tuple[int, int], int] = {
            m: i for i, m in enumerate(self.merges)}
        # id of the token a pair merges into
        self._pair_id: Dict[Tuple[int, int], int] = {
            m: _N_SPECIAL + 256 + i for i, m in enumerate(self.merges)}

    @property
    def vocab_size(self) -> int:
        return _N_SPECIAL + 256 + len(self.merges)

    # -- codec ----------------------------------------------------------

    def _merge_word(self, ids: List[int]) -> List[int]:
        """Apply merges in rank order (classic BPE greedy loop)."""
        while len(ids) > 1:
            best = None
            best_rank = None
            for pair in zip(ids, ids[1:]):
                r = self._rank.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = pair, r
            if best is None:
                break
            out = []
            i = 0
            while i < len(ids):
                if (i + 1 < len(ids)
                        and (ids[i], ids[i + 1]) == best):
                    out.append(self._pair_id[best])
                    i += 2
                else:
                    out.append(ids[i])
                    i += 1
            ids = out
        return ids

    def encode(self, text: str, bos: bool = False,
               eos: bool = False) -> List[int]:
        ids: List[int] = [BOS] if bos else []
        for word in _split_words(text):
            ids.extend(self._merge_word(
                [b + _N_SPECIAL for b in word]))
        if eos:
            ids.append(EOS)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        bs = bytearray()
        for i in ids:
            i = int(i)
            if i < _N_SPECIAL:
                continue
            bs.extend(self._bytes_of(i))
        return bs.decode("utf-8", errors="replace")

    def _bytes_of(self, tok: int) -> bytes:
        if tok < _N_SPECIAL + 256:
            return bytes([tok - _N_SPECIAL])
        a, b = self.merges[tok - _N_SPECIAL - 256]
        return self._bytes_of(a) + self._bytes_of(b)

    # -- persistence (one JSON file: the vocabulary artifact) -----------

    def save(self, path: str) -> None:
        # write-temp-then-rename: concurrent processes polling
        # os.path.exists never observe a partially written vocabulary
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"format": "chainermn_tpu-bpe-v1",
                       "merges": self.merges}, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            d = json.load(f)
        if d.get("format") != "chainermn_tpu-bpe-v1":
            raise ValueError(f"{path}: not a chainermn_tpu BPE file")
        return cls([tuple(m) for m in d["merges"]])


def _split_words(text: str) -> List[bytes]:
    """Whitespace-boundary pre-split (merges never cross words), each
    word carrying its leading space — the byte-level convention that
    makes decode a pure concatenation."""
    words: List[bytes] = []
    cur = bytearray()
    for ch in text.encode("utf-8"):
        if ch in (0x20, 0x0A, 0x09, 0x0D):  # space-ish starts a new word
            if cur:
                words.append(bytes(cur))
            cur = bytearray([ch])
        else:
            cur.append(ch)
    if cur:
        words.append(bytes(cur))
    return words


def train_bpe(corpus: Iterable[str], vocab_size: int,
              max_lines: Optional[int] = None,
              cache_path: Optional[str] = None) -> BPETokenizer:
    """Learn merges from text lines until ``vocab_size`` is reached.

    The original BPE training loop over a word-frequency table: count
    adjacent pairs weighted by word frequency, merge the most frequent,
    repeat. ``vocab_size`` counts specials + 256 byte tokens + merges.
    ``cache_path``: load the vocabulary from this JSON if present, save
    it there after training otherwise (atomic rename — safe against
    concurrent processes sharing the cache).
    """
    if cache_path and os.path.exists(cache_path):
        return BPETokenizer.load(cache_path)
    if vocab_size < _N_SPECIAL + 256:
        raise ValueError(
            f"vocab_size must be >= {_N_SPECIAL + 256} "
            "(specials + byte alphabet)")
    freq: Counter = Counter()
    for ln, line in enumerate(corpus):
        if max_lines is not None and ln >= max_lines:
            break
        for w in _split_words(line):
            freq[w] += 1
    # words as tuples of current token ids
    words: Dict[Tuple[int, ...], int] = {
        tuple(b + _N_SPECIAL for b in w): c for w, c in freq.items()}

    merges: List[Tuple[int, int]] = []
    next_id = _N_SPECIAL + 256
    while next_id < vocab_size:
        pairs: Counter = Counter()
        for w, c in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += c
        if not pairs:
            break
        # deterministic tie-break: max count, then smallest pair ids
        best = min(pairs.items(), key=lambda kv: (-kv[1], kv[0]))[0]
        if pairs[best] < 2:
            break
        merges.append(best)
        new_words: Dict[Tuple[int, ...], int] = {}
        for w, c in words.items():
            out: List[int] = []
            i = 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(next_id)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            t = tuple(out)
            new_words[t] = new_words.get(t, 0) + c
        words = new_words
        next_id += 1
    tok = BPETokenizer(merges)
    if cache_path:
        tok.save(cache_path)
    return tok


def train_bpe_file(path: str, vocab_size: int,
                   cache_path: Optional[str] = None) -> BPETokenizer:
    """Train on a text file, with a JSON vocabulary cache keyed only by
    the caller's chosen path (the reference caches its WMT vocab pickles
    the same way)."""
    if cache_path and os.path.exists(cache_path):
        return BPETokenizer.load(cache_path)
    with open(path, encoding="utf-8") as f:
        return train_bpe(f, vocab_size, cache_path=cache_path)
