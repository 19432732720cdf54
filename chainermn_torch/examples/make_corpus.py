"""Write a local parallel text corpus (``OUT.src`` / ``OUT.tgt``, one
sentence per line) for ``train_seq2seq --src-file/--tgt-file``.

Counterpart of the JAX package's ``examples/seq2seq/make_corpus.py``,
with its flags; at the same seed and sizes the files are byte for byte
the same. The content is a pseudo-word language whose "translation"
reverses the word order and maps each word through a fixed permutation
(structure a seq2seq model can learn); the files are plain parallel
text::

    python -m chainermn_torch.examples.make_corpus OUT [--lines 2000]
        [--words 200] [--max-len 12] [--seed 0]
"""

import argparse

import numpy as np

CONSONANTS = "bcdfghjklmnprstvz"
VOWELS = "aeiou"


def word(rng):
    """One pseudo-word of 2-4 consonant-vowel syllables."""
    n = rng.randint(2, 5)
    return "".join(
        CONSONANTS[rng.randint(len(CONSONANTS))]
        + VOWELS[rng.randint(len(VOWELS))]
        for _ in range(n))


def write_corpus(out: str, lines: int = 2000, words: int = 200,
                 max_len: int = 12, seed: int = 0) -> None:
    """Write ``out.src`` and ``out.tgt``: ``lines`` sentences of 3 to
    ``max_len`` words over a vocabulary of ``words`` pseudo-words."""
    rng = np.random.RandomState(seed)
    src_words, seen = [], set()
    while len(src_words) < words:
        w = word(rng)
        if w not in seen:
            seen.add(w)
            src_words.append(w)
    # the word-level "translation": a fixed permutation
    perm = rng.permutation(words)
    tgt_of = {src_words[i]: src_words[perm[i]] for i in range(words)}
    with open(out + ".src", "w") as fs, open(out + ".tgt", "w") as ft:
        for _ in range(lines):
            n = rng.randint(3, max_len + 1)
            ws = [src_words[rng.randint(words)] for _ in range(n)]
            fs.write(" ".join(ws) + "\n")
            ft.write(" ".join(tgt_of[w] for w in reversed(ws)) + "\n")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("out")
    p.add_argument("--lines", type=int, default=2000)
    p.add_argument("--words", type=int, default=200,
                   help="source vocabulary size (pseudo-words)")
    p.add_argument("--max-len", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    write_corpus(args.out, args.lines, args.words, args.max_len, args.seed)
    print(f"wrote {args.lines} parallel lines to "
          f"{args.out}.src / {args.out}.tgt")


if __name__ == "__main__":
    main()
