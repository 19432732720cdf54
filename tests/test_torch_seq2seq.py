"""The port's seq2seq model (config #4) and BPE tokenizer against the JAX
package's.

The same numpy inputs (made from seeds) and the JAX model's parameters
(converted by ``seq2seq_params_from_flax``) go through the JAX
``Seq2Seq`` and the port's. Tolerances: logits and gradients within
1e-4 relative L2 (f32 LSTM recurrences of up to 32 steps, summed in
other orders; measured ~4e-7); the loss within 1e-6 relative (the same
f32 cross entropy, reduced in another order), its mask exactly;
``pad_batch``, ``corpus_bleu``, ``strip_special``, the decoded tokens and
the tokenizer exactly.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.datasets import bpe as jbpe
from chainermn_tpu.models import seq2seq as js
from chainermn_torch.datasets import bpe as tbpe
from chainermn_torch.models import seq2seq as ts
from chainermn_torch.models.convert import seq2seq_params_from_flax

TOL_REL_L2 = 1e-4
TOL_LOSS = 1e-6


def _rel_l2(got, want):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want))
                 / np.linalg.norm(np.asarray(want)))


def models(layers=2, units=16, src_vocab=20, tgt_vocab=23, seed=0,
           ts_len=32, tt_len=32):
    """The JAX model with its parameters, the port's with them loaded,
    and inputs: 5 rows, source lengths 32 (full), 0, 1, 17 and 9."""
    jm = js.Seq2Seq(n_layers=layers, n_units=units, src_vocab=src_vocab,
                    tgt_vocab=tgt_vocab)
    rs = np.random.RandomState(seed)
    src = rs.randint(3, src_vocab, (5, ts_len)).astype(np.int32)
    src_len = np.array([ts_len, 0, 1, 17, 9], np.int32)
    tgt_in = rs.randint(3, tgt_vocab, (5, tt_len)).astype(np.int32)
    tgt_out = rs.randint(0, tgt_vocab, (5, tt_len)).astype(np.int32)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(src),
                        jnp.asarray(src_len), jnp.asarray(tgt_in))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm = ts.Seq2Seq(n_layers=layers, n_units=units, src_vocab=src_vocab,
                    tgt_vocab=tgt_vocab, device="cpu")
    tm.load_state_dict(seq2seq_params_from_flax(variables["params"]))
    return jm, variables, tm, (src, src_len, tgt_in, tgt_out)


@pytest.mark.parametrize("layers", [1, 2])
def test_logits_match_the_jax_model(layers):
    jm, v, tm, (src, src_len, tgt_in, _) = models(layers=layers)
    want = np.asarray(jm.apply(v, src, src_len, tgt_in))
    got = tm(torch.from_numpy(src), torch.from_numpy(src_len),
             torch.from_numpy(tgt_in)).detach().numpy()
    assert got.shape == want.shape
    assert _rel_l2(got, want) <= TOL_REL_L2
    for row in range(5):        # full-length, empty and short rows alike
        assert _rel_l2(got[row], want[row]) <= TOL_REL_L2


def test_encoder_carries_match_including_empty_and_full_rows():
    """flax reads a row's carry at index len - 1: the last valid step,
    and for an empty row the end of its padded row."""
    jm, v, tm, (src, src_len, _, _) = models()
    want = jm.apply(v, src, src_len, method=js.Seq2Seq.encode)
    h, c = tm.encode(src, src_len)
    for k, (jc, jh) in enumerate(want):
        assert _rel_l2(h[k].detach(), jh) <= TOL_REL_L2
        assert _rel_l2(c[k].detach(), jc) <= TOL_REL_L2


def test_gradients_match_the_jax_model():
    jm, v, tm, (src, src_len, tgt_in, tgt_out) = models()

    def loss(p):
        logits = jm.apply({"params": p}, src, src_len, tgt_in)
        return js.seq2seq_loss(logits, tgt_out)[0]

    jl, jg = jax.value_and_grad(loss)(v["params"])
    want = seq2seq_params_from_flax(jax.tree_util.tree_map(np.asarray, jg))
    tl, _ = ts.seq2seq_loss(tm(src, src_len, tgt_in), tgt_out)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=TOL_LOSS)
    grads = dict(tm.named_parameters())
    for name, w in want.items():
        if name.startswith(("encoder.bias_ih", "decoder.bias_ih")):
            # flax has one gate bias, bias_hh's: torch's other stays
            # zero and frozen
            assert grads[name].grad is None and not grads[name].any()
            continue
        assert _rel_l2(grads[name].grad, w) <= TOL_REL_L2, name


def test_seq2seq_loss_and_mask():
    rs = np.random.RandomState(3)
    logits = rs.randn(4, 7, 11).astype(np.float32)
    tgt = rs.randint(0, 11, (4, 7)).astype(np.int32)
    tgt[0] = 0                                    # an all-pad row
    jl, jm = js.seq2seq_loss(jnp.asarray(logits), jnp.asarray(tgt))
    tl, tm = ts.seq2seq_loss(torch.from_numpy(logits), tgt)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL_LOSS)
    zl, _ = ts.seq2seq_loss(torch.from_numpy(logits), np.zeros_like(tgt))
    assert float(zl) == float(js.seq2seq_loss(
        jnp.asarray(logits), jnp.zeros_like(jnp.asarray(tgt)))[0]) == 0.0


@pytest.mark.parametrize("multiple,max_len", [(16, 512), (4, 10), (1, 512)])
def test_pad_batch_is_the_jax_modules(multiple, max_len):
    rs = np.random.RandomState(4)
    pairs = [(rs.randint(3, 50, rs.randint(1, 15)),
              rs.randint(3, 50, rs.randint(1, 15))) for _ in range(6)]
    for got, want in zip(ts.pad_batch(pairs, multiple, max_len),
                         js.pad_batch(pairs, multiple, max_len)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_corpus_bleu_and_strip_special_are_the_jax_modules():
    rs = np.random.RandomState(5)
    refs = [list(rs.randint(3, 9, rs.randint(4, 12))) for _ in range(8)]
    hyps = [list(r[:-1]) + list(rs.randint(3, 9, 2)) for r in refs]
    assert ts.corpus_bleu(refs, hyps) == js.corpus_bleu(refs, hyps) > 0
    assert ts.corpus_bleu(refs, refs) == js.corpus_bleu(refs, refs) == 1.0
    assert ts.corpus_bleu(refs, [[3]] * 8) == js.corpus_bleu(
        refs, [[3]] * 8) == 0.0
    for row in ([1, 5, 0, 6, 2, 7], [5, 6, 7], [2, 5], [0, 0, 1]):
        assert ts.strip_special(np.array(row)) == js.strip_special(
            np.array(row))


@pytest.mark.parametrize("beam", [0, 1, 3])
def test_decoded_tokens_equal_the_jax_modules(beam):
    jm, v, tm, (src, src_len, _, _) = models(units=16, tgt_vocab=23)
    if beam == 0:
        want = js.greedy_translate(jm, v, src, src_len, max_len=12)
        got = ts.greedy_translate(tm, src, src_len, max_len=12)
    else:
        want = js.beam_translate(jm, v, src, src_len, beam=beam,
                                 max_len=12)
        got = ts.beam_translate(tm, src, src_len, beam=beam, max_len=12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tied(variables, a: int, b: int):
    """The projection with token ``b``'s column and bias set to token
    ``a``'s and raised above the rest: every step's top two logits are
    an exact tie between a < b."""
    p = jax.tree_util.tree_map(np.copy, variables)
    proj = p["params"]["proj"]
    proj["kernel"][:, b] = proj["kernel"][:, a]
    proj["bias"][a] = proj["bias"][b] = 50.0
    return p


@pytest.mark.parametrize("beam", [0, 1, 2, 4])
def test_ties_go_to_the_lower_token_as_in_jax(beam):
    """``jax.lax.top_k`` and ``argmax`` keep the lower index first on an
    exact tie; the port's decoders must choose the same tokens."""
    jm, v, tm, (src, src_len, _, _) = models(units=16, tgt_vocab=23)
    v = _tied(v, 5, 9)
    tm.load_state_dict(seq2seq_params_from_flax(v["params"]))
    logits = tm.decode_step(tm.encode(src, src_len),
                            torch.ones(5, dtype=torch.long))[1]
    assert torch.equal(logits[:, 5], logits[:, 9])
    assert (logits.argmax(-1) == 5).all()
    if beam == 0:
        want = js.greedy_translate(jm, v, src, src_len, max_len=6)
        got = ts.greedy_translate(tm, src, src_len, max_len=6)
    else:
        want = js.beam_translate(jm, v, src, src_len, beam=beam, max_len=6)
        got = ts.beam_translate(tm, src, src_len, beam=beam, max_len=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != 9).all()


def test_top_k_keeps_the_lower_index_first_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = ts._top_k(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def _corpus(tmp_path):
    """A parallel text written the way examples/seq2seq/make_corpus.py
    writes one (pseudo-words, reversed and mapped)."""
    rs = np.random.RandomState(0)
    words = ["".join("bdgkmst"[rs.randint(7)] + "aeiou"[rs.randint(5)]
                     for _ in range(rs.randint(2, 4))) for _ in range(40)]
    perm = rs.permutation(40)
    src, tgt = [], []
    for _ in range(120):
        idx = rs.randint(0, 40, rs.randint(3, 9))
        src.append(" ".join(words[i] for i in idx))
        tgt.append(" ".join(words[perm[i]] for i in idx[::-1]))
    (tmp_path / "c.src").write_text("\n".join(src) + "\n")
    (tmp_path / "c.tgt").write_text("\n".join(tgt) + "\n")
    return src + tgt + ["naïve café — 日本 ✓"]


def test_bpe_training_and_codec_equal_the_jax_modules(tmp_path):
    lines = _corpus(tmp_path)
    jt = jbpe.train_bpe(lines, 400)
    tt = tbpe.train_bpe(lines, 400)
    assert tt.merges == jt.merges and tt.vocab_size == jt.vocab_size
    for line in lines:
        ids = tt.encode(line, bos=True, eos=True)
        assert ids == jt.encode(line, bos=True, eos=True)
        assert tt.decode(ids) == jt.decode(ids) == line
    assert tbpe.train_bpe(lines, 300, max_lines=50).merges == \
        jbpe.train_bpe(lines, 300, max_lines=50).merges
    with pytest.raises(ValueError):
        tbpe.train_bpe(lines, 100)


def test_bpe_files_load_across_the_packages(tmp_path):
    _corpus(tmp_path)
    src = str(tmp_path / "c.src")
    tt = tbpe.train_bpe_file(src, 350, cache_path=str(tmp_path / "t.json"))
    jt = jbpe.train_bpe_file(src, 350, cache_path=str(tmp_path / "j.json"))
    assert tt.merges == jt.merges
    assert jbpe.BPETokenizer.load(str(tmp_path / "t.json")).merges == \
        tt.merges
    assert tbpe.BPETokenizer.load(str(tmp_path / "j.json")).merges == \
        jt.merges
    # the cache answers without training again
    cached = tbpe.train_bpe_file("missing-file", 999,
                                 cache_path=str(tmp_path / "t.json"))
    assert cached.merges == tt.merges
    (tmp_path / "bad.json").write_text('{"format": "other"}')
    with pytest.raises(ValueError):
        tbpe.BPETokenizer.load(str(tmp_path / "bad.json"))


def test_bpe_vocabulary_layout():
    tok = tbpe.train_bpe(["aaaa bbbb aaaa"], 262)
    assert (tbpe.PAD, tbpe.BOS, tbpe.EOS) == (0, 1, 2)
    assert tok.vocab_size == 262 and len(tok.merges) == 3
    assert list(itertools.islice(tok.encode("a"), 1)) == [ord("a") + 3]
