"""The port's KVHandoff codec against the JAX package's.

Mirrors ``tests/fleet_tests/test_handoff.py`` on the port's engine (raw
round trips bitwise, int8-block error within the per-block step, exact
wire bytes, every defect refused with ``HandoffError``, streamed
format-5 chunks, int8-resident pages shipped verbatim), then holds the
two codecs to each other on the same pages: for formats 1-5 and f32,
bf16 and int8-resident pages, the port's manifest and blob are JAX's
byte for byte (bf16 at 2 B an element), and each package decodes the
other's blobs to equal arrays. Tolerances: none for the codec (bytes and
arrays are compared exactly); the int8 logit check is JAX's calibrated
bound, 10 x half the coarsest per-block scale.

Small model (vocab 43, d 32, 1 layer), JAX's parameters converted into
the port's model with the LM head scaled 4x, as the port's serving tests
do.
"""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.fleet import handoff as jh
from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_torch.collectives.quantized import QUANT_BLOCK, block_quantize
from chainermn_torch.fleet.handoff import (CHUNKS_PER_STREAM, HandoffError,
                                           decode_handoff,
                                           decode_handoff_streamed,
                                           encode_handoff,
                                           encode_handoff_streamed,
                                           handoff_payload_bytes,
                                           streamed_chunk_sid,
                                           streamed_parent_sid,
                                           streamed_wire_bytes)
from chainermn_torch.models.convert import params_from_flax
from chainermn_torch.models.transformer import TransformerLM
from chainermn_torch.serving.engine import Engine, EngineConfig

VOCAB = 43
PROMPT_LEN = 8
CFG = dict(vocab=VOCAB, d_model=32, n_heads=4, n_layers=1, d_ff=48,
           max_len=64, attention="reference", pos_emb="rope")


@functools.lru_cache(maxsize=None)
def _setup(seed=0):
    jm = JaxLM(**CFG)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 4.0
    tm = TransformerLM(**CFG, device="cpu")
    tm.load_state_dict(params_from_flax(tm, params))
    return tm


def _cfg(**kw):
    base = dict(n_slots=2, capacity=16, max_new_tokens=6,
                prefill_cohort=1, buckets=[PROMPT_LEN, 16])
    base.update(kw)
    return EngineConfig(**base)


@functools.lru_cache(maxsize=None)
def _handoff(seed=0, temperature=None, top_k=None):
    """Prefill one prompt to its first token and export the held slot."""
    eng = Engine(_setup(), _cfg(), device="cpu")
    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, VOCAB, (PROMPT_LEN,)).astype(np.int32)
    req = eng.submit(prompt, max_new_tokens=1, hold=True,
                     temperature=temperature, top_k=top_k, seed=seed)
    while not eng.held:
        eng.step()  # dlint: disable=DL104
    handoff = eng.export_handoff(req)
    eng.release_held(req)
    assert sorted(eng.free_slots) == [0, 1], "release must free the slot"
    return handoff, prompt


def test_raw_roundtrip_is_bitwise():
    handoff, _prompt = _handoff()
    manifest, blob = encode_handoff(handoff, "f32")
    assert manifest["format"] == 1
    assert handoff_payload_bytes(manifest) == len(blob)
    assert "page_dtype" not in str(manifest)     # consumed, never written
    out = decode_handoff(manifest, blob)
    for blk, page in handoff["pages"].items():
        for leaf in ("k", "v"):
            np.testing.assert_array_equal(page[leaf],
                                          out["pages"][blk][leaf])
    np.testing.assert_array_equal(handoff["key"], out["key"])
    assert out["key"].dtype == np.int64           # the port's key row
    for key in ("cursor", "tokens", "prompt_len", "eos_id",
                "temperature", "top_k", "seed"):
        assert out[key] == handoff[key]


def test_int8_block_error_bounded_by_quant_step():
    """Per element: |kv - deq(q(kv))| <= scale/2 with the PER-BLOCK
    scale."""
    handoff, _prompt = _handoff()
    manifest, blob = encode_handoff(handoff, "int8-block")
    assert manifest["format"] == 2
    assert manifest["codec"]["wire_format"] == "int8-block"
    out = decode_handoff(manifest, blob)
    for blk, page in handoff["pages"].items():
        for leaf in ("k", "v"):
            v = np.asarray(page[leaf], np.float32).reshape(-1)
            _q, s = block_quantize(torch.from_numpy(v), "int8-block")
            step = np.repeat(s.numpy(), QUANT_BLOCK)[:v.size]
            deq = np.asarray(out["pages"][blk][leaf],
                             np.float32).reshape(-1)
            assert (np.abs(deq - v) <= step / 2 + 1e-7).all()


def test_int8_block_logit_error_calibrated():
    """Decoding from an int8 handoff perturbs the next-step logits by no
    more than 10 x half the coarsest per-block scale (JAX's bound)."""
    handoff, prompt = _handoff()
    max_step = 0.0
    for page in handoff["pages"].values():
        for leaf in ("k", "v"):
            v = np.asarray(page[leaf], np.float32).reshape(-1)
            _q, s = block_quantize(torch.from_numpy(v), "int8-block")
            max_step = max(max_step, float(s.max()) / 2)
    logits = {}
    for wf in ("f32", "int8-block"):
        manifest, blob = encode_handoff(handoff, wf)
        eng = Engine(_setup(), _cfg(), device="cpu")
        req = eng.import_handoff(decode_handoff(manifest, blob), prompt)
        eng.step()  # dlint: disable=DL104
        logits[wf] = eng.last_logits[req.slot].copy()
    dlogit = np.abs(logits["int8-block"] - logits["f32"]).max()
    assert 0 < dlogit <= 10 * max_step, (dlogit, max_step)


def test_wire_bytes_exact_and_quantized_ratio():
    """manifest["bytes"] is the exact blob length; with one-block leaves
    the int8-block wire is (256 + 4)/1024 of raw plus the key tail."""
    handoff, _prompt = _handoff()
    m_raw, b_raw = encode_handoff(handoff, "f32")
    m_q, b_q = encode_handoff(handoff, "int8-block")
    key_bytes = np.asarray(handoff["key"]).nbytes
    assert key_bytes == 16                        # int64 (seed, counter)
    page_bytes = sum(np.asarray(p[leaf]).nbytes
                     for p in handoff["pages"].values()
                     for leaf in ("k", "v"))
    assert handoff_payload_bytes(m_raw) == len(b_raw)
    assert len(b_raw) == page_bytes + key_bytes
    assert handoff_payload_bytes(m_q) == len(b_q)
    assert len(b_q) - key_bytes <= 0.27 * page_bytes


def test_unknown_wire_format_rejected_at_encode():
    handoff, _prompt = _handoff()
    with pytest.raises(ValueError, match="wire_format"):
        encode_handoff(handoff, "fp8-exotic")


def test_truncated_blob_refused():
    handoff, _prompt = _handoff()
    manifest, blob = encode_handoff(handoff, "f32")
    with pytest.raises(HandoffError, match="truncated"):
        decode_handoff(manifest, blob[:len(blob) - 16])


def test_corrupted_blob_refused():
    handoff, _prompt = _handoff()
    manifest, blob = encode_handoff(handoff, "f32")
    torn = bytearray(blob)
    torn[100] ^= 0x40
    with pytest.raises(HandoffError, match="sha256"):
        decode_handoff(manifest, bytes(torn))


def test_unknown_manifest_format_refused():
    handoff, _prompt = _handoff()
    manifest, blob = encode_handoff(handoff, "f32")
    with pytest.raises(HandoffError, match="format"):
        decode_handoff(dict(manifest, format=99), blob)


def test_structurally_broken_manifest_refused():
    handoff, _prompt = _handoff()
    manifest, blob = encode_handoff(handoff, "f32")
    for broken in (
            {k: v for k, v in manifest.items() if k != "arrays"},
            {k: v for k, v in manifest.items() if k != "meta"},
            {k: v for k, v in manifest.items() if k != "sha256"},
    ):
        with pytest.raises(HandoffError):
            decode_handoff(broken, blob)


def test_sampled_handoff_preserves_key_and_knobs():
    """A sampled handoff carries the CONTINUED key (one draw consumed
    for the prefill token) and the knobs verbatim."""
    from chainermn_torch.serving.sampling import request_key

    handoff, _prompt = _handoff(seed=3, temperature=0.8, top_k=5)
    manifest, blob = encode_handoff(handoff, "f32")
    out = decode_handoff(manifest, blob)
    assert out["temperature"] == 0.8 and out["top_k"] == 5
    assert out["seed"] == 3
    fresh = request_key(3, torch.device("cpu")).numpy()
    assert not np.array_equal(out["key"], fresh)


# ---------------------------------------------------------------------------
# Streamed (format-5) handoffs
# ---------------------------------------------------------------------------


def _multi_handoff(n_blocks=3, seed=7):
    rng = np.random.RandomState(seed)
    pages = {f"block{i}": {
        "k": rng.rand(8, 2, 4).astype(np.float32),
        "v": rng.rand(8, 2, 4).astype(np.float32)} for i in range(n_blocks)}
    return {"pages": pages, "cursor": 8, "tokens": [1, 2],
            "key": np.asarray([3, 4], np.int64), "prompt_len": 8,
            "eos_id": None, "temperature": None, "top_k": None, "seed": 0}


def test_streamed_chunk_sid_roundtrips_and_bounds():
    assert streamed_parent_sid(streamed_chunk_sid(17, 3)) == (17, 3)
    assert streamed_chunk_sid(0, 0) == -1
    assert streamed_chunk_sid(17, 3) == jh.streamed_chunk_sid(17, 3)
    with pytest.raises(ValueError):
        streamed_chunk_sid(1, CHUNKS_PER_STREAM)
    with pytest.raises(ValueError):
        streamed_parent_sid(5)


def test_streamed_roundtrip_is_bitwise_one_chunk_per_block():
    handoff = _multi_handoff()
    chunks, closing, closing_blob = encode_handoff_streamed(handoff, "f32")
    assert len(chunks) == 3 and closing["kind"] == "closing"
    out = decode_handoff_streamed(closing, closing_blob, chunks)
    for block in handoff["pages"]:
        for leaf in ("k", "v"):
            np.testing.assert_array_equal(out["pages"][block][leaf],
                                          handoff["pages"][block][leaf])
    assert out["tokens"] == handoff["tokens"]
    np.testing.assert_array_equal(out["key"], handoff["key"])


def test_streamed_wire_bytes_equal_monolithic_blob():
    handoff = _multi_handoff()
    _manifest, blob = encode_handoff(handoff, "f32")
    _chunks, closing, _cb = encode_handoff_streamed(handoff, "f32")
    assert streamed_wire_bytes(closing) == len(blob)


def test_streamed_int8_roundtrip_error_bounded():
    handoff = _multi_handoff()
    chunks, closing, closing_blob = encode_handoff_streamed(
        handoff, "int8-block")
    out = decode_handoff_streamed(closing, closing_blob, chunks)
    for block in handoff["pages"]:
        for leaf in ("k", "v"):
            ref = handoff["pages"][block][leaf]
            step = np.abs(ref).max() / 127.0
            assert np.abs(out["pages"][block][leaf] - ref).max() \
                <= step + 1e-7


def test_streamed_corrupt_chunk_refused_naming_the_chunk():
    chunks, closing, closing_blob = encode_handoff_streamed(
        _multi_handoff(), "f32")
    man, blob = chunks[1]
    chunks[1] = (man, blob[:10] + bytes([blob[10] ^ 0xFF]) + blob[11:])
    with pytest.raises(HandoffError, match="chunk 1"):
        decode_handoff_streamed(closing, closing_blob, chunks)


def test_streamed_missing_chunk_refused():
    chunks, closing, closing_blob = encode_handoff_streamed(
        _multi_handoff(), "f32")
    with pytest.raises(HandoffError, match="incomplete stream"):
        decode_handoff_streamed(closing, closing_blob, chunks[:-1])


def test_streamed_chunk_swapped_from_another_stream_refused():
    chunks, closing, closing_blob = encode_handoff_streamed(
        _multi_handoff(seed=7), "f32")
    other, _c2, _b2 = encode_handoff_streamed(_multi_handoff(seed=8), "f32")
    chunks[0] = other[0]
    with pytest.raises(HandoffError, match="chunk 0"):
        decode_handoff_streamed(closing, closing_blob, chunks)


def test_streamed_refuses_session_exports():
    handoff = _multi_handoff()
    handoff["max_new_tokens"] = 5
    with pytest.raises(ValueError, match="migrate whole"):
        encode_handoff_streamed(handoff, "f32")


# ---------------------------------------------------------------------------
# int8-resident sources ship their codes and scales verbatim
# ---------------------------------------------------------------------------

_RESIDENT_CFG = dict(n_slots=1, capacity=32, max_new_tokens=10,
                     prefill_cohort=1, buckets=[8, 32],
                     kv_dtype="int8-block")
_RESIDENT_LEAVES = ("k_q", "k_s", "v_q", "v_s")


@functools.lru_cache(maxsize=None)
def _resident_handoff(seed=0):
    eng = Engine(_setup(), EngineConfig(**_RESIDENT_CFG), device="cpu")
    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, VOCAB, (5,)).astype(np.int32)
    req = eng.submit(prompt, max_new_tokens=4, temperature=0.8, top_k=6,
                     seed=3, hold=True)
    eng.run_until_drained()
    handoff = eng.export_handoff(req)
    eng.release_held(req)
    return handoff, prompt


def test_resident_wire_bytes_are_verbatim():
    handoff, _prompt = _resident_handoff()
    manifest, blob = encode_handoff(handoff, "int8-block")
    resident = b"".join(
        np.ascontiguousarray(handoff["pages"][b][leaf]).tobytes()
        for b in sorted(handoff["pages"]) for leaf in _RESIDENT_LEAVES)
    key_tail = np.ascontiguousarray(handoff["key"]).tobytes()
    assert blob == resident + key_tail
    some_page = next(iter(handoff["pages"].values()))
    assert manifest["codec"]["block"] == (some_page["k_q"].size
                                          // some_page["k_s"].size)


def test_resident_pages_q8_roundtrip_bitwise():
    handoff, _prompt = _resident_handoff()
    out = decode_handoff(*encode_handoff(handoff, "int8-block"))
    assert "pages_q8" in out
    for blk in out["pages_q8"]:
        for leaf in _RESIDENT_LEAVES:
            np.testing.assert_array_equal(out["pages_q8"][blk][leaf],
                                          handoff["pages"][blk][leaf])


def test_resident_adoption_continues_bitwise():
    handoff, prompt = _resident_handoff()
    manifest, blob = encode_handoff(handoff, "int8-block")
    cfg = EngineConfig(**_RESIDENT_CFG)
    dst = Engine(_setup(), cfg, device="cpu")
    adopted = dst.import_handoff(decode_handoff(manifest, blob), prompt,
                                 max_new_tokens=8)
    dst.run_until_drained()
    ref_eng = Engine(_setup(), cfg, device="cpu")
    ref = ref_eng.submit(prompt, max_new_tokens=8, temperature=0.8,
                         top_k=6, seed=3)
    ref_eng.run_until_drained()
    assert adopted.tokens == ref.tokens


def test_raw_format_from_resident_source_dequantizes_once():
    handoff, _prompt = _resident_handoff()
    raw = decode_handoff(*encode_handoff(handoff, "f32"))
    assert "pages_q8" not in raw
    quant = decode_handoff(*encode_handoff(handoff, "int8-block"))
    for blk in handoff["pages"]:
        for leaf in ("k", "v"):
            np.testing.assert_array_equal(raw["pages"][blk][leaf],
                                          quant["pages"][blk][leaf])


def test_streamed_resident_roundtrip_bitwise():
    handoff, _prompt = _resident_handoff()
    chunks, closing, closing_blob = encode_handoff_streamed(
        handoff, "int8-block")
    out = decode_handoff_streamed(closing, closing_blob, chunks)
    for blk in out["pages_q8"]:
        for leaf in _RESIDENT_LEAVES:
            np.testing.assert_array_equal(out["pages_q8"][blk][leaf],
                                          handoff["pages"][blk][leaf])


def test_f32_source_wire_is_unchanged_by_resident_support():
    handoff, _prompt = _handoff()
    manifest, blob = encode_handoff(handoff, "int8-block")
    assert manifest["codec"]["block"] == QUANT_BLOCK
    assert "pages_q8" not in decode_handoff(manifest, blob)


# ---------------------------------------------------------------------------
# the port's codec IS the JAX package's: same pages, same bytes
# ---------------------------------------------------------------------------


def _bf16(a):
    """f32 values rounded to bf16, widened back (exact)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _pair(kind, seed=0, n_blocks=2, fill=24):
    """The same pages as JAX's engine holds them and as the port's
    exports them: (jax_handoff, port_handoff). ``kind`` is f32, bf16 (JAX
    bf16 leaves; the port's f32 widening plus ``page_dtype``) or int8
    (resident codes and scales, one 16-element block a row)."""
    rng = np.random.RandomState(seed)
    jp, tp = {}, {}
    for i in range(n_blocks):
        name = f"block_{i}"
        if kind == "int8":
            leaves = {}
            for kv in ("k", "v"):
                leaves[kv + "_q"] = rng.randint(
                    -127, 128, (fill, 2, 8)).astype(np.int8)
                leaves[kv + "_s"] = (rng.rand(fill, 1) / 50 + 1e-3
                                     ).astype(np.float32)
            jp[name] = tp[name] = leaves
        else:
            vals = {kv: (rng.standard_normal((fill, 2, 8)) * 3
                         ).astype(np.float32) for kv in ("k", "v")}
            if kind == "bf16":
                tp[name] = {kv: _bf16(v) for kv, v in vals.items()}
                jp[name] = {kv: np.asarray(jnp.asarray(v, jnp.bfloat16))
                            for kv, v in tp[name].items()}
            else:
                jp[name] = tp[name] = vals
    meta = dict(cursor=fill, tokens=[5, 9], prompt_len=fill - 1,
                eos_id=None, temperature=0.7, top_k=3, seed=11,
                weights_version="v1",
                key=np.asarray([11, 2], np.uint32))
    port = dict(meta, pages=tp)
    if kind == "bf16":
        port["page_dtype"] = "bfloat16"
    return dict(meta, pages=jp), port


_FORMATS = [(1, "f32", False), (2, "int8-block", False),
            (3, "f32", True), (4, "int8-block", True)]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("fmt,wire,session", _FORMATS,
                         ids=[f"format{f}" for f, _w, _s in _FORMATS])
def test_manifest_and_blob_are_jaxs_byte_for_byte(kind, fmt, wire, session):
    jhand, thand = _pair(kind)
    if session:
        jhand["max_new_tokens"] = thand["max_new_tokens"] = 12
    jm, jb = jh.encode_handoff(jhand, wire)
    tm, tb = encode_handoff(thand, wire)
    assert tm["format"] == fmt
    assert tm == jm
    assert tb == jb
    if kind == "bf16":
        dtypes = {a["dtype"] for a in tm["arrays"] if a["name"] != "key"}
        assert dtypes == ({"bfloat16"} if wire == "f32"
                          else {"int8", "float32"})
        if wire == "f32":                 # 2 B an element on the wire
            assert all(a["nbytes"] == 2 * int(np.prod(a["shape"]))
                       for a in tm["arrays"] if a["name"] != "key")


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("wire", ["f32", "int8-block"])
def test_streamed_frames_are_jaxs_byte_for_byte(kind, wire):
    jhand, thand = _pair(kind)
    jchunks, jclose, jcb = jh.encode_handoff_streamed(jhand, wire)
    tchunks, tclose, tcb = encode_handoff_streamed(thand, wire)
    assert tclose == jclose and tcb == jcb
    assert len(tchunks) == len(jchunks) == 2
    for (a, ab), (b, bb) in zip(tchunks, jchunks):
        assert a == b and ab == bb
    assert streamed_wire_bytes(tclose) == jh.streamed_wire_bytes(jclose)


def _assert_same_decoded(a, b):
    assert sorted(a["pages"]) == sorted(b["pages"])
    for blk in a["pages"]:
        for leaf in ("k", "v"):
            np.testing.assert_array_equal(
                np.asarray(a["pages"][blk][leaf], np.float32),
                np.asarray(b["pages"][blk][leaf], np.float32))
    assert ("pages_q8" in a) == ("pages_q8" in b)
    for blk in a.get("pages_q8", {}):
        for leaf in _RESIDENT_LEAVES:
            np.testing.assert_array_equal(a["pages_q8"][blk][leaf],
                                          b["pages_q8"][blk][leaf])
    assert np.asarray(a["key"]).tolist() == np.asarray(b["key"]).tolist()
    for k in ("cursor", "tokens", "prompt_len", "eos_id", "temperature",
              "top_k", "seed", "weights_version", "max_new_tokens"):
        assert a.get(k) == b.get(k), k


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("wire", ["f32", "int8-block"])
def test_each_package_decodes_the_others_blobs(kind, wire):
    jhand, thand = _pair(kind, seed=3)
    thand["key"] = np.asarray([11, 2], np.int64)     # the port's own row
    jm, jb = jh.encode_handoff(jhand, wire)
    tm, tb = encode_handoff(thand, wire)
    _assert_same_decoded(decode_handoff(jm, jb), jh.decode_handoff(jm, jb))
    _assert_same_decoded(jh.decode_handoff(tm, tb), decode_handoff(tm, tb))
    _assert_same_decoded(decode_handoff(jm, jb), decode_handoff(tm, tb))
    jc, jcl, jcb = jh.encode_handoff_streamed(jhand, wire)
    tc, tcl, tcb = encode_handoff_streamed(thand, wire)
    _assert_same_decoded(decode_handoff_streamed(jcl, jcb, jc),
                         jh.decode_handoff_streamed(tcl, tcb, tc))


def test_jaxs_refusals_are_the_ports():
    """Every defect JAX's decoder refuses, the port's refuses too."""
    jhand, thand = _pair("bf16")
    manifest, blob = jh.encode_handoff(jhand, "f32")
    cases = [(manifest, blob[:-3]),
             (manifest, blob[:5] + bytes([blob[5] ^ 1]) + blob[6:]),
             (dict(manifest, format=7), blob),
             ({k: v for k, v in manifest.items() if k != "arrays"}, blob),
             (dict(manifest, format=5), blob)]
    for man, bl in cases:
        with pytest.raises(jh.HandoffError):
            jh.decode_handoff(man, bl)
        with pytest.raises(HandoffError):
            decode_handoff(man, bl)
    chunks, closing, cb = jh.encode_handoff_streamed(jhand, "int8-block")
    other = jh.encode_handoff_streamed(_pair("bf16", seed=9)[0],
                                       "int8-block")[0]
    defects = [(closing, cb, chunks[:1]),
               (closing, cb, [other[0], chunks[1]]),
               (closing, cb[:-1], chunks),
               (dict(closing, kind="chunk"), cb, chunks)]
    for cl, b, ch in defects:
        with pytest.raises(jh.HandoffError):
            jh.decode_handoff_streamed(cl, b, ch)
        with pytest.raises(HandoffError):
            decode_handoff_streamed(cl, b, ch)


def test_a_bf16_engine_exports_bf16_leaves_at_jaxs_width():
    """The port's bf16-page engine widens rows to f32 on export; on the
    wire they are bf16 again, JAX's bytes for JAX's bf16 pages."""
    model = TransformerLM(**CFG, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(_setup().state_dict())
    eng = Engine(model, _cfg(), device="cpu")
    prompt = np.arange(PROMPT_LEN, dtype=np.int32) % VOCAB
    req = eng.submit(prompt, max_new_tokens=1, hold=True)
    eng.run_until_drained()
    handoff = eng.export_handoff(req)
    assert handoff["page_dtype"] == "bfloat16"
    manifest, blob = encode_handoff(handoff, "f32")
    pages = handoff["pages"]
    elems = sum(pages[b][kv].size for b in pages for kv in ("k", "v"))
    assert manifest["bytes"] == 2 * elems + 16
    jpages = {b: {kv: np.asarray(jnp.asarray(pages[b][kv], jnp.bfloat16))
                  for kv in ("k", "v")} for b in pages}
    # JAX packs its key row as uint32: hand both the same row to compare
    key32 = handoff["key"].astype(np.uint32)
    jhand = {k: v for k, v in handoff.items() if k != "page_dtype"}
    jm, jb = jh.encode_handoff(dict(jhand, pages=jpages, key=key32), "f32")
    assert encode_handoff(dict(handoff, key=key32), "f32") == (jm, jb)
    back = decode_handoff(manifest, blob)
    for b in pages:
        for kv in ("k", "v"):
            np.testing.assert_array_equal(back["pages"][b][kv],
                                          pages[b][kv])
