"""KVHandoff — the prefill→decode wire codec for disaggregated serving.

Counterpart of ``chainermn_tpu/fleet/handoff.py``: on the same pages the
manifests and blobs are that module's byte for byte, and each decodes
the other's. Two things differ in how the port's engine hands over its
state, and the codec absorbs both:

* the port exports bf16 pages widened to f32 numpy (numpy has no
  bfloat16) and says so in the export dict's ``page_dtype`` key, which
  the encoder consumes and never writes; a bf16 leaf crosses the wire
  as ``bfloat16`` at 2 B an element (the upper 16 bits of each exact
  f32) and decodes back to f32 by a 16-bit shift;
* the port's key row is an int64 ``(seed, counter)`` pair; the key is
  packed in the dtype it arrives in (int64 from the port, uint32 from
  JAX) and the ``arrays`` table declares it, so nothing is lost.

A prefill replica finishes a prompt (``prefill_chunk`` to completion,
first token sampled on device) and must move the populated slot to a
decode replica: per-block KV rows ``[fill, n_kv_heads, d_head]``, the
cursor, the post-sampling PRNG key, the emitted token(s), and the
sampling knobs — exactly what ``Engine.export_handoff`` packages. This
module turns that dict into ``(manifest, blob)`` and back:

* the **blob** is the concatenated C-order bytes of every array — no
  container framing, so wire accounting is exact (``manifest["bytes"]``
  is what actually crosses the interconnect, the number the bench gate
  prices);
* the **manifest** is a JSON-able dict under the same versioned grammar
  as ``serving/weights.py``: ``format`` 1 (raw) or 2 (blockwise
  quantized) for prefill handoffs, 3/4 for decode→decode SESSION
  migrations (same payload grammar plus the remaining ``max_new_tokens``
  budget in ``meta``), ``sha256`` + ``bytes`` over the blob, an
  ``arrays`` table (name/dtype/shape/offset), a ``codec`` block for the
  quantized formats, and the scalar ``meta`` (cursor, tokens, knobs).

Wire formats:

* ``f32`` (format 1) — raw cache bytes. Decode from an imported slot is
  BITWISE the exporting engine continuing; the fleet's raw-format
  streams therefore pin exactly to single-engine ``generate()``.
* ``int8-block`` (format 2) — each KV leaf through the collectives'
  per-256-element blockwise codec (``collectives.quantized``,
  EQuARX): int8 codes + one f32 scale per block, ~0.254× the raw f32
  bytes (``wire_ratio``). Logit error after the handoff is bounded by
  the per-block scale — calibrated in tests/fleet_tests.

When the SOURCE pages are already int8-resident (``kv_dtype=
"int8-block"`` engines, serving/kv_cache.py), the quantized formats
(2/4/5) ship the resident codes and scales VERBATIM — no dequantize →
requantize round trip, so the wire bytes are exactly the page bytes the
source engine was serving from and the handoff adds ZERO quantization
error on top of the at-rest codec. The codec leaf is marked
``resident`` so an int8 destination adopts the codes byte-for-byte
(``pages_q8`` in the decoded dict) while an f32 destination gets the
one inherent dequantization. Raw formats (1/3) from a resident source
dequantize once at encode — the raw wire grammar stays f32 bytes.

Decode REFUSES anything it cannot verify — unknown format, byte-count
mismatch (truncation), digest mismatch (corruption), or a structurally
broken manifest all raise :class:`HandoffError` — so a damaged handoff
becomes a clean re-prefill on the decode pool, never a poisoned slot.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from chainermn_torch.collectives.quantized import (QUANT_BLOCK,
                                                   block_dequantize,
                                                   block_quantize)

__all__ = ["HandoffError", "encode_handoff", "decode_handoff",
           "handoff_payload_bytes", "HANDOFF_FORMAT_RAW",
           "HANDOFF_FORMAT_QUANT", "HANDOFF_FORMAT_SESSION_RAW",
           "HANDOFF_FORMAT_SESSION_QUANT", "HANDOFF_FORMAT_STREAMED",
           "HANDOFF_WIRE_FORMATS", "encode_handoff_streamed",
           "decode_handoff_streamed", "streamed_wire_bytes",
           "streamed_chunk_sid", "streamed_parent_sid",
           "CHUNKS_PER_STREAM"]

HANDOFF_FORMAT_RAW = 1
HANDOFF_FORMAT_QUANT = 2
# decode→decode session migration (Engine.export_session): the same
# array payload plus the remaining-budget meta — a distinct format id
# so a mixed-version fleet REFUSES instead of silently dropping the
# budget (decode_handoff's unknown-format contract)
HANDOFF_FORMAT_SESSION_RAW = 3
HANDOFF_FORMAT_SESSION_QUANT = 4
# chunked/streamed prefill handoff (TACCL/GC3 chunk pipelining applied
# to the handoff path): per-layer KV frames shipped as they are ready
# plus a closing manifest committing to every chunk's digest. A
# monolithic ``decode_handoff`` REFUSES format 5 (it cannot verify a
# blob it only holds a piece of) — use ``decode_handoff_streamed``.
HANDOFF_FORMAT_STREAMED = 5
_ACCEPTED_FORMATS = (HANDOFF_FORMAT_RAW, HANDOFF_FORMAT_QUANT,
                     HANDOFF_FORMAT_SESSION_RAW,
                     HANDOFF_FORMAT_SESSION_QUANT)
_QUANT_FORMATS = (HANDOFF_FORMAT_QUANT, HANDOFF_FORMAT_SESSION_QUANT)
_SESSION_FORMATS = (HANDOFF_FORMAT_SESSION_RAW,
                    HANDOFF_FORMAT_SESSION_QUANT)

#: wire formats encode_handoff accepts (f32 = raw bytes, bitwise)
HANDOFF_WIRE_FORMATS = ("f32", "int8-block")

#: meta keys every manifest must carry (decode validates the set);
#: session formats additionally carry ``max_new_tokens``. The OPTIONAL
#: ``weights_version`` meta (all formats 1–5) stamps which published
#: weights minted the KV rows: importers refuse a mismatch
#: (``Engine.import_handoff`` → ``WeightsVersionSkew``) so a rolling
#: update never mixes model versions inside one stream; manifests
#: without the field (pre-rollout encoders) stay loadable.
_META_KEYS = ("cursor", "tokens", "prompt_len", "eos_id", "temperature",
              "top_k", "seed")


class HandoffError(RuntimeError):
    """The handoff could not be verified/decoded — re-prefill instead."""


_BF16 = "bfloat16"


def _bf16_bits(arr) -> np.ndarray:
    """bfloat16 bit patterns (uint16) of an f32 array, rounded to
    nearest even — for the bf16-exact rows the port exports, the upper
    16 bits of each f32."""
    u = np.ascontiguousarray(arr, np.float32).view(np.uint32)
    return ((u + (((u >> 16) & 1) + 0x7FFF)) >> 16).astype(np.uint16)


def _from_bf16_bits(bits) -> np.ndarray:
    """f32 values of bfloat16 bit patterns (exact: a 16-bit shift)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16
            ).view(np.float32)


def _view(raw: bytes, dtype: str, shape) -> np.ndarray:
    """One ``arrays`` entry's bytes as numpy; ``bfloat16`` leaves come
    back widened to f32 (exact), the form the port's pages import."""
    if dtype == _BF16:
        return _from_bf16_bits(np.frombuffer(raw, np.uint16)).reshape(
            shape)
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)


def _to_torch_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == _BF16 else getattr(torch, name)


class _Packer:
    def __init__(self):
        self.arrays: List[Dict[str, Any]] = []
        self.chunks: List[bytes] = []
        self.offset = 0

    def put(self, name: str, arr, dtype: str = None) -> None:
        """Append one array; ``dtype="bfloat16"`` packs an f32 array's
        bf16 bit patterns and declares the leaf ``bfloat16``."""
        if dtype == _BF16:
            arr = _bf16_bits(arr)
        arr = np.ascontiguousarray(arr)
        raw = arr.tobytes()
        self.arrays.append({"name": name,
                            "dtype": dtype or arr.dtype.name,
                            "shape": list(arr.shape),
                            "offset": self.offset, "nbytes": len(raw)})
        self.chunks.append(raw)
        self.offset += len(raw)


def _key_row(key) -> np.ndarray:
    """The PRNG key row as it arrived (int64 from the port, uint32 from
    JAX): lossless, and the ``arrays`` table names its dtype."""
    key = np.asarray(key)
    if key.dtype.kind not in "iu":
        raise ValueError(f"key row must be integer, got {key.dtype}")
    return key


def _dequant(q, scale, spec: dict, codec: dict, blk: int) -> np.ndarray:
    """One quantized leaf back to numpy in its declared dtype (bf16
    dequantizes in bf16, as the reference codec does, then widens)."""
    dt = spec["dtype"]
    out = block_dequantize(torch.from_numpy(np.array(q)),
                           torch.from_numpy(np.array(scale)),
                           int(spec["size"]), codec["wire_format"],
                           _to_torch_dtype(dt), blk)
    if dt == _BF16:
        out = out.float()
    return out.numpy().reshape(spec["shape"])


def _pack_page(pk: "_Packer", block: str, page: dict, wire_format: str,
               codec_leaves: Dict[str, dict],
               page_dtype: str = None) -> int:
    """Pack one KV block's leaves (shared by the monolithic and
    streamed encoders). Returns the blockwise-codec block size the
    quantized leaves actually use: the at-rest page block for resident
    sources (codes/scales shipped verbatim), else ``QUANT_BLOCK``.
    ``page_dtype="bfloat16"`` marks raw f32 rows widened from bf16
    pages: they ship (and quantize) as bf16."""
    blk = QUANT_BLOCK
    resident = "k_q" in page
    for leaf in ("k", "v"):
        name = f"{block}/{leaf}"
        if resident:
            q = np.ascontiguousarray(np.asarray(page[leaf + "_q"],
                                                np.int8))
            s = np.ascontiguousarray(np.asarray(page[leaf + "_s"],
                                                np.float32))
            blk = q.size // s.size
            if wire_format == "f32":
                # the raw grammar is f32 bytes: the source's ONE
                # inherent dequantization happens at encode
                arr = block_dequantize(
                    torch.from_numpy(q.reshape(-1)),
                    torch.from_numpy(s.reshape(-1)), q.size,
                    "int8-block", torch.float32, blk
                ).numpy().reshape(q.shape)
                pk.put(name, arr)
            else:
                # already quantized at rest: the wire IS the page —
                # codes and scales verbatim, zero extra error
                pk.put(name + "::q", q.reshape(-1))
                pk.put(name + "::scale", s.reshape(-1))
                codec_leaves[name] = {"shape": list(q.shape),
                                      "dtype": "float32",
                                      "size": int(q.size),
                                      "resident": True}
        else:
            arr = np.asarray(page[leaf])
            bf16 = page_dtype == _BF16
            if wire_format == "f32":
                pk.put(name, arr, _BF16 if bf16 else None)
            else:
                # quantized in the page's own dtype, as the reference
                # codec quantizes its bf16 pages (bf16 scales, widened)
                v = torch.from_numpy(np.array(arr).reshape(-1))
                q, s = block_quantize(v.to(torch.bfloat16) if bf16 else v,
                                      wire_format)
                pk.put(name + "::q", q.numpy())
                pk.put(name + "::scale", s.float().numpy())
                codec_leaves[name] = {"shape": list(arr.shape),
                                      "dtype": (_BF16 if bf16
                                                else arr.dtype.name),
                                      "size": int(arr.size)}
    return blk


def encode_handoff(handoff: dict,
                   wire_format: str = "f32") -> Tuple[dict, bytes]:
    """Serialize ``Engine.export_handoff``'s dict. Returns
    ``(manifest, blob)``; the manifest alone decides whether the blob is
    trustworthy at the other end."""
    if wire_format not in HANDOFF_WIRE_FORMATS:
        raise ValueError(
            f"unknown handoff wire_format {wire_format!r} — known: "
            + ", ".join(HANDOFF_WIRE_FORMATS))
    pk = _Packer()
    codec_leaves: Dict[str, dict] = {}
    blk = None
    for block in sorted(handoff["pages"]):
        blk = _pack_page(pk, block, handoff["pages"][block],
                         wire_format, codec_leaves,
                         handoff.get("page_dtype"))
    pk.put("key", _key_row(handoff["key"]))
    blob = b"".join(pk.chunks)
    # a dict carrying max_new_tokens is a decode-session export
    # (Engine.export_session); plain prefill handoffs keep format 1/2
    session = "max_new_tokens" in handoff
    if wire_format == "f32":
        fmt = HANDOFF_FORMAT_SESSION_RAW if session else HANDOFF_FORMAT_RAW
    else:
        fmt = (HANDOFF_FORMAT_SESSION_QUANT if session
               else HANDOFF_FORMAT_QUANT)
    meta = ({k: handoff[k] for k in _META_KEYS if k != "cursor"}
            | {"cursor": int(handoff["cursor"])})
    if session:
        meta["max_new_tokens"] = int(handoff["max_new_tokens"])
    if handoff.get("weights_version") is not None:
        meta["weights_version"] = str(handoff["weights_version"])
    manifest: Dict[str, Any] = {
        "format": fmt,
        "bytes": len(blob),
        "sha256": hashlib.sha256(blob).hexdigest(),
        "arrays": pk.arrays,
        "meta": meta,
    }
    if wire_format != "f32":
        manifest["codec"] = {"wire_format": wire_format,
                             "block": (blk if blk is not None
                                       else QUANT_BLOCK),
                             "leaves": codec_leaves}
    return manifest, blob


def handoff_payload_bytes(manifest: dict) -> int:
    """Exact wire bytes of the encoded handoff (the blob length the
    manifest vouches for — what the bench gate prices)."""
    return int(manifest["bytes"])


def decode_handoff(manifest: dict, blob: bytes) -> dict:
    """Verify + decode back to the ``Engine.import_handoff`` dict.

    Raises :class:`HandoffError` on ANY defect — unknown format, torn
    blob, digest mismatch, or a manifest missing its structure. Callers
    (fleet/pools.py) answer with a clean re-prefill."""
    try:
        fmt = manifest["format"]
        if fmt not in _ACCEPTED_FORMATS:
            raise HandoffError(
                f"unknown handoff manifest format {fmt!r} — accepted: "
                f"{_ACCEPTED_FORMATS}")
        if len(blob) != int(manifest["bytes"]):
            raise HandoffError(
                f"truncated handoff: blob is {len(blob)} bytes, "
                f"manifest says {manifest['bytes']}")
        digest = hashlib.sha256(blob).hexdigest()
        if digest != manifest["sha256"]:
            raise HandoffError("corrupt handoff: sha256 mismatch")
        flat: Dict[str, np.ndarray] = {}
        for ent in manifest["arrays"]:
            raw = blob[ent["offset"]:ent["offset"] + ent["nbytes"]]
            flat[ent["name"]] = _view(raw, ent["dtype"], ent["shape"])
        meta = manifest["meta"]
        pages: Dict[str, Dict[str, np.ndarray]] = {}
        pages_q8: Dict[str, Dict[str, np.ndarray]] = {}
        if fmt not in _QUANT_FORMATS:
            for name, arr in flat.items():
                if name == "key":
                    continue
                block, leaf = name.rsplit("/", 1)
                pages.setdefault(block, {})[leaf] = arr
        else:
            codec = manifest["codec"]
            blk = int(codec.get("block", 256))
            for base, spec in codec["leaves"].items():
                block, leaf = base.rsplit("/", 1)
                pages.setdefault(block, {})[leaf] = _dequant(
                    flat[base + "::q"], flat[base + "::scale"], spec,
                    codec, blk)
                if spec.get("resident"):
                    # verbatim source page bytes: an int8-resident
                    # destination adopts these directly (zero extra
                    # quantization error), f32 destinations use the
                    # dequantized ``pages``
                    shape = list(spec["shape"])
                    pages_q8.setdefault(block, {})[leaf + "_q"] = (
                        flat[base + "::q"].reshape(shape))
                    pages_q8.setdefault(block, {})[leaf + "_s"] = (
                        flat[base + "::scale"].reshape(shape[0], -1))
        out = {
            "pages": pages,
            "cursor": int(meta["cursor"]),
            "tokens": list(meta["tokens"]),
            "key": flat["key"],
            "prompt_len": int(meta["prompt_len"]),
            "eos_id": meta["eos_id"],
            "temperature": meta["temperature"],
            "top_k": meta["top_k"],
            "seed": meta["seed"],
            "weights_version": meta.get("weights_version"),
        }
        if pages_q8:
            out["pages_q8"] = pages_q8
        if fmt in _SESSION_FORMATS:
            # the remaining-budget meta is what MAKES it a session; a
            # session manifest without it is structurally broken
            out["max_new_tokens"] = int(meta["max_new_tokens"])
        return out
    except HandoffError:
        raise
    except Exception as e:   # broken manifest structure → same contract
        raise HandoffError(
            f"undecodable handoff manifest: {type(e).__name__}: {e}"
        ) from e


# -- format 5: streamed (chunked) handoffs --------------------------------

#: chunk stream-id address space per parent stream (a handoff with more
#: KV blocks than this cannot be streamed — encode refuses)
CHUNKS_PER_STREAM = 4096


def streamed_chunk_sid(stream_id: int, index: int) -> int:
    """Transport stream id for chunk ``index`` of ``stream_id``.

    Chunk frames ride the SAME transport protocol as whole handoffs —
    per-frame SHA verify, NACK → bounded re-send, duplicate fencing —
    so each needs its own id. Client stream ids are non-negative
    (``itertools.count``/request ids), so the chunk space is the
    negative integers: collision-free by sign, and invertible."""
    if not 0 <= index < CHUNKS_PER_STREAM:
        raise ValueError(f"chunk index {index} outside "
                         f"[0, {CHUNKS_PER_STREAM})")
    return -(int(stream_id) * CHUNKS_PER_STREAM + index + 1)


def streamed_parent_sid(chunk_sid: int) -> Tuple[int, int]:
    """Invert :func:`streamed_chunk_sid` → ``(stream_id, index)``."""
    if chunk_sid >= 0:
        raise ValueError(f"{chunk_sid} is not a chunk stream id")
    flat = -int(chunk_sid) - 1
    return flat // CHUNKS_PER_STREAM, flat % CHUNKS_PER_STREAM


def encode_handoff_streamed(
        handoff: dict, wire_format: str = "f32",
) -> Tuple[List[Tuple[dict, bytes]], dict, bytes]:
    """Serialize one handoff as independently verifiable per-layer
    frames: returns ``(chunks, closing_manifest, closing_blob)`` where
    ``chunks[i] = (chunk_manifest, chunk_blob)`` carries one KV block's
    leaves and the closing manifest carries the scalar meta, the PRNG
    key, and a ``chunks`` table committing to every chunk's byte count
    and digest — so a receiver can prove it assembled exactly the
    handoff the sender encoded, and a corrupt chunk costs one chunk's
    re-send, not the whole blob's."""
    if wire_format not in HANDOFF_WIRE_FORMATS:
        raise ValueError(
            f"unknown handoff wire_format {wire_format!r} — known: "
            + ", ".join(HANDOFF_WIRE_FORMATS))
    if "max_new_tokens" in handoff:
        raise ValueError("session exports migrate whole (format 3/4); "
                         "streaming is for prefill handoffs")
    blocks = sorted(handoff["pages"])
    if len(blocks) > CHUNKS_PER_STREAM:
        raise ValueError(f"{len(blocks)} KV blocks exceed the streamed "
                         f"chunk space ({CHUNKS_PER_STREAM})")
    chunks: List[Tuple[dict, bytes]] = []
    table: List[Dict[str, Any]] = []
    for i, block in enumerate(blocks):
        pk = _Packer()
        codec_leaves: Dict[str, dict] = {}
        blk = _pack_page(pk, block, handoff["pages"][block],
                         wire_format, codec_leaves,
                         handoff.get("page_dtype"))
        blob = b"".join(pk.chunks)
        digest = hashlib.sha256(blob).hexdigest()
        man: Dict[str, Any] = {
            "format": HANDOFF_FORMAT_STREAMED, "kind": "chunk",
            "layer": block, "index": i,
            "bytes": len(blob), "sha256": digest, "arrays": pk.arrays,
        }
        if wire_format != "f32":
            man["codec"] = {"wire_format": wire_format,
                            "block": blk, "leaves": codec_leaves}
        chunks.append((man, blob))
        table.append({"layer": block, "index": i,
                      "bytes": len(blob), "sha256": digest})
    pk = _Packer()
    pk.put("key", _key_row(handoff["key"]))
    closing_blob = b"".join(pk.chunks)
    meta = ({k: handoff[k] for k in _META_KEYS if k != "cursor"}
            | {"cursor": int(handoff["cursor"])})
    if handoff.get("weights_version") is not None:
        meta["weights_version"] = str(handoff["weights_version"])
    closing: Dict[str, Any] = {
        "format": HANDOFF_FORMAT_STREAMED, "kind": "closing",
        "bytes": len(closing_blob),
        "sha256": hashlib.sha256(closing_blob).hexdigest(),
        "arrays": pk.arrays, "meta": meta, "chunks": table,
        "wire_format": wire_format,
    }
    return chunks, closing, closing_blob


def streamed_wire_bytes(closing_manifest: dict) -> int:
    """Exact wire bytes of the whole streamed handoff: the closing blob
    plus every chunk the closing table commits to (the streamed sibling
    of :func:`handoff_payload_bytes`, same bench-gate pricing role)."""
    return int(closing_manifest["bytes"]) + sum(
        int(c["bytes"]) for c in closing_manifest["chunks"])


def decode_handoff_streamed(closing_manifest: dict, closing_blob: bytes,
                            chunks: List[Tuple[dict, bytes]]) -> dict:
    """Verify + assemble streamed frames back to the
    ``Engine.import_handoff`` dict.

    Every chunk must verify against BOTH its own manifest and the
    closing table's commitment (byte count + digest + layer name) —
    transport-level SHA checks already rejected torn frames, but only
    the closing table proves the SET of chunks is complete and is THIS
    handoff's (a chunk swapped in from another stream has a valid
    self-manifest and still fails the table). Any defect raises
    :class:`HandoffError`: the caller re-prefills, never adopts."""
    try:
        if closing_manifest.get("format") != HANDOFF_FORMAT_STREAMED \
                or closing_manifest.get("kind") != "closing":
            raise HandoffError(
                "not a streamed closing manifest: format="
                f"{closing_manifest.get('format')!r} "
                f"kind={closing_manifest.get('kind')!r}")
        if len(closing_blob) != int(closing_manifest["bytes"]):
            raise HandoffError(
                f"truncated closing frame: {len(closing_blob)} bytes, "
                f"manifest says {closing_manifest['bytes']}")
        if hashlib.sha256(closing_blob).hexdigest() \
                != closing_manifest["sha256"]:
            raise HandoffError("corrupt closing frame: sha256 mismatch")
        table = closing_manifest["chunks"]
        if len(chunks) != len(table):
            raise HandoffError(
                f"incomplete stream: {len(chunks)} chunks arrived, "
                f"closing manifest commits to {len(table)}")
        by_index: Dict[int, Tuple[dict, bytes]] = {}
        for man, blob in chunks:
            if man.get("format") != HANDOFF_FORMAT_STREAMED \
                    or man.get("kind") != "chunk":
                raise HandoffError(
                    f"not a streamed chunk manifest: {man.get('kind')!r}")
            by_index[int(man["index"])] = (man, blob)
        pages: Dict[str, Dict[str, np.ndarray]] = {}
        pages_q8: Dict[str, Dict[str, np.ndarray]] = {}
        for ent in table:
            idx = int(ent["index"])
            if idx not in by_index:
                raise HandoffError(f"missing chunk {idx} "
                                   f"(layer {ent['layer']!r})")
            man, blob = by_index[idx]
            if (man["layer"] != ent["layer"]
                    or len(blob) != int(ent["bytes"])
                    or hashlib.sha256(blob).hexdigest() != ent["sha256"]
                    or man["sha256"] != ent["sha256"]):
                raise HandoffError(
                    f"chunk {idx} (layer {ent['layer']!r}) does not "
                    "match the closing manifest's commitment")
            flat: Dict[str, np.ndarray] = {}
            for a in man["arrays"]:
                raw = blob[a["offset"]:a["offset"] + a["nbytes"]]
                flat[a["name"]] = _view(raw, a["dtype"], a["shape"])
            codec = man.get("codec")
            if codec is None:
                for name, arr in flat.items():
                    block, leaf = name.rsplit("/", 1)
                    pages.setdefault(block, {})[leaf] = arr
            else:
                blk = int(codec.get("block", 256))
                for base, spec in codec["leaves"].items():
                    block, leaf = base.rsplit("/", 1)
                    pages.setdefault(block, {})[leaf] = _dequant(
                        flat[base + "::q"], flat[base + "::scale"], spec,
                        codec, blk)
                    if spec.get("resident"):
                        shape = list(spec["shape"])
                        pages_q8.setdefault(block, {})[leaf + "_q"] = (
                            flat[base + "::q"].reshape(shape))
                        pages_q8.setdefault(block, {})[leaf + "_s"] = (
                            flat[base + "::scale"].reshape(shape[0], -1))
        meta = closing_manifest["meta"]
        key = None
        for a in closing_manifest["arrays"]:
            if a["name"] == "key":
                raw = closing_blob[a["offset"]:a["offset"] + a["nbytes"]]
                key = _view(raw, a["dtype"], a["shape"])
        if key is None:
            raise HandoffError("closing manifest carries no PRNG key")
        out = {
            "pages": pages,
            "cursor": int(meta["cursor"]),
            "tokens": list(meta["tokens"]),
            "key": key,
            "prompt_len": int(meta["prompt_len"]),
            "eos_id": meta["eos_id"],
            "temperature": meta["temperature"],
            "top_k": meta["top_k"],
            "seed": meta["seed"],
            "weights_version": meta.get("weights_version"),
        }
        if pages_q8:
            out["pages_q8"] = pages_q8
        return out
    except HandoffError:
        raise
    except Exception as e:   # broken manifest structure → same contract
        raise HandoffError(
            f"undecodable streamed handoff: {type(e).__name__}: {e}"
        ) from e
