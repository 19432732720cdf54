"""Warm-weight plane for serving replicas.

Counterpart of ``chainermn_tpu/serving/weights.py``, over a model's
state dict (or any nested dict of tensors and arrays) instead of a flax
pytree, with the same files:

* ``publish_weights`` — atomic publish (tmp + fsync + rename) of the
  weights plus a ``{"format": 1, "sha256", "bytes"}`` manifest sidecar,
  the checkpoint plane's manifest grammar. ``wire_format='int8-block' |
  'int4-block'`` stores each large float leaf as ``<key>::q`` codes and
  ``<key>::scale`` per-256-element scales through the quantized
  collectives' codec (``collectives.quantized.block_quantize``, whose
  codes are the JAX package's bit for bit); the manifest (format 2)
  records the codec and each leaf's shape/dtype, and ``load_weights``
  dequantizes transparently.
* ``load_weights`` — manifest-verified load; a corrupt or torn file is
  REFUSED (never half-loaded into a serving process), and candidates
  are tried newest-first across the primary path and any replica
  directories (``<dir>/replicas/*``), so losing the local disk still
  warm-starts from a peer.
* ``pull_weights`` — fetch the weights from a live peer over the
  communicator's object plane (``bcast_obj``).
* ``encode_weights`` / ``decode_weights`` — the diskless wire form of
  the same (manifest, payload) pair.
* ``load_snapshot_weights`` — warm-reload from the newest verified
  training snapshot that ``extensions.checkpoint.MultiNodeCheckpointer``
  or ``checkpointing.AsyncSnapshotPlane`` published (same manifest
  grammar; ``leaf_{i}`` arrays in the checkpointer's leaf order, bf16 as
  its raw bits).

Keys are the flattened paths joined by ``/`` (a state dict's own dotted
names are one level), so a file the JAX package published from a flax
tree loads here as a flat ``{path: array}`` dict. bf16 tensors are
written as f32 (numpy has no bf16; the widening is exact).
"""

from __future__ import annotations

import glob
import hashlib
import io
import json
import os
import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["publish_weights", "load_weights", "pull_weights",
           "weight_candidates", "load_snapshot_weights",
           "snapshot_candidates", "encode_weights", "decode_weights",
           "WeightsError"]

_MANIFEST_FORMAT = 1
#: format 2 = blockwise-quantized payload; the manifest's ``codec`` key
#: records wire_format/block plus per-leaf shape/dtype/size
_MANIFEST_FORMAT_QUANT = 2
_ACCEPTED_FORMATS = (_MANIFEST_FORMAT, _MANIFEST_FORMAT_QUANT)


class WeightsError(RuntimeError):
    """No verifiable weight snapshot could be loaded."""


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(leaf)


def _items(params, prefix: str = ""):
    """``(path, leaf)`` pairs of a module's state dict or a nested dict,
    paths joined by ``/``."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if isinstance(params, dict):
        for k, v in params.items():
            yield from _items(v, f"{prefix}{k}/")
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from _items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], params


def _flatten(params) -> dict:
    return {key: _as_numpy(leaf) for key, leaf in _items(params)}


def _encode_quantized(flat: dict, wire_format: str) -> Tuple[dict, dict]:
    """Blockwise-encode the large float leaves of a flat param dict with
    the collectives' codec. Returns ``(encoded_flat, codec_manifest)``.
    Small leaves (< one quant block) and non-float leaves pass through
    raw — the scale sidecar would dominate them."""
    from chainermn_torch.collectives.quantized import (QUANT_BLOCK,
                                                       block_quantize)

    if wire_format not in ("int8-block", "int4-block"):
        raise ValueError(
            f"publish_weights wire_format={wire_format!r}: only the "
            "blockwise storage codecs ('int8-block', 'int4-block') "
            "apply to weights at rest")
    enc, leaves = {}, {}
    for k, arr in flat.items():
        if arr.dtype.kind == "f" and arr.size >= QUANT_BLOCK:
            q, s = block_quantize(torch.from_numpy(arr.reshape(-1)),
                                  wire_format)
            enc[k + "::q"] = q.numpy()
            enc[k + "::scale"] = s.numpy().astype(np.float32)
            leaves[k] = {"shape": list(arr.shape),
                         "dtype": arr.dtype.name,
                         "size": int(arr.size)}
        else:
            enc[k] = arr
    codec = {"wire_format": wire_format, "block": QUANT_BLOCK,
             "leaves": leaves}
    return enc, codec


def _decode_quantized(flat: dict, manifest: dict) -> dict:
    from chainermn_torch.collectives.quantized import block_dequantize

    codec = manifest.get("codec") or {}
    wf = codec.get("wire_format")
    blk = int(codec.get("block", 256))
    leaves = codec.get("leaves", {})
    out = {}
    for k, v in flat.items():
        if k.endswith("::scale"):
            continue
        if k.endswith("::q"):
            base = k[: -len("::q")]
            meta = leaves.get(base)
            if meta is None:
                raise WeightsError(
                    f"quantized snapshot has no codec entry for {base!r}")
            dt = np.dtype(meta["dtype"])
            deq = block_dequantize(
                torch.from_numpy(np.asarray(v)),
                torch.from_numpy(np.asarray(flat[base + "::scale"])),
                int(meta["size"]), wf,
                torch.from_numpy(np.zeros(0, dt)).dtype, blk).numpy()
            out[base] = deq.reshape(meta["shape"])
        else:
            out[k] = v
    return out


def encode_weights(params, wire_format: Optional[str] = None,
                   weights_version: Optional[str] = None
                   ) -> Tuple[dict, bytes]:
    """Serialize ``params`` to ``(manifest, payload)`` without touching
    disk — the wire form of :func:`publish_weights`, for a relay that
    ships a snapshot replica-to-replica. Same manifest grammar (format 1
    raw / format 2 blockwise-quantized via ``wire_format``);
    ``weights_version`` stamps the
    manifest so receivers can fence version skew. ``decode_weights``
    is the inverse and REFUSES a payload that fails the manifest's
    SHA-256."""
    flat = _flatten(params)
    codec = None
    if wire_format not in (None, "f32"):
        flat, codec = _encode_quantized(flat, wire_format)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    data = buf.getvalue()
    manifest = {"format": (_MANIFEST_FORMAT_QUANT if codec
                           else _MANIFEST_FORMAT),
                "sha256": hashlib.sha256(data).hexdigest(),
                "bytes": len(data)}
    if codec:
        manifest["codec"] = codec
    if weights_version is not None:
        manifest["weights_version"] = str(weights_version)
    return manifest, data


def decode_weights(manifest: dict, data: bytes, like: Any = None):
    """Verify + deserialize a payload produced by
    :func:`encode_weights`. The manifest's byte count and SHA-256 gate
    the load — torn or corrupt bytes raise :class:`WeightsError`, never
    half-load. With ``like`` (a state dict, a module or a nested dict)
    the flat keys are folded back into the template's structure as CPU
    tensors in its dtypes; otherwise a flat ``{path: array}`` dict is
    returned (quantized payloads are dequantized either way)."""
    if manifest.get("format") not in _ACCEPTED_FORMATS:
        raise WeightsError(
            f"unknown weight manifest format {manifest.get('format')!r}")
    if (len(data) != manifest.get("bytes")
            or hashlib.sha256(data).hexdigest()
            != manifest.get("sha256")):
        raise WeightsError(
            "weight payload does not match its manifest "
            "(torn or corrupt bytes)")
    with np.load(io.BytesIO(data)) as z:
        flat = {k: z[k] for k in z.files}
    if manifest.get("format") == _MANIFEST_FORMAT_QUANT:
        flat = _decode_quantized(flat, manifest)
    if like is None:
        return flat
    return _unflatten_like(like, flat)


def publish_weights(params, path: str,
                    wire_format: Optional[str] = None,
                    weights_version: Optional[str] = None) -> dict:
    """Atomically write ``params`` (a module, its state dict, or any
    nested dict of tensors and arrays) to ``path``
    (.npz) with a SHA-256 manifest sidecar ``path + '.json'``. Returns
    the manifest. The rename is the commit point: readers only ever see
    a complete, verified file.

    ``wire_format``: ``None``/``'f32'`` store raw arrays (format 1);
    ``'int8-block'``/``'int4-block'`` store blockwise codes + scales
    (format 2) through the collectives' codec — ``load_weights``
    dequantizes transparently from the manifest-recorded scales.
    ``weights_version`` (optional) is recorded in the manifest, so a
    restart can tell WHICH version its local snapshot verifies as
    (a rollout's convergence check)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    manifest, data = encode_weights(params, wire_format=wire_format,
                                    weights_version=weights_version)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    mtmp = path + ".json.tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    os.replace(mtmp, path + ".json")
    return manifest


def _verify(path: str) -> Optional[dict]:
    """The verified manifest, or ``None`` when the snapshot is missing,
    torn, or from an unknown format."""
    mf = path + ".json"
    if not (os.path.exists(path) and os.path.exists(mf)):
        return None
    try:
        with open(mf) as f:
            manifest = json.load(f)
        if manifest.get("format") not in _ACCEPTED_FORMATS:
            return None
        with open(path, "rb") as f:
            data = f.read()
        ok = (len(data) == manifest.get("bytes")
              and hashlib.sha256(data).hexdigest()
              == manifest.get("sha256"))
        return manifest if ok else None
    except (OSError, ValueError):
        return None


def weight_candidates(path: str) -> List[str]:
    """The primary snapshot plus any peer replicas
    (``<dir>/replicas/*/<name>``), newest mtime first."""
    cands = [path]
    d, name = os.path.split(os.path.abspath(path))
    cands += glob.glob(os.path.join(d, "replicas", "*", name))
    cands = [c for c in cands if os.path.exists(c)]
    return sorted(cands, key=lambda c: os.path.getmtime(c), reverse=True)


def load_weights(path: str,
                 like: Any = None) -> Tuple[dict, str]:
    """Load the newest VERIFIED snapshot reachable from ``path``.
    Returns ``(params, source_path)``. With ``like`` (a template state
    dict, module or nested dict), the flat npz keys are folded back into
    the template's structure as CPU tensors; otherwise a flat ``{path:
    array}`` dict is returned. Blockwise-quantized snapshots (manifest format 2) are dequantized
    from the manifest-recorded scales transparently. Corrupt candidates
    are skipped (torn writes, bad sha); raises :class:`WeightsError`
    when nothing verifies."""
    for cand in weight_candidates(path):
        manifest = _verify(cand)
        if manifest is None:
            continue
        with np.load(cand) as z:
            flat = {k: z[k] for k in z.files}
        if manifest.get("format") == _MANIFEST_FORMAT_QUANT:
            flat = _decode_quantized(flat, manifest)
        if like is None:
            return flat, cand
        return _unflatten_like(like, flat), cand
    raise WeightsError(
        f"no verified weight snapshot at {path!r} or its replicas")


def _unflatten_like(like, flat: dict):
    """``flat`` folded into ``like``'s structure: each leaf a CPU tensor
    in the template leaf's dtype (a numpy template leaf stays numpy)."""
    if isinstance(like, torch.nn.Module):
        like = like.state_dict()

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, f"{prefix}{i}/")
                              for i, v in enumerate(node))
        key = prefix[:-1]
        if key not in flat:
            raise WeightsError(f"snapshot is missing parameter {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(np.shape(node)):
            raise WeightsError(
                f"snapshot shape mismatch for {key!r}: "
                f"{arr.shape} vs {tuple(np.shape(node))}")
        if isinstance(node, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(node.dtype)
        return np.asarray(arr)

    return build(like, "")


def snapshot_candidates(ckpt_dir: str,
                        iteration: Optional[int] = None) -> List[str]:
    """Training-snapshot files under a checkpoint directory (primaries
    plus ``replicas/``), filtered to ``iteration`` when given, sorted
    newest iteration first (rank order within an iteration). No
    verification here — :func:`load_snapshot_weights` verifies each
    candidate's manifest before touching it."""
    pat = re.compile(r"snapshot_iter_(\d+)\.(\d+)$")
    found = []
    for d in (ckpt_dir, os.path.join(ckpt_dir, "replicas")):
        if not os.path.isdir(d):
            continue
        for f in os.listdir(d):
            m = pat.match(f)
            fn = os.path.join(d, f)
            if not m or os.path.isdir(fn):
                continue
            it = int(m.group(1))
            if iteration is not None and it != iteration:
                continue
            found.append((it, int(m.group(2)), fn))
    found.sort(key=lambda t: (-t[0], t[1]))
    return [fn for _, _, fn in found]


def load_snapshot_weights(ckpt_dir: str, like: Any,
                          iteration: Optional[int] = None):
    """Warm-reload serving weights from the newest VERIFIED training
    snapshot under ``ckpt_dir`` (``MultiNodeCheckpointer`` /
    ``AsyncSnapshotPlane`` output — same manifest grammar as
    :func:`publish_weights`, so the same verification applies). ``like``
    is the template (a state dict, or the exact structure that was
    saved); the snapshot's ``leaf_{i}`` arrays and ``leaf_{i}_s<k>``
    shard pieces are reassembled against it BY the checkpointer's leaf
    order — pass the structure that was saved (save the model's state
    dict, not a training state bundling optimizer state, for serving).
    Returns ``(params, source_path)``; raises :class:`WeightsError` when
    nothing verifies or the template does not match."""
    from chainermn_torch.extensions.checkpoint import (_flatten as
                                                       _ck_flatten)
    from chainermn_torch.extensions.checkpoint import _Leaf, _unflatten

    if isinstance(like, torch.nn.Module):
        like = like.state_dict()
    last_err = None
    for cand in snapshot_candidates(ckpt_dir, iteration=iteration):
        if _verify(cand) is None:
            continue
        try:
            refs: list = []
            tree = _ck_flatten(like, refs)
            with np.load(cand, allow_pickle=False) as z:
                keys = set(z.files)
                out = []
                for i, ref in enumerate(refs):
                    if f"leaf_{i}" in keys:
                        arr = z[f"leaf_{i}"]
                    elif f"leaf_{i}_nshards" in keys:
                        gshape = tuple(int(d)
                                       for d in z[f"leaf_{i}_gshape"])
                        n = int(z[f"leaf_{i}_nshards"])
                        first = z[f"leaf_{i}_s0"]
                        arr = np.empty(gshape, first.dtype)
                        vol = 0
                        for k in range(n):
                            idx = np.asarray(z[f"leaf_{i}_idx{k}"])
                            sl = tuple(
                                slice(int(a),
                                      int(b) if b != -1 else d)
                                for (a, b), d in zip(idx, gshape))
                            arr[sl] = z[f"leaf_{i}_s{k}"]
                            vol += int(np.prod(
                                [s.stop - s.start for s in sl],
                                initial=1))
                        if vol != int(np.prod(gshape, initial=1)):
                            raise WeightsError(
                                f"snapshot {cand} holds only part of "
                                f"leaf {i} ({vol} of "
                                f"{int(np.prod(gshape, initial=1))} "
                                "elements) — a multi-process sharded "
                                "snapshot; gather before publishing")
                    else:
                        raise WeightsError(
                            f"snapshot {cand} has no leaf {i} — the "
                            "template does not match the saved structure "
                            "(per-rank sharded snapshots need every "
                            "rank's file; this loader reads ONE file)")
                    if tuple(arr.shape) != tuple(np.shape(ref)):
                        raise WeightsError(
                            f"snapshot leaf {i} shape {arr.shape} vs "
                            f"template {tuple(np.shape(ref))}")
                    out.append(arr)

            def restore(leaf: _Leaf, _template):
                arr = np.array(out[leaf.i], copy=True)
                if leaf.kind != "tensor":
                    return arr
                t = torch.from_numpy(arr)
                return (t.view(torch.bfloat16) if leaf.dtype == "bfloat16"
                        and t.dtype == torch.int16 else t)

            return _unflatten(tree, restore), cand
        except WeightsError as e:
            last_err = e  # try the next candidate (older/replica)
            continue
    raise last_err or WeightsError(
        f"no verified training snapshot under {ckpt_dir!r}")


def pull_weights(comm, params: Optional[Any], root: int = 0):
    """Fetch warm weights from a live peer: rank ``root`` contributes
    its weights (a state dict), everyone receives them (object-plane
    broadcast — the joining replica never touches disk). Tensors travel
    as host copies."""
    if params is not None and comm.rank == root:
        params = _unflatten_like(params, _flatten(params))
    return comm.bcast_obj(params, root=root)
