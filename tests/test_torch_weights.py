"""The port's warm-weight plane, mirroring the JAX package's
``tests/serving_tests/test_weights.py``: atomic publish and
manifest-verified load over a model's state dict (raw, int8-block and
int4-block), torn and corrupt files refused, candidates newest first
across ``replicas/*``, the diskless encode/decode pair with its
``weights_version``, and ``load_snapshot_weights`` over a snapshot the
port's ``AsyncSnapshotPlane`` published. Across the frameworks: a file
JAX's ``publish_weights`` wrote loads here, raw and int8-block, to the
arrays JAX's own ``load_weights`` returns (bit for bit), and gives JAX's
logits after ``params_from_flax`` (f32, 1e-5); the port's int8-block
payload for the same arrays holds JAX's codes and scales bit for bit.
``pull_weights`` runs in the two-rank world of
``tests/test_torch_ckpt_tool.py``."""

import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.serving import weights as jweights
from chainermn_torch.checkpointing import AsyncSnapshotPlane
from chainermn_torch.comm import create_communicator
from chainermn_torch.extensions import create_multi_node_checkpointer
from chainermn_torch.models.convert import params_from_flax
from chainermn_torch.models.transformer import TransformerLM
from chainermn_torch.serving.weights import (WeightsError, decode_weights,
                                             encode_weights,
                                             load_snapshot_weights,
                                             load_weights, publish_weights,
                                             weight_candidates)

SMALL = dict(vocab=17, d_model=16, n_heads=2, n_layers=1, d_ff=24,
             max_len=16, attention="reference")
BIG = dict(vocab=512, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           max_len=32, attention="reference")


def _model(seed=0, **kw):
    torch.manual_seed(seed)
    return TransformerLM(**(kw or SMALL), device="cpu")


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _flip_a_byte(path, at=100):
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0xFF]))


def test_publish_load_roundtrip(tmp_path):
    sd = _model().state_dict()
    path = str(tmp_path / "w.npz")
    manifest = publish_weights(sd, path, weights_version="v3")
    assert manifest["format"] == 1 and manifest["weights_version"] == "v3"
    with open(path + ".json") as f:
        assert json.load(f) == manifest
    loaded, src = load_weights(path, like=sd)
    assert src == path
    _equal(sd, loaded)
    flat, _ = load_weights(path)
    assert set(flat) == set(sd) and isinstance(flat["lm_head.weight"],
                                               np.ndarray)


def test_corrupt_and_torn_snapshots_are_refused(tmp_path):
    sd = _model().state_dict()
    path = str(tmp_path / "w.npz")
    publish_weights(sd, path)
    _flip_a_byte(path)
    with pytest.raises(WeightsError, match="no verified"):
        load_weights(path)
    torn = str(tmp_path / "t.npz")
    publish_weights(sd, torn)
    os.remove(torn + ".json")            # the rename never happened
    with pytest.raises(WeightsError, match="no verified"):
        load_weights(torn)


def test_replica_fallback_and_newest_first(tmp_path):
    sd = _model().state_dict()
    path = str(tmp_path / "w.npz")
    reps = []
    for i, peer in enumerate(("peer1", "peer2")):
        d = tmp_path / "replicas" / peer
        d.mkdir(parents=True)
        reps.append(str(d / "w.npz"))
        publish_weights(_model(seed=i + 1).state_dict(), reps[-1])
        os.utime(reps[-1], (time.time() + i, time.time() + i))
    with open(path, "wb") as f:          # primary torn: no manifest
        f.write(b"garbage")
    os.utime(path, (time.time() - 10, time.time() - 10))
    assert weight_candidates(path) == [reps[1], reps[0], path]
    loaded, src = load_weights(path, like=sd)
    assert src == reps[1]
    _equal(_model(seed=2).state_dict(), loaded)
    with pytest.raises(WeightsError):
        load_weights(str(tmp_path / "nope.npz"))


def test_shape_mismatch_refused(tmp_path):
    path = str(tmp_path / "w.npz")
    publish_weights(_model().state_dict(), path)
    bigger = {k: torch.zeros((3,) + tuple(v.shape))
              for k, v in _model().state_dict().items()}
    with pytest.raises(WeightsError, match="shape mismatch"):
        load_weights(path, like=bigger)


@pytest.mark.parametrize("wire_format", ["int8-block", "int4-block"])
def test_quantized_publish_load_roundtrip(tmp_path, wire_format):
    sd = _model(**BIG).state_dict()
    raw, qp = str(tmp_path / "raw.npz"), str(tmp_path / "quant.npz")
    publish_weights(sd, raw)
    manifest = publish_weights(sd, qp, wire_format=wire_format)
    assert manifest["format"] == 2
    codec = manifest["codec"]
    assert codec["wire_format"] == wire_format and codec["block"] == 256
    assert len(codec["leaves"]) == sum(v.numel() >= 256
                                       for v in sd.values())
    ratio = os.path.getsize(qp) / os.path.getsize(raw)
    assert ratio < (0.45 if wire_format == "int8-block" else 0.35), ratio
    loaded, _ = load_weights(qp, like=sd)
    qmax = 127.0 if wire_format == "int8-block" else 7.0
    for k, a in sd.items():
        b = loaded[k]
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.numel() < 256:
            assert torch.equal(a, b)
        else:
            assert float((a - b).abs().max()) <= float(
                a.abs().max()) / qmax + 1e-7
    _flip_a_byte(qp)
    with pytest.raises(WeightsError):
        load_weights(qp, like=sd)


def test_encode_decode_and_refusals(tmp_path):
    sd = _model().state_dict()
    manifest, data = encode_weights(sd, wire_format="int8-block",
                                    weights_version="v7")
    assert manifest["weights_version"] == "v7"
    back = decode_weights(manifest, data, like=sd)
    assert back.keys() == sd.keys()
    with pytest.raises(WeightsError, match="torn or corrupt"):
        decode_weights(manifest, data[:-1])
    with pytest.raises(WeightsError, match="unknown weight manifest"):
        decode_weights(dict(manifest, format=9), data)
    with pytest.raises(ValueError, match="blockwise"):
        publish_weights(sd, str(tmp_path / "w.npz"), wire_format="bf16")


def _nest(flat):
    out = {}
    for key, arr in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return out


@pytest.mark.parametrize("wire_format", [None, "int8-block"])
def test_a_file_jax_published_loads_and_gives_jaxs_logits(tmp_path,
                                                          wire_format):
    cfg = dict(vocab=300, d_model=32, n_heads=4, n_layers=1, d_ff=64,
               max_len=16, attention="reference", pos_emb="rope")
    jm = JaxLM(**cfg)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    path = str(tmp_path / "jax.npz")
    jweights.publish_weights(params, path, wire_format=wire_format)
    jflat, _ = jweights.load_weights(path)
    flat, src = load_weights(path)
    assert src == path and flat.keys() == jflat.keys()
    for k in flat:
        np.testing.assert_array_equal(flat[k], np.asarray(jflat[k]))
    tm = TransformerLM(**cfg, device="cpu")
    tm.load_state_dict(params_from_flax(tm, _nest(flat)))
    toks = np.random.RandomState(0).randint(0, 300, (2, 8))
    want = np.asarray(jm.apply({"params": jax.tree_util.tree_map(
        jnp.asarray, _nest(jflat))}, jnp.asarray(toks, jnp.int32)))
    with torch.no_grad():
        got = tm(torch.as_tensor(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_the_int8_payload_holds_jaxs_codes(tmp_path):
    rng = np.random.default_rng(0)
    flat = {"a": (rng.standard_normal((40, 33)) * 3).astype(np.float32),
            "b": rng.standard_normal(600).astype(np.float32),
            "small": rng.standard_normal(7).astype(np.float32)}
    mj, dj = jweights.encode_weights(flat, wire_format="int8-block")
    mt, dt = encode_weights(flat, wire_format="int8-block")
    assert mt["codec"] == mj["codec"]
    import io
    with np.load(io.BytesIO(dj)) as zj, np.load(io.BytesIO(dt)) as zt:
        assert set(zj.files) == set(zt.files)
        for k in zj.files:
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)


def test_load_snapshot_weights_reads_an_async_plane_snapshot(tmp_path):
    model = _model()
    comm = create_communicator("pure_nccl", device="cpu")
    try:
        ck = create_multi_node_checkpointer("serve", comm,
                                            path=str(tmp_path))
        plane = AsyncSnapshotPlane(ck)
        older = {k: v + 1 for k, v in model.state_dict().items()}
        plane.save(older, 2)
        plane.save({k: v.to(torch.bfloat16) if k == "lm_head.weight"
                    else v for k, v in model.state_dict().items()}, 4)
        plane.flush()
        plane.close()
    finally:
        comm.finalize()
    like = {k: v.to(torch.bfloat16) if k == "lm_head.weight" else v
            for k, v in model.state_dict().items()}
    got, src = load_snapshot_weights(ck.path, like)
    assert src.endswith("snapshot_iter_4.0")
    _equal(like, got)
    old, src = load_snapshot_weights(ck.path, like, iteration=2)
    assert src.endswith("snapshot_iter_2.0")
    assert torch.equal(old["tok_emb.weight"],
                       model.state_dict()["tok_emb.weight"] + 1)
    with pytest.raises(WeightsError, match="shape"):
        load_snapshot_weights(ck.path, {k: torch.zeros(3)
                                        for k in like})
