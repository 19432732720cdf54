"""Parameters of the JAX package's flax models → the port's state dicts.

The input is the flax ``params`` tree with numpy leaves (the port never
imports JAX; a caller converts with ``jax.tree_util.tree_map(np.asarray,
params)`` or loads a saved tree).

:func:`convert_layer` maps one flax layer onto its torch module:

* ``dense``: Dense ``kernel [in, out]`` → ``Linear.weight [out, in]``;
  ``bias`` as is;
* ``embed``: Embed ``embedding`` → ``Embedding.weight``;
* ``layer_norm``: LayerNorm ``scale``/``bias`` → ``weight``/``bias``;
* ``conv``: Conv ``kernel`` HWIO (any number of spatial axes) → OIHW;
* ``batch_norm``: BatchNorm ``scale``/``bias`` and its ``batch_stats``
  ``mean``/``var`` → ``weight``/``bias``/``running_mean``/
  ``running_var`` (plus torch's ``num_batches_tracked``, 0, which flax
  does not keep, for ``torch.nn.BatchNorm2d``).

:func:`mlp_params_from_flax` converts the MLP.
:func:`resnet_params_from_flax` converts a ResNet: each convolution,
batch norm and dense layer of the port's model from the flax layer of the
same path (the port's ``MultiNodeBatchNormalization`` keeps no
``num_batches_tracked``, so that key is not emitted for it).
:func:`params_from_flax` converts the TransformerLM:

* Dense and LayerNorm layers as above;
* fused ``qkv`` and GQA ``kv_proj`` stay fused: the port splits their
  OUTPUT into equal chunks along the last axis, exactly as
  ``jnp.split(qkv, 3, -1)`` / ``jnp.split(kv, 2, -1)`` do;
* ``LayerNorm_0``/``LayerNorm_1`` ``scale``/``bias`` → ``ln_attn``/
  ``ln_ffn`` ``weight``/``bias``; the final ``LayerNorm_0`` → ``ln_f``;
* ``tok_emb.embedding``, ``pos_emb`` and ``lm_head.kernel`` carry over;
* a tree trained with ``qkv_layout="bhld"`` (head-major einsum kernels
  ``qkv_bhld [d, 3, h, e]``, ``q_bhld [d, h, e]``, ``kv_bhld [d, 2, hkv,
  e]``, ``attn_out_bhld [h, e, d]``) is first mapped to the Dense kernels
  the way the JAX package's ``bhld_to_blhd_params`` maps it. The port
  needs no second compute layout: its kernels read q/k/v through strides.

Every parameter of the port is f32, as flax keeps them.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

__all__ = ["convert_layer", "params_from_flax", "mlp_params_from_flax",
           "resnet_params_from_flax"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _bias(p: Mapping) -> Dict[str, torch.Tensor]:
    return {"bias": _t(p["bias"])} if "bias" in p else {}


def _affine(p: Mapping) -> Dict[str, torch.Tensor]:
    scale = {"weight": _t(p["scale"])} if "scale" in p else {}
    return {**scale, **_bias(p)}


def _dense(p, stats):
    return {"weight": _t(p["kernel"]).T.contiguous(), **_bias(p)}


def _conv(p, stats):
    k = np.asarray(p["kernel"])            # [*spatial, in/groups, out]
    n = k.ndim
    return {"weight": _t(np.transpose(k, (n - 1, n - 2, *range(n - 2)))),
            **_bias(p)}


def _batch_norm(p, stats):
    if stats is None:
        raise ValueError("batch_norm needs the layer's batch_stats")
    return {**_affine(p), "running_mean": _t(stats["mean"]),
            "running_var": _t(stats["var"]),
            "num_batches_tracked": torch.tensor(0)}


_LAYERS = {
    "dense": _dense,
    "embed": lambda p, stats: {"weight": _t(p["embedding"])},
    "layer_norm": lambda p, stats: _affine(p),
    "conv": _conv,
    "batch_norm": _batch_norm,
}


def convert_layer(kind: str, params: Mapping,
                  batch_stats: Optional[Mapping] = None,
                  prefix: str = "") -> Dict[str, torch.Tensor]:
    """One flax layer's ``params`` (and, for ``batch_norm``, its
    ``batch_stats``) → the state-dict entries of the torch module at
    ``prefix`` (e.g. ``"blocks.0.qkv."``). ``kind`` is one of ``dense``,
    ``embed``, ``layer_norm``, ``conv``, ``batch_norm``; the mapping is in
    the module docstring."""
    if kind not in _LAYERS:
        raise ValueError(f"unknown layer kind {kind!r}; expected one of "
                         f"{sorted(_LAYERS)}")
    return {prefix + k: v
            for k, v in _LAYERS[kind](params, batch_stats).items()}


def mlp_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax MLP ``params`` (``Dense_0``..``Dense_2``) → a state dict for
    :class:`chainermn_torch.models.MLP` (``l1``..``l3``)."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(3):
        sd.update(convert_layer("dense", tree[f"Dense_{i}"],
                                prefix=f"l{i + 1}."))
    return sd


def _flax_path(name: str, kind: str, cross_replica: bool) -> List[str]:
    """The flax path of the port's layer ``name``. With cross-replica
    batch norm the JAX ResNet wraps each flax ``BatchNorm`` in a
    ``MultiNodeBatchNormalization`` (auto-named like the ``BatchNorm`` it
    replaces, or ``bn_init``/``norm_proj``) holding ``BatchNorm_0``."""
    parts = name.split(".")
    if kind == "batch_norm" and cross_replica:
        last = parts[-1]
        if last.startswith("BatchNorm_"):
            parts[-1] = "MultiNodeBatchNormalization_" + last.split("_")[1]
        parts.append("BatchNorm_0")
    return parts


def resnet_params_from_flax(model, params: Mapping,
                            batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ResNet ``params`` and ``batch_stats`` (numpy leaves) → a state
    dict for ``model`` (a :class:`chainermn_torch.models.resnet.ResNet` of
    the same configuration). The tree says whether the flax model had
    cross-replica batch norm (``bn_init`` then holds ``BatchNorm_0``);
    either tree loads into a port model with or without ``comm``."""
    from chainermn_torch.links import MultiNodeBatchNormalization
    from chainermn_torch.models.resnet import Conv

    cross = "BatchNorm_0" in params["bn_init"]
    sd: Dict[str, torch.Tensor] = {}
    for name, mod in model.named_modules():
        if isinstance(mod, Conv):
            kind = "conv"
        elif isinstance(mod, MultiNodeBatchNormalization):
            kind = "batch_norm"
        elif isinstance(mod, torch.nn.Linear):
            kind = "dense"
        else:
            continue
        path = _flax_path(name, kind, cross)
        p, s = params, batch_stats if kind == "batch_norm" else None
        for part in path:
            p = p[part]
            s = None if s is None else s[part]
        entries = convert_layer(kind, p, s, prefix=name + ".")
        entries.pop(name + ".num_batches_tracked", None)
        sd.update(entries)
    return sd


def _bhld_block(bp: Mapping, d: int) -> Dict:
    """One block's head-major kernels → the Dense kernels (a copy of
    ``bhld_to_blhd_params``'s mapping, in numpy)."""
    out = {k: v for k, v in bp.items() if not k.endswith("_bhld")}
    if "qkv_bhld" in bp:
        w = np.asarray(bp["qkv_bhld"])                 # [d, 3, h, e]
        out["qkv"] = {"kernel": np.concatenate(
            [w[:, t].reshape(d, -1) for t in range(3)], axis=1)}
    if "q_bhld" in bp:
        out["q_proj"] = {"kernel": np.asarray(bp["q_bhld"]).reshape(d, -1)}
    if "kv_bhld" in bp:
        w = np.asarray(bp["kv_bhld"])                  # [d, 2, hkv, e]
        out["kv_proj"] = {"kernel": np.concatenate(
            [w[:, t].reshape(d, -1) for t in range(2)], axis=1)}
    if "attn_out_bhld" in bp:
        w = np.asarray(bp["attn_out_bhld"])            # [h, e, d]
        out["attn_out"] = {"kernel": w.reshape(-1, w.shape[-1])}
    return out


def params_from_flax(model, tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax TransformerLM ``params`` (numpy leaves) → a state dict for
    ``model`` (a :class:`chainermn_torch.models.TransformerLM` of the
    same configuration)."""
    sd = {**convert_layer("embed", tree["tok_emb"], prefix="tok_emb."),
          **convert_layer("layer_norm", tree["LayerNorm_0"], prefix="ln_f."),
          **convert_layer("dense", tree["lm_head"], prefix="lm_head.")}
    if model.pos_emb == "learned":
        sd["pos_embedding"] = _t(tree["pos_emb"])
    for i in range(model.n_layers):
        bp = _bhld_block(tree[f"block_{i}"], model.d_model)
        pre = f"blocks.{i}."
        dense = {"attn_out": "attn_out", "ffn_in": "ffn_in",
                 "ffn_out": "ffn_out"}
        if "qkv" in bp:
            dense["qkv"] = "qkv"
        else:
            dense.update(q_proj="q_proj", kv_proj="kv_proj")
        for src, dst in dense.items():
            sd.update(convert_layer("dense", bp[src], prefix=pre + dst + "."))
        for src, dst in (("LayerNorm_0", "ln_attn"),
                         ("LayerNorm_1", "ln_ffn")):
            sd.update(convert_layer("layer_norm", bp[src],
                                    prefix=pre + dst + "."))
    return sd
