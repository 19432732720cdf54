"""Parameters of the JAX package's TransformerLM → the port's state dict.

The input is the flax ``params`` tree with numpy leaves (the port never
imports JAX; a caller converts with ``jax.tree_util.tree_map(np.asarray,
params)`` or loads a saved tree). The mapping:

* Dense ``kernel [in, out]`` → ``Linear.weight [out, in]``; ``bias`` as is;
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

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_flax"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


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
    sd: Dict[str, torch.Tensor] = {
        "tok_emb.weight": _t(tree["tok_emb"]["embedding"]),
        "ln_f.weight": _t(tree["LayerNorm_0"]["scale"]),
        "ln_f.bias": _t(tree["LayerNorm_0"]["bias"]),
        "lm_head.weight": _t(tree["lm_head"]["kernel"]).T.contiguous(),
    }
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
            sd[pre + dst + ".weight"] = _t(bp[src]["kernel"]).T.contiguous()
            if "bias" in bp[src]:
                sd[pre + dst + ".bias"] = _t(bp[src]["bias"])
        for src, dst in (("LayerNorm_0", "ln_attn"),
                         ("LayerNorm_1", "ln_ffn")):
            sd[pre + dst + ".weight"] = _t(bp[src]["scale"])
            sd[pre + dst + ".bias"] = _t(bp[src]["bias"])
    return sd
