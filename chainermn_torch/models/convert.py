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
* ``tok_emb.embedding``, ``pos_emb`` and ``lm_head.kernel`` carry over.

``model.load_state_dict`` then casts each tensor to the parameter's own
dtype (bf16 Linear weights in a bf16 model, f32 elsewhere).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_flax"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


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
        bp = tree[f"block_{i}"]
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
