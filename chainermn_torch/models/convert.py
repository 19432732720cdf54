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

:func:`mlp_params_from_flax` converts the MLP, and
:func:`dense_stage_params_from_flax` a chain-list stage built from flax
``Dense`` layers (its ``nn.Linear`` layers in order ↔ ``Dense_0``,
``Dense_1``, ...).
:func:`seq2seq_params_from_flax` converts the seq2seq model: embeddings
and the projection as above; each flax ``OptimizedLSTMCell_k`` (input
kernels ``ii/if/ig/io`` without bias, recurrent kernels ``hi/hf/hg/ho``
with bias, gate order i, f, g, o, carry ``(c, h)``) becomes layer ``k``
of the ``nn.LSTM`` (the same gate order, carry ``(h, c)``):
``weight_ih_lk`` stacks the transposed input kernels, ``weight_hh_lk``
the recurrent ones, ``bias_hh_lk`` the biases, ``bias_ih_lk`` is zero.
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

The tensor-parallel and MoE forms of the LM (``tp_axis``,
``lm_head_tp``, ``moe_experts_per_device``) convert the same way, one
rank at a time: a column- or row-parallel layer's ``Dense_0`` is its
``dense`` ``nn.Linear``, ``tp_ffn``'s ``ColumnParallelDense_0``/
``RowParallelDense_0`` are its ``column``/``row``, and the MoE tables
``moe/w1``..``b2`` and ``moe/router`` carry over.
:func:`rank_params_from_flax` cuts rank r's tree out of the ranks'
stacked one; :func:`dense_params_from_ranks` gathers a rank set's state
dicts into the dense (or all-experts-local) twin's and
:func:`rank_params_from_dense` cuts them back out.

:func:`vit_params_from_flax` converts the ViT: ``patchify`` as a
``conv`` (HWIO → OIHW), ``cls_token`` and ``pos_emb`` as they are, each
``block_<i>``'s fused ``qkv`` (split by the port's output chunks, as in
the LM), ``attn_out``, ``ffn_in`` and ``ffn_out`` as ``dense``, its
``LayerNorm_0``/``LayerNorm_1`` as ``ln_attn``/``ln_ffn``, the final
``LayerNorm_0`` as ``ln_f`` and ``head`` as ``dense``.

Every parameter of the port is f32, as flax keeps them.

:func:`flax_param_order` lists a model's trainable parameters in the order
``jax.tree_util.tree_leaves`` gives the flax tree (dict keys sorted at
every level, so a Dense layer's ``bias`` comes before its ``kernel``),
through the names the converters above map, and :func:`flax_layout_perm`
the permutation that puts a parameter in its flax layout (a Dense
kernel is ``weight.t()``, a convolution's HWIO kernel ``weight.permute(2,
3, 1, 0)``): the order and the layout in which the ZeRO steps pack
parameters (``chainermn_torch/optimizers/zero.py``), so that their flat
vectors hold JAX's numbers in JAX's places.

:func:`flax_params` goes the other way, a model's parameters as the flax
tree in flax's layout, and :func:`stacked_params_from_flax` turns a JAX
tree (stacked by ``stack_lm_blocks`` or not) into tensors: the FSDP
step's tree form (``chainermn_torch/optimizers/zero.py``).

The pipelines' stages take their parameters as flax-layout trees, so a
test feeds the same converted tree to the JAX function and the port's
and compares the same gradient trees. :func:`block_param_map` maps any
module whose layers it names — a :class:`TransformerBlock` (dense or
tensor-parallel), the pipeline LM's ``EmbedIn`` (``tok`` ↔ flax's
``tok/embedding``, ``pos``) and ``HeadOut`` (``ln_f`` ↔ ``LayerNorm_0``,
``out`` ↔ the bias-free Dense ``out/kernel``): :func:`module_flax_tree`
gives a module's parameters (or a state dict of its names, such as
:func:`rank_params_from_dense`'s cut of a tensor-parallel rank) as that
tree, :func:`module_params_from_flax` the module's parameters back from
it (views, a Dense kernel transposed), :func:`flax_tree_apply` the
module run on such a tree, and :func:`stage_stack_from_flax` cuts rank
``d``'s ``[V, ...]`` chunks out of the interleaved ``[V, S, ...]`` stage
stack.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

__all__ = ["convert_layer", "params_from_flax", "mlp_params_from_flax",
           "resnet_params_from_flax", "dense_stage_params_from_flax",
           "seq2seq_params_from_flax", "vit_params_from_flax",
           "flax_param_order", "flax_layout_perm", "flax_params",
           "stacked_params_from_flax", "block_param_map",
           "rank_params_from_flax", "dense_params_from_ranks",
           "rank_params_from_dense", "module_flax_tree",
           "module_params_from_flax", "flax_tree_apply",
           "stage_stack_from_flax"]


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


def dense_stage_params_from_flax(module: torch.nn.Module,
                                 tree: Mapping) -> Dict[str, torch.Tensor]:
    """One chain-list stage's flax ``params`` (``Dense_0``, ``Dense_1``,
    ... and nothing else) → a state dict for ``module``, whose
    ``nn.Linear`` layers, in registration order, are those Dense
    layers."""
    linears = [n for n, m in module.named_modules()
               if isinstance(m, torch.nn.Linear)]
    tree = tree.get("params", tree)
    if sorted(tree) != sorted(f"Dense_{i}" for i in range(len(linears))):
        raise ValueError(f"stage has {len(linears)} Linear layers, the "
                         f"flax tree {sorted(tree)}")
    sd: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(linears):
        sd.update(convert_layer("dense", tree[f"Dense_{i}"],
                                prefix=name + "."))
    return sd


_GATES = "ifgo"


def _lstm_layers(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    k = 0
    while f"OptimizedLSTMCell_{k}" in tree:
        cell = tree[f"OptimizedLSTMCell_{k}"]
        sd[f"{prefix}weight_ih_l{k}"] = torch.cat(
            [_t(cell["i" + g]["kernel"]).T for g in _GATES]).contiguous()
        sd[f"{prefix}weight_hh_l{k}"] = torch.cat(
            [_t(cell["h" + g]["kernel"]).T for g in _GATES]).contiguous()
        sd[f"{prefix}bias_hh_l{k}"] = torch.cat(
            [_t(cell["h" + g]["bias"]) for g in _GATES])
        sd[f"{prefix}bias_ih_l{k}"] = torch.zeros_like(
            sd[f"{prefix}bias_hh_l{k}"])
        k += 1
    return sd


def seq2seq_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``Seq2Seq`` ``params`` (numpy leaves) → a state dict for
    :class:`chainermn_torch.models.seq2seq.Seq2Seq` (mapping in the module
    docstring)."""
    tree = tree.get("params", tree)
    return {**convert_layer("embed", tree["src_embed"], prefix="src_embed."),
            **convert_layer("embed", tree["tgt_embed"], prefix="tgt_embed."),
            **convert_layer("dense", tree["proj"], prefix="proj."),
            **_lstm_layers(tree["encoder"], "encoder."),
            **_lstm_layers(tree["decoder"], "decoder.")}


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
    same configuration): each parameter from its flax path
    (:func:`flax_param_order`'s names), in the port's layout. A tensor-
    or expert-parallel model takes one rank's tree
    (:func:`rank_params_from_flax` cuts it from the ranks' stacked one)."""
    tree = {k: (_bhld_block(v, model.d_model) if k.startswith("block_")
                else v) for k, v in tree.items()}
    sd = {}
    for name, _ in model.named_parameters():
        owner, _, attr = name.rpartition(".")
        leaf = tree
        for part in _flax_leaf(model, owner, attr):
            leaf = leaf[part]
        t = _t(leaf)
        perm = flax_layout_perm(model, name)
        sd[name] = t.permute(perm).contiguous() if perm else t
    return sd


def _per_rank(path) -> bool:
    """Whether a flax leaf of a tensor- or expert-parallel LM is this
    rank's own: a column- or row-parallel layer's ``Dense_0`` (not the
    row-parallel layer's replicated ``bias``), or an expert table."""
    if "moe" in path:
        return path[-1] in ("w1", "b1", "w2", "b2")
    return "Dense_0" in path


def rank_params_from_flax(model, tree: Mapping, rank: int,
                          size: int) -> Dict[str, torch.Tensor]:
    """A tensor- or expert-parallel TransformerLM's flax tree as
    ``shard_map(..., out_specs=P(axis))`` returns it (each leaf the
    ``size`` ranks' leaves concatenated on axis 0: a column-parallel
    kernel ``[d, out/n]`` becomes ``[n·d, out/n]``, a replicated leaf
    repeats, the expert tables ``[e_local, ...]`` become ``[n·e_local,
    ...]``) → rank ``rank``'s state dict for ``model`` (the port model of
    that rank). A rank's own leaves come from its slice; the router and
    the other shared leaves from rank 0's, as
    ``init_expert_parallel_state`` replicates them."""
    def cut(node, path):
        if isinstance(node, Mapping):
            return {k: cut(v, path + (k,)) for k, v in node.items()}
        a = np.asarray(node)
        if a.shape[0] % size:
            raise ValueError(f"leaf {'/'.join(path)} {a.shape} does not "
                             f"split over {size} ranks")
        per = a.shape[0] // size
        i = rank if _per_rank(path) else 0
        return a[i * per:(i + 1) * per]

    return params_from_flax(model, cut(tree, ()))


def _block_of(key: str) -> str:
    """``"blocks.<i>."`` for a block's parameter, ``""`` otherwise."""
    if not key.startswith("blocks."):
        return ""
    return key[:key.index(".", len("blocks.")) + 1]


_EXPERT_TABLES = ("w1", "b1", "w2", "b2")

# a dense parameter ← its tensor-parallel pieces: (the pieces' name in
# the block, the axis they stack on)
_TP_PIECES = {"attn_out.weight": ("attn_out.dense.weight", 1),
              "ffn_in.weight": ("tp_ffn.column.dense.weight", 0),
              "ffn_in.bias": ("tp_ffn.column.dense.bias", 0),
              "ffn_out.weight": ("tp_ffn.row.dense.weight", 1),
              "lm_head.weight": ("lm_head.dense.weight", 0)}


def _expert_table(key: str) -> bool:
    return ".moe." in key and key.rpartition(".")[2] in _EXPERT_TABLES


def dense_params_from_ranks(model, sds) -> Dict[str, torch.Tensor]:
    """The state dicts of a tensor- or expert-parallel rank set (rank
    order) → the state dict of ``model``, the same LM with every head,
    FFN column, vocabulary row and expert on one rank (its dense or
    all-experts-local twin). The dense q is the ranks' q rows side by
    side; the dense k is each rank's first ``kv`` half, the dense v each
    rank's second half; ``attn_out``'s and ``tp_ffn``'s row kernels
    stack on the input axis; the expert tables concatenate in rank order
    (expert ``r·e_local + j`` is rank r's j-th); every shared leaf is
    rank 0's."""
    first = sds[0]
    out: Dict[str, torch.Tensor] = {}
    for key in model.state_dict():
        blk = _block_of(key)
        local = key[len(blk):]
        if _expert_table(key):
            out[key] = torch.cat([sd[key] for sd in sds])
        elif key in first:
            out[key] = first[key]
        elif local in ("qkv.weight", "q_proj.weight", "kv_proj.weight"):
            q = torch.cat([sd[blk + "q_proj.dense.weight"] for sd in sds])
            halves = [sd[blk + "kv_proj.dense.weight"].chunk(2)
                      for sd in sds]
            kv = [torch.cat([h[i] for h in halves]) for i in (0, 1)]
            out[key] = {"qkv.weight": torch.cat([q, *kv]),
                        "q_proj.weight": q,
                        "kv_proj.weight": torch.cat(kv)}[local]
        elif local == "ffn_out.bias":
            out[key] = first[blk + "tp_ffn.row.bias"]
        else:
            piece, dim = _TP_PIECES[local]
            out[key] = torch.cat([sd[blk + piece] for sd in sds], dim)
    return out


def rank_params_from_dense(model, sd, rank: int,
                           size: int) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`dense_params_from_ranks`: the dense (or
    all-experts-local) twin's state dict ``sd`` → rank ``rank``'s state
    dict for ``model``, the tensor- or expert-parallel model of that
    rank of ``size``."""
    def part(t, dim=0):
        return t.chunk(size, dim)[rank].contiguous()

    pieces = {piece: (whole, dim)
              for whole, (piece, dim) in _TP_PIECES.items()}
    out: Dict[str, torch.Tensor] = {}
    for key in model.state_dict():
        blk = _block_of(key)
        local = key[len(blk):]
        fused = blk + "qkv.weight" in sd
        if _expert_table(key):
            out[key] = part(sd[key])
        elif local == "q_proj.dense.weight":
            out[key] = part(sd[blk + "qkv.weight"].chunk(3)[0] if fused
                            else sd[blk + "q_proj.weight"])
        elif local == "kv_proj.dense.weight":
            kv = (torch.cat(sd[blk + "qkv.weight"].chunk(3)[1:]) if fused
                  else sd[blk + "kv_proj.weight"])
            out[key] = torch.cat([part(t) for t in kv.chunk(2)])
        elif local == "tp_ffn.row.bias":
            out[key] = sd[blk + "ffn_out.bias"]
        elif local in pieces:
            whole, dim = pieces[local]
            out[key] = part(sd[blk + whole], dim)
        else:
            out[key] = sd[key]
    return out


def vit_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``ViT`` ``params`` (numpy leaves) → a state dict for
    :class:`chainermn_torch.models.vit.ViT` of the same configuration
    (mapping in the module docstring; ``pool="cls"`` trees carry
    ``cls_token``)."""
    tree = tree.get("params", tree)
    sd = {**convert_layer("conv", tree["patchify"], prefix="patchify."),
          **convert_layer("layer_norm", tree["LayerNorm_0"], prefix="ln_f."),
          **convert_layer("dense", tree["head"], prefix="head."),
          "pos_emb": _t(tree["pos_emb"])}
    if "cls_token" in tree:
        sd["cls_token"] = _t(tree["cls_token"])
    i = 0
    while f"block_{i}" in tree:
        bp, pre = tree[f"block_{i}"], f"blocks.{i}."
        for name in ("qkv", "attn_out", "ffn_in", "ffn_out"):
            sd.update(convert_layer("dense", bp[name],
                                    prefix=pre + name + "."))
        for src, dst in (("LayerNorm_0", "ln_attn"),
                         ("LayerNorm_1", "ln_ffn")):
            sd.update(convert_layer("layer_norm", bp[src],
                                    prefix=pre + dst + "."))
        i += 1
    return sd


# the port's layer names → flax's (the LM's and the ViT's; ``blocks.<i>``
# is ``block_<i>``, the MLP's ``l<k>`` is ``Dense_<k-1>``)
_FLAX_NAMES = {"ln_attn": "LayerNorm_0", "ln_ffn": "LayerNorm_1",
               "ln_f": "LayerNorm_0", "pos_embedding": "pos_emb",
               "dense": "Dense_0", "column": "ColumnParallelDense_0",
               "row": "RowParallelDense_0"}


def _flax_leaf(model, owner: str, attr: str):
    """The flax path of the port's parameter ``owner.attr``."""
    from chainermn_torch.models.mlp import MLP

    mod = model.get_submodule(owner) if owner else model
    if attr == "weight":
        if isinstance(mod, torch.nn.LayerNorm):
            attr = "scale"
        elif isinstance(mod, torch.nn.Embedding):
            attr = "embedding"
        elif isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d)):
            attr = "kernel"
    if isinstance(model, MLP):
        return (f"Dense_{int(owner[1:]) - 1}", attr)
    parts, path = owner.split(".") if owner else [], []
    for i, part in enumerate(parts):
        if part == "blocks":
            continue
        if i and parts[i - 1] == "blocks":
            path.append(f"block_{part}")
        else:
            path.append(_FLAX_NAMES.get(part, part))
    return (*path, _FLAX_NAMES.get(attr, attr))


def flax_param_order(model) -> List[tuple]:
    """``(name, parameter)`` of ``model``'s trainable parameters in the
    flax tree's leaf order (module docstring) for the models the
    converters map (:class:`~chainermn_torch.models.MLP`,
    :class:`~chainermn_torch.models.TransformerLM`,
    :class:`~chainermn_torch.models.ViT`); any other model keeps its own
    parameter order."""
    from chainermn_torch.models.mlp import MLP
    from chainermn_torch.models.transformer import TransformerLM
    from chainermn_torch.models.vit import ViT

    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if not isinstance(model, (MLP, TransformerLM, ViT)):
        return named

    def key(item):
        owner, _, attr = item[0].rpartition(".")
        return _flax_leaf(model, owner, attr)

    return sorted(named, key=key)


def _layout_perm(mod) -> Optional[tuple]:
    """The permutation into flax's layout of a module's ``weight``."""
    if isinstance(mod, torch.nn.Linear):
        return (1, 0)
    if isinstance(mod, torch.nn.Conv2d):
        return (2, 3, 1, 0)
    return None


def flax_layout_perm(model, name: str) -> Optional[tuple]:
    """The permutation ``p`` with ``param.permute(p)`` in flax's layout
    for the parameter ``name`` of a model :func:`flax_param_order` maps
    (None where the layouts agree, and for any other model)."""
    from chainermn_torch.models.mlp import MLP
    from chainermn_torch.models.transformer import TransformerLM
    from chainermn_torch.models.vit import ViT

    owner, _, attr = name.rpartition(".")
    if attr != "weight" or not isinstance(model, (MLP, TransformerLM, ViT)):
        return None
    return _layout_perm(model.get_submodule(owner))


def block_param_map(block) -> Dict[str, tuple]:
    """A transformer block's parameters → ``{torch name: (flax path
    within the block, permutation into flax's layout)}`` (the inverse
    view: ``flax_leaf.permute(perm)`` is the torch tensor, a Dense
    kernel's transpose)."""
    out = {}
    for name, _ in block.named_parameters():
        owner, _, attr = name.rpartition(".")
        mod = block.get_submodule(owner) if owner else block
        perm = _layout_perm(mod) if attr == "weight" else None
        out[name] = (_flax_leaf(block, owner, attr), perm)
    return out


def flax_params(model) -> Dict:
    """The inverse of the converters for a model
    :func:`flax_param_order` maps: its trainable parameters as the flax
    ``params`` tree (nested dicts by flax path), each in flax's layout (a
    detached view of the parameter: a Dense kernel is ``weight.t()``).
    :func:`~chainermn_torch.models.transformer.stack_lm_blocks` takes a
    TransformerLM's; ``params_from_flax(model, unstack_lm_blocks(tree))``
    (numpy leaves) converts a stacked tree back."""
    out: Dict = {}
    for name, p in flax_param_order(model):
        owner, _, attr = name.rpartition(".")
        path = _flax_leaf(model, owner, attr)
        perm = flax_layout_perm(model, name)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = p.detach().permute(perm) if perm else p.detach()
    return out


def stacked_params_from_flax(tree: Mapping, device=None) -> Dict:
    """A flax ``params`` tree with numpy leaves (the JAX model's, stacked
    by its ``stack_lm_blocks`` or not) → the same tree of f32 tensors on
    ``device``: the tree form the FSDP step and
    :func:`~chainermn_torch.models.transformer.make_lm_fsdp_scan_loss`
    take (flax's layout is the tree form's own)."""
    if isinstance(tree, Mapping):
        return {k: stacked_params_from_flax(v, device)
                for k, v in tree.items()}
    t = _t(tree)
    return t if device is None else t.to(device)


def _tree_leaf(tree: Mapping, path) -> torch.Tensor:
    for k in path:
        tree = tree[k]
    return tree


def module_flax_tree(module: torch.nn.Module, state: Optional[Mapping] = None,
                     device=None) -> Dict:
    """``module``'s parameters (or ``state``, a state dict of its names)
    as the flax-layout tree that :func:`block_param_map` names: new
    contiguous f32 tensors on ``device`` (default: where they are)."""
    state = state if state is not None else dict(module.named_parameters())
    out: Dict = {}
    for name, (path, perm) in block_param_map(module).items():
        t = state[name].detach()
        t = (t.permute(perm) if perm else t).contiguous().float()
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t if device is None else t.to(device)
    return out


def _from_tree(names: Mapping, tree: Mapping) -> Dict[str, torch.Tensor]:
    out = {}
    for name, (path, perm) in names.items():
        t = _tree_leaf(tree, path)
        out[name] = t.permute(perm) if perm else t
    return out


def module_params_from_flax(module: torch.nn.Module,
                            tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax-layout tree (:func:`module_flax_tree`'s form; tensors) →
    ``module``'s parameters by name, each a view of its leaf in the
    module's layout."""
    return _from_tree(block_param_map(module), tree)


def flax_tree_apply(module: torch.nn.Module):
    """``(tree, *args) -> module(*args)`` with the module's parameters
    read from a flax-layout tree (``torch.func.functional_call``): the
    pipelines' ``(params, h) -> h`` stage form over a port module, and the
    FSDP scan's layer. The module only gives the computation; it may live
    on the meta device."""
    from torch.func import functional_call

    names = block_param_map(module)

    def fn(tree, *args):
        return functional_call(module, _from_tree(names, tree), args)

    return fn


def stage_stack_from_flax(tree: Mapping, rank: int, device=None) -> Dict:
    """The interleaved pipeline's ``[V, S, ...]`` stage stack (numpy
    leaves, JAX's arrangement of its ``[N, ...]`` logical stages) → rank
    ``rank``'s ``[V, ...]`` chunks as f32 tensors on ``device``: logical
    stages ``v·S + rank``."""
    if isinstance(tree, Mapping):
        return {k: stage_stack_from_flax(v, rank, device)
                for k, v in tree.items()}
    t = _t(np.asarray(tree)[:, rank])
    return t if device is None else t.to(device)
