"""Intra-layer parallelism of the TransformerLM: sequence (ring,
ring-flash, Ulysses), tensor (Megatron's column/row pair and the
vocabulary-parallel loss) and expert (Switch/GShard MoE) parallelism.

Counterpart of ``chainermn_tpu/parallel/``'s names of these kinds. Each
function or module takes the communicator over the mesh axis JAX names
(``DistributedCommunicator.over_mesh(mesh, axes=(name,))``). The
pipelines (``pipeline``, ``hetero_pipeline``, ``branching``) are not in
this package yet (ROADMAP.md queue 1 item 10b).
"""

from .expert_parallel import ExpertParallelMLP, switch_dispatch
from .ring_attention import (local_attention_reference, ring_attention,
                             ring_flash_attention)
from .tensor_parallel import (ColumnParallelDense, RowParallelDense,
                              TensorParallelMLP,
                              vocab_parallel_cross_entropy)
from .ulysses import ulysses_attention

__all__ = [
    "ring_attention",
    "ring_flash_attention",
    "ulysses_attention",
    "local_attention_reference",
    "ColumnParallelDense",
    "RowParallelDense",
    "TensorParallelMLP",
    "vocab_parallel_cross_entropy",
    "ExpertParallelMLP",
    "switch_dispatch",
]
