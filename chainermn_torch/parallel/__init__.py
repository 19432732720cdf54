"""Parallelism beyond data parallelism: the TransformerLM's intra-layer
forms — sequence (ring, ring-flash, Ulysses), tensor (Megatron's
column/row pair and the vocabulary-parallel loss) and expert
(Switch/GShard MoE) parallelism — and the micro-batched pipelines (plain
and interleaved 1F1B, heterogeneous stages over a flat wire, and
branching DAGs).

Counterpart of ``chainermn_tpu/parallel/``. Each function or module takes
the communicator over the mesh axis JAX names
(``DistributedCommunicator.over_mesh(mesh, axes=(name,))``) where JAX
takes the axis name; a pipeline's communicator is over the ``stage``
ranks, one process a stage.
"""

from .branching import (BranchingPipeline, branching_pipeline_apply,
                        branching_pipeline_value_and_grad)
from .expert_parallel import ExpertParallelMLP, switch_dispatch
from .hetero_pipeline import (HeteroPipeline,
                              hetero_pipeline_1f1b_value_and_grad,
                              hetero_pipeline_apply)
from .pipeline import (build_interleaved_schedule,
                       pipeline_1f1b_value_and_grad, pipeline_apply,
                       pipeline_interleaved_1f1b_value_and_grad,
                       stack_stage_params)
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
    "pipeline_apply",
    "pipeline_1f1b_value_and_grad",
    "pipeline_interleaved_1f1b_value_and_grad",
    "build_interleaved_schedule",
    "stack_stage_params",
    "HeteroPipeline",
    "hetero_pipeline_1f1b_value_and_grad",
    "hetero_pipeline_apply",
    "BranchingPipeline",
    "branching_pipeline_value_and_grad",
    "branching_pipeline_apply",
    "ColumnParallelDense",
    "RowParallelDense",
    "TensorParallelMLP",
    "vocab_parallel_cross_entropy",
    "ExpertParallelMLP",
    "switch_dispatch",
]
