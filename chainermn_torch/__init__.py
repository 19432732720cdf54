"""chainermn_torch — the PyTorch/CUDA port of chainermn_tpu.

It imports nothing of JAX or of ``chainermn_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; without a GPU and
without that explicit choice they raise. Ported so far: serving the
dense TransformerLM (hand-written CUDA flash-attention forward,
``csrc/flash_fwd.cu``) and training it through
``create_communicator`` / ``create_multi_node_optimizer`` /
``make_data_parallel_train_step`` (flash-attention backward
``csrc/flash_bwd.cu``, fused LM-head cross-entropy ``csrc/fused_ce.cu``);
the MNIST MLP (config #1) end to end through ``scatter_dataset``, the
iterators, ``Trainer``, the multi-node evaluator and the reports
(``python -m chainermn_torch.examples.train_mnist``); ResNet-50 (config
#2, ``python -m chainermn_torch.examples.train_imagenet``) and the CIFAR
ResNet with ``MultiNodeBatchNormalization`` (config #3, ``python -m
chainermn_torch.examples.train_cifar``) through the step's
``mutable=("batch_stats",)``, with the native prefetching loader;
model parallelism through the differentiable point-to-point functions
(``chainermn_torch.functions``) and ``MultiNodeChainList`` (config #5,
``python -m chainermn_torch.examples.train_mnist_model_parallel``; the
eager variant ``train_mnist_eager_p2p``), several ranks on one GPU
through the host-staged ``non_cuda_aware`` communicator, and the LSTM
seq2seq with BPE, greedy and beam decoding and BLEU (config #4,
``python -m chainermn_torch.examples.train_seq2seq``); the ViT on the
non-causal flash kernels with dropout keys (the step's ``with_rng``), and
snapshots with consensus resume through ``MultiNodeCheckpointer`` and the
Trainer's emergency checkpoint (``python -m
chainermn_torch.examples.train_imagenet --model vit [--snapshot-every N]
[--resume]``); sub-communicators (``mesh``/``axes``, ``split``) and the
gradient reducers (``chainermn_torch.collectives``: flat, hierarchical,
quantized with error feedback, auto) behind ``create_multi_node_optimizer
(grad_reducer=, wire_format=)``, with ``ReductionReport``
(``train_mnist --grad-reducer/--wire-format``); ZeRO-1/2 sharded
training (``make_zero1_train_step``/``make_zero2_train_step``, flat or
bucketed, with any reducer) and LARS/LAMB, through ``python -m
chainermn_torch.examples.train_lm [--zero 1|2]`` and ``train_imagenet
--optimizer lars|lamb``.
"""

from chainermn_torch import functions
from chainermn_torch.collectives import make_grad_reducer
from chainermn_torch.comm import CommunicatorBase, create_communicator
from chainermn_torch.datasets import create_empty_dataset, scatter_dataset
from chainermn_torch.device import resolve_device
from chainermn_torch.extensions import (create_multi_node_checkpointer,
                                        create_multi_node_evaluator,
                                        install_global_except_hook)
from chainermn_torch.iterators import (create_multi_node_iterator,
                                       create_synchronized_iterator)
from chainermn_torch.links import (MultiNodeBatchNormalization,
                                   MultiNodeChainList)
from chainermn_torch.models import MLP, CifarResNet, ResNet50, ViT
from chainermn_torch.models.seq2seq import Seq2Seq
from chainermn_torch.models.transformer import (TransformerLM, generate,
                                                lm_loss_with_aux)
from chainermn_torch.ops.fused_ce import fused_lm_loss
from chainermn_torch.optimizers import (create_multi_node_optimizer,
                                        make_zero1_train_step,
                                        make_zero2_train_step, zero1_params,
                                        zero_layout_manifest)
from chainermn_torch.serving.engine import Engine, EngineConfig
from chainermn_torch.serving.kv_cache import ServingStep
from chainermn_torch.training import (make_data_parallel_train_step,
                                      make_eval_step)

__all__ = ["resolve_device", "TransformerLM", "MLP", "ResNet50",
           "CifarResNet", "MultiNodeBatchNormalization", "generate", "Engine",
           "EngineConfig", "ServingStep", "CommunicatorBase",
           "create_communicator", "create_multi_node_optimizer",
           "make_data_parallel_train_step", "make_eval_step",
           "lm_loss_with_aux", "fused_lm_loss", "scatter_dataset",
           "create_empty_dataset", "create_multi_node_iterator",
           "create_synchronized_iterator", "create_multi_node_evaluator",
           "MultiNodeChainList", "Seq2Seq", "functions", "ViT",
           "create_multi_node_checkpointer", "install_global_except_hook",
           "make_grad_reducer", "make_zero1_train_step",
           "make_zero2_train_step", "zero1_params", "zero_layout_manifest"]
