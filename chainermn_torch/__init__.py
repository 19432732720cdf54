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
``mutable=("batch_stats",)``, with the native prefetching loader.
"""

from chainermn_torch.comm import CommunicatorBase, create_communicator
from chainermn_torch.datasets import create_empty_dataset, scatter_dataset
from chainermn_torch.device import resolve_device
from chainermn_torch.extensions import create_multi_node_evaluator
from chainermn_torch.iterators import (create_multi_node_iterator,
                                       create_synchronized_iterator)
from chainermn_torch.links import MultiNodeBatchNormalization
from chainermn_torch.models import MLP, CifarResNet, ResNet50
from chainermn_torch.models.transformer import (TransformerLM, generate,
                                                lm_loss_with_aux)
from chainermn_torch.ops.fused_ce import fused_lm_loss
from chainermn_torch.optimizers import create_multi_node_optimizer
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
           "create_synchronized_iterator", "create_multi_node_evaluator"]
