"""chainermn_torch — the PyTorch/CUDA port of chainermn_tpu.

It imports nothing of JAX or of ``chainermn_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; without a GPU and
without that explicit choice they raise. Ported so far: serving the
dense TransformerLM (hand-written CUDA flash-attention forward,
``csrc/flash_fwd.cu``) and training it through
``create_communicator`` / ``create_multi_node_optimizer`` /
``make_data_parallel_train_step`` (flash-attention backward
``csrc/flash_bwd.cu``, fused LM-head cross-entropy ``csrc/fused_ce.cu``).
"""

from chainermn_torch.comm import create_communicator
from chainermn_torch.device import resolve_device
from chainermn_torch.models.transformer import (TransformerLM, generate,
                                                lm_loss_with_aux)
from chainermn_torch.ops.fused_ce import fused_lm_loss
from chainermn_torch.optimizers import create_multi_node_optimizer
from chainermn_torch.serving.engine import Engine, EngineConfig
from chainermn_torch.serving.kv_cache import ServingStep
from chainermn_torch.training import make_data_parallel_train_step

__all__ = ["resolve_device", "TransformerLM", "generate", "Engine",
           "EngineConfig", "ServingStep", "create_communicator",
           "create_multi_node_optimizer", "make_data_parallel_train_step",
           "lm_loss_with_aux", "fused_lm_loss"]
