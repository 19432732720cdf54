"""chainermn_torch — the PyTorch/CUDA port of chainermn_tpu.

It imports nothing of JAX or of ``chainermn_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; without a GPU and
without that explicit choice they raise. This slice ports the serving
path of the dense TransformerLM, with a hand-written CUDA flash-attention
forward for the prefill (``csrc/flash_fwd.cu``).
"""

from chainermn_torch.device import resolve_device
from chainermn_torch.models.transformer import (TransformerLM, generate)
from chainermn_torch.serving.engine import Engine, EngineConfig
from chainermn_torch.serving.kv_cache import ServingStep

__all__ = ["resolve_device", "TransformerLM", "generate", "Engine",
           "EngineConfig", "ServingStep"]
