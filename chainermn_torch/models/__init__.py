"""Models of the port."""

from chainermn_torch.models.mlp import MLP
from chainermn_torch.models.resnet import (CifarResNet, ResNet, ResNet18,
                                           ResNet34, ResNet50, ResNet101,
                                           ResNet152)
from chainermn_torch.models.transformer import (TransformerBlock,
                                                TransformerLM, compute_copy,
                                                generate, lm_loss_with_aux)

__all__ = ["MLP", "ResNet", "ResNet18", "ResNet34", "ResNet50",
           "ResNet101", "ResNet152", "CifarResNet", "TransformerLM",
           "TransformerBlock", "generate", "compute_copy",
           "lm_loss_with_aux"]
