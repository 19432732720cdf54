"""Models of the port."""

from chainermn_torch.models.transformer import (TransformerBlock,
                                                TransformerLM, compute_copy,
                                                generate, lm_loss_with_aux)

__all__ = ["TransformerLM", "TransformerBlock", "generate", "compute_copy",
           "lm_loss_with_aux"]
