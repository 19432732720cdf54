"""Models of the port."""

from chainermn_torch.models.transformer import (TransformerBlock,
                                                TransformerLM, generate)

__all__ = ["TransformerLM", "TransformerBlock", "generate"]
