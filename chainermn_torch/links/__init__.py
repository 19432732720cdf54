"""Links (layers) of the port: counterpart of ``chainermn_tpu/links/``:
``MultiNodeBatchNormalization`` (ROADMAP.md queue 1 item 5) and
``MultiNodeChainList`` (item 7)."""

from chainermn_torch.links.batch_normalization import (
    MultiNodeBatchNormalization, batch_norm_layers, frozen_batch_stats)
from chainermn_torch.links.chain_list import MultiNodeChainList

__all__ = ["MultiNodeBatchNormalization", "MultiNodeChainList",
           "batch_norm_layers", "frozen_batch_stats"]
