"""Links (layers) of the port: counterpart of ``chainermn_tpu/links/``.

``MultiNodeBatchNormalization`` is ported (ROADMAP.md queue 1 item 5);
``MultiNodeChainList`` waits for item 7.
"""

from chainermn_torch.links.batch_normalization import (
    MultiNodeBatchNormalization, batch_norm_layers, frozen_batch_stats)

__all__ = ["MultiNodeBatchNormalization", "batch_norm_layers",
           "frozen_batch_stats"]
