"""The asynchronous snapshot plane and manifest-driven resharding
(counterpart of ``chainermn_tpu/checkpointing/``):

* :class:`~chainermn_torch.checkpointing.async_plane.AsyncSnapshotPlane`:
  snapshots over :class:`~chainermn_torch.extensions.checkpoint.
  MultiNodeCheckpointer` whose step-thread cost is a device-side copy
  and the launch of its host copy; a writer thread publishes;
* :mod:`~chainermn_torch.checkpointing.reshard`: snapshots saved on one
  world restored onto another, the world-stacked error-feedback frames
  of the ZeRO steps regrouped.
"""

from chainermn_torch.checkpointing.async_plane import AsyncSnapshotPlane
from chainermn_torch.checkpointing.reshard import (default_leaf_resharder,
                                                   ef_frame_regroup,
                                                   leaf_coverage,
                                                   manifest_info,
                                                   mesh_axes, reshard_state,
                                                   saved_axes,
                                                   scan_snapshot_dir)

__all__ = [
    "AsyncSnapshotPlane",
    "default_leaf_resharder",
    "ef_frame_regroup",
    "leaf_coverage",
    "manifest_info",
    "mesh_axes",
    "reshard_state",
    "saved_axes",
    "scan_snapshot_dir",
]
