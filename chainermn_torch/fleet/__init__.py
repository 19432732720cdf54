"""chainermn_torch.fleet — many serving engines, one front door.

Counterpart of ``chainermn_tpu.fleet``, with its names.

Two composition patterns over ``serving.Engine``:

* **Replicated** (``router.Router``): N identical engines behind a
  load-aware, session-affine router with queue-depth backpressure and
  heartbeat-driven replica health — a dead replica's in-flight work
  re-queues onto survivors with client futures intact.
* **Disaggregated** (``pools.DisaggregatedFleet``): m prefill pools
  run ``prefill_chunk`` to completion and hand populated KV slots to
  n decode pools (least-depth destination choice with the saturated-
  survivor precheck) through the manifest-versioned ``handoff`` codec
  — raw f32 (bitwise), blockwise int8 at ~0.254× the wire bytes, or
  the streamed format-5 per-layer chunk frames — over a ``transport``
  (in-process queue pair, or seq/SHA-framed object-plane frames
  between real processes, including the TCP
  ``comm.socket_plane.SocketObjectPlane``) — synchronously or on the
  async conveyor's bounded worker queue.

``reports.FleetReport`` aggregates per-replica telemetry honestly
(pooled-sample percentiles, token-weighted ratios) plus the transport
wire-health counters; ``health.FleetHealth`` is the per-replica
liveness verdict.
"""

from chainermn_torch.fleet.handoff import (HANDOFF_WIRE_FORMATS,
                                         HandoffError, decode_handoff,
                                         decode_handoff_streamed,
                                         encode_handoff,
                                         encode_handoff_streamed,
                                         handoff_payload_bytes,
                                         streamed_chunk_sid,
                                         streamed_parent_sid,
                                         streamed_wire_bytes)
from chainermn_torch.fleet.health import FleetHealth
from chainermn_torch.fleet.pools import (DecodePool, DisaggregatedFleet,
                                       PrefillPool, Stream,
                                       StreamAssembler)
from chainermn_torch.fleet.reports import FleetReport
from chainermn_torch.fleet.rollout import (DEFAULT_CHUNK_BYTES,
                                         RolloutController, RolloutError)
from chainermn_torch.fleet.router import EngineReplica, Router
from chainermn_torch.fleet.transport import (Arrival, InProcessTransport,
                                           LoopbackPlane,
                                           ObjectPlaneTransport,
                                           PairedTransport,
                                           TransportError)

__all__ = [
    "HandoffError", "encode_handoff", "decode_handoff",
    "encode_handoff_streamed", "decode_handoff_streamed",
    "streamed_wire_bytes", "streamed_chunk_sid", "streamed_parent_sid",
    "handoff_payload_bytes", "HANDOFF_WIRE_FORMATS",
    "FleetHealth", "FleetReport",
    "Stream", "PrefillPool", "DecodePool", "DisaggregatedFleet",
    "StreamAssembler",
    "EngineReplica", "Router",
    "RolloutController", "RolloutError", "DEFAULT_CHUNK_BYTES",
    "TransportError", "Arrival", "InProcessTransport",
    "ObjectPlaneTransport", "LoopbackPlane", "PairedTransport",
]
