"""schedtune — the overlap-driven collective-schedule tuner of the port.

Counterpart of ``chainermn_tpu/tuning/``. The search sweeps the reducer
knobs (``bucket_bytes``, bucket emission order, ``double_buffering``,
strategy) and the synthesized programs of :mod:`chainermn_torch.synthesis`
against an overlap measurement and an explicit multi-tier
:class:`Topology` cost model, and persists the winner in a per-topology
JSON profile DB (the JAX package's format and path) that
``create_multi_node_optimizer(tune=...)`` and
``AutoReducer(profile=...)`` consume. Two sources of the overlap: the
canned scheduled-HLO emulator (:func:`tune_canned`, anywhere), and a
``torch.profiler`` trace of the real data-parallel step on N ≥ 2 CUDA
ranks (``python -m chainermn_torch.tools.schedtune --trace``).
``measure_strategies(db=...)`` sweeps on the card feed the same DB.
"""

from chainermn_torch.tuning.canned import (canned_compile_fn,
                                           canned_schedule_hlo)
from chainermn_torch.tuning.profile_db import (ProfileDB, SchedulePlan,
                                               default_db_path,
                                               model_key_for)
from chainermn_torch.tuning.topology import (Tier, Topology, single_tier,
                                             two_tier)
from chainermn_torch.tuning.tuner import (Candidate, TraceEvidence,
                                          TuningResult, default_candidates,
                                          default_flat_candidate,
                                          estimate_comm_us, score_candidate,
                                          tune, tune_canned)

__all__ = ["canned_compile_fn", "canned_schedule_hlo", "ProfileDB",
           "SchedulePlan", "default_db_path", "model_key_for", "Tier",
           "Topology", "single_tier", "two_tier", "Candidate",
           "TraceEvidence", "TuningResult", "default_candidates",
           "default_flat_candidate", "estimate_comm_us", "score_candidate",
           "tune", "tune_canned"]
