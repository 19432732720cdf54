"""synthesis — collective-algorithm synthesis from communication
sketches over the multi-tier Topology.

Counterpart of ``chainermn_tpu/synthesis/``. schedtune
(:mod:`chainermn_torch.tuning`) tunes KNOBS over the fixed reducers; this
package widens the search to PROGRAMS: a sketch IR of per-tier primitive
steps (:mod:`.sketch`), a validity checker, a deterministic enumerator, an
alpha-beta cost walker with exact per-tier wire accounting, and a
compiler (:mod:`.compiler`) lowering validated programs to the
:class:`SynthesizedReducer` over per-tier sub-communicators, registered
as strategy ``'synth'``, scored by the tuner beside the fixed reducers,
and persisted and consumed through the same profile DB →
``create_multi_node_optimizer(tune=...)`` path. One CLI:
``python -m chainermn_torch.tools.synth``.
"""

from chainermn_torch.synthesis.compiler import SynthesizedReducer
from chainermn_torch.synthesis.sketch import (QUANT_WIRES, STEP_OPS, Program,
                                              Step, check_program,
                                              enumerate_programs,
                                              program_cost_us,
                                              program_wire_bytes)

__all__ = [
    "Step",
    "Program",
    "STEP_OPS",
    "QUANT_WIRES",
    "check_program",
    "enumerate_programs",
    "program_cost_us",
    "program_wire_bytes",
    "SynthesizedReducer",
]
