"""dlint for the port: distributed-correctness static analysis of
``chainermn_torch/``.

Counterpart of ``chainermn_tpu/analysis/``, with the reference's engine
and rule IDs and its own copy of every module (it imports nothing of JAX
or of ``chainermn_tpu``; the source passes import no torch either, so a
lint of sources is a bare-AST run). Where a rule depends on the framework
only through a set of names, the port's set is the JAX package's plus
what the port calls — ``torch.distributed``'s collectives,
``new_group`` (collective over the whole world), the communicator's flat
reducers and ``host_barrier``, the eager receives ``recv_tree``/
``try_recv_obj``/``exchange``, the CUDA syncs, the key API of
``serving/sampling.py`` and ``ops/dropout.py`` — so code in either idiom
trips a rule on the same line.

One CLI, ``python -m chainermn_torch.tools.dlint``:

* **AST passes** (:mod:`.ast_passes`) run per file over the port's
  sources: DL101-DL107, DL109-DL112, DL117, DL123, DL124.
* **Project passes** (:mod:`.sequence`, :mod:`.locks`,
  :mod:`.dataflow_rules`) run once over a whole-program
  :class:`~.callgraph.Project`: DL113, DL114 (send/recv channel cycles),
  DL115, DL116 (locks), and the dataflow rules DL118 (key reuse), DL120
  (set iteration feeding collectives or ``new_group``), DL121 (host sync
  in decode) and DL125 (draft/target key confusion).
* **Trace passes** (:mod:`.trace_passes`) read a ``torch.profiler``
  trace, where the JAX package reads compiled HLO: DL201 (gradient
  all-reduce overlaps backward), DL202 (NCCL collectives per step),
  DL203 (pipeline hops hide compute), DL204 (co-live FSDP gathers, from
  the memory events) and DL205 (the quantized wire's dtype).

Not registered (:data:`.core.NOT_APPLICABLE`, with reasons): DL108 and
DL122 (the port compiles and traces nothing) and DL119 (nothing donates a
buffer). :data:`.core.NOT_YET_PORTED` is empty: every HLO pass has its
trace form. docs/static_analysis_torch.md gives each
rule's port form with a minimal failing example. Suppress an intentional
finding with ``# dlint: disable=RULE — rationale`` on the flagged line,
the line above, or the first line of the enclosing statement.
"""

from chainermn_torch.analysis import ast_passes  # noqa: F401  (DL1xx)
from chainermn_torch.analysis import dataflow_rules  # noqa: F401
from chainermn_torch.analysis import locks  # noqa: F401  (DL115/DL116)
from chainermn_torch.analysis import sequence  # noqa: F401  (DL113/DL114)
from chainermn_torch.analysis.callgraph import (  # noqa: F401
    DEFAULT_CALL_DEPTH,
    Project,
)
from chainermn_torch.analysis.core import (  # noqa: F401
    Finding,
    LintRun,
    NOT_APPLICABLE,
    NOT_YET_PORTED,
    RULES,
    Suppression,
    iter_python_files,
    lint_file,
    lint_paths,
    lint_source,
    run_lint,
    run_lint_sources,
)
from chainermn_torch.analysis.output import (  # noqa: F401
    filter_new,
    fingerprints,
    from_sarif,
    load_baseline,
    to_sarif,
    write_baseline,
)
from chainermn_torch.analysis.dataflow import (  # noqa: F401
    Analysis,
    DefUse,
    Definition,
    FlowWalker,
    ParamSummary,
)
from chainermn_torch.analysis.trace_passes import (  # noqa: F401
    check_collective_budget,
    check_dp_overlap,
    check_fsdp_gather_liveness,
    check_pipeline_permute_overlap,
    check_quantized_wire_dtype,
    collective_records,
    dp_overlap_fraction,
    nccl_dtype,
    nccl_kind,
)
