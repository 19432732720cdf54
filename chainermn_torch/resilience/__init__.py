"""Resilience of the port: what the Trainer calls.

Preemption (a SIGTERM/SIGINT flag the loop polls) and the exit-status
contract. Chaos injection, the peer-death watchdog, the supervisor's
restart loop, elastic resume and peer replication wait for ROADMAP.md
queue 1 item 9; the Trainer refuses their environment variables.
"""

from chainermn_torch.resilience.preemption import (PREEMPTED_EXIT_CODE,
                                                   PreemptionGuard, guard,
                                                   install_preemption_handler)
from chainermn_torch.resilience.supervisor import (
    ABORTED_EXIT_CODE, BUDGET_EXHAUSTED_EXIT_CODE, main_exit_code)

__all__ = ["PREEMPTED_EXIT_CODE", "ABORTED_EXIT_CODE",
           "BUDGET_EXHAUSTED_EXIT_CODE", "PreemptionGuard", "guard",
           "install_preemption_handler", "main_exit_code"]
