"""Training of the port: the train and eval steps, the updater and
trainer loop, the evaluator, the reports and the profiler window."""

from chainermn_torch.training.evaluator import Evaluator
from chainermn_torch.training.profiling import Profile
from chainermn_torch.training.reports import (CheckpointReport, LogReport,
                                              PrintReport, ReductionReport,
                                              TuningReport)
from chainermn_torch.training.step import (
    classifier_loss, init_expert_parallel_state,
    make_data_parallel_train_step, make_eval_step,
    make_expert_parallel_train_step)
from chainermn_torch.training.trainer import (StandardUpdater, Trainer,
                                              default_converter)

__all__ = ["classifier_loss", "make_data_parallel_train_step",
           "make_eval_step", "init_expert_parallel_state",
           "make_expert_parallel_train_step", "default_converter", "StandardUpdater",
           "Trainer", "Evaluator", "LogReport", "PrintReport",
           "ReductionReport", "TuningReport", "CheckpointReport",
           "Profile"]
