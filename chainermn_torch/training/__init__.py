"""Training of the port: the train and eval steps, the updater and
trainer loop, the evaluator and the reports."""

from chainermn_torch.training.evaluator import Evaluator
from chainermn_torch.training.reports import (LogReport, PrintReport,
                                              ReductionReport)
from chainermn_torch.training.step import (classifier_loss,
                                           make_data_parallel_train_step,
                                           make_eval_step)
from chainermn_torch.training.trainer import (StandardUpdater, Trainer,
                                              default_converter)

__all__ = ["classifier_loss", "make_data_parallel_train_step",
           "make_eval_step", "default_converter", "StandardUpdater",
           "Trainer", "Evaluator", "LogReport", "PrintReport",
           "ReductionReport"]
