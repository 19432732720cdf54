"""Training of the port."""

from chainermn_torch.training.step import (classifier_loss,
                                           make_data_parallel_train_step)

__all__ = ["classifier_loss", "make_data_parallel_train_step"]
