"""The training path: ``make_train_step`` (baseline and Pot) over
``TrainState``."""

from repro_torch.train.train_step import (TrainState, init_state, loss_fn,
                                          make_train_step)

__all__ = ["TrainState", "init_state", "make_train_step", "loss_fn"]
