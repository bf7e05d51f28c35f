"""The training path: ``make_train_step`` (baseline and Pot) and the
deterministic data-parallel ``make_pot_dp_step`` over ``TrainState``."""

from repro_torch.train.train_step import (TrainState, init_state, loss_fn,
                                          make_pot_dp_step, make_train_step)

__all__ = ["TrainState", "init_state", "make_train_step",
           "make_pot_dp_step", "loss_fn"]
