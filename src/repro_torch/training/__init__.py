"""Training of the port's models (``repro/training``): the hand-rolled
optimizers, gradient compression, the train step and the fault-tolerant
trainer."""
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_step import (TrainConfig, TrainState,
                                             init_train_state,
                                             make_train_step)
from repro_torch.training.trainer import (FailureInjector, Trainer,
                                          TrainerConfig, run_with_restarts)

__all__ = ["OptimizerConfig", "TrainConfig", "TrainState",
           "init_train_state", "make_train_step", "FailureInjector",
           "Trainer", "TrainerConfig", "run_with_restarts"]
