"""``repro_torch.train`` — optimizers and the train step of the port
(port of ``repro.train``)."""
from .optimizer import adafactor, adamw, cosine_schedule
from .step import TrainState, init_train_state, make_train_step

__all__ = ["adamw", "adafactor", "cosine_schedule", "TrainState",
           "make_train_step", "init_train_state"]
