"""Training substrate: AdamW, schedules, the train step, and the loop."""
from repro_torch.training.optim import OptimConfig, adamw_init, adamw_update
from repro_torch.training.train import make_train_step, train_loop

__all__ = ["OptimConfig", "adamw_init", "adamw_update", "make_train_step",
           "train_loop"]
