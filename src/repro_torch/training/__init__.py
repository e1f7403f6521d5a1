from repro_torch.training.optim import adamw_init, adamw_update
from repro_torch.training.trainer import TrainState, init_state, make_train_step

__all__ = ["adamw_init", "adamw_update", "TrainState", "init_state",
           "make_train_step"]
