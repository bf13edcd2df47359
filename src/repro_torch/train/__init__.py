from repro_torch.train.optimizer import (AdamWConfig, adamw_init, adamw_update,
                                         global_norm, lr_at, opt_state_dims)
from repro_torch.train.trainer import (TrainerApp, encode_state_on_device,
                                       init_state, make_train_step,
                                       state_dims)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "lr_at", "opt_state_dims", "TrainerApp", "encode_state_on_device",
           "init_state", "make_train_step", "state_dims"]
