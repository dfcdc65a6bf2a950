from beso_tpu_torch.train.checkpoint import restore_train_state, save_train_state
from beso_tpu_torch.train.trainer import (TrainState, Trainer, evaluate_mse,
                                          make_fused_train_steps, make_optimizer,
                                          make_train_step, process_batch, step_lr_schedule,
                                          step_noise)

__all__ = ["TrainState", "Trainer", "evaluate_mse", "make_fused_train_steps",
           "make_optimizer", "make_train_step", "process_batch", "restore_train_state",
           "save_train_state", "step_lr_schedule", "step_noise"]
