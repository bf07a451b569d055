"""Training of the port: train state, and the train and eval steps."""

from tpu_mednet_torch.train.state import TrainState, create_train_state, param_count
from tpu_mednet_torch.train.step import make_eval_step, make_train_step

__all__ = ["TrainState", "create_train_state", "make_eval_step", "make_train_step",
           "param_count"]
