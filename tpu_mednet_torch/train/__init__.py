"""Training of the port: optimizer config, train state, steps, checkpoints
and the Trainer loop."""

from tpu_mednet_torch.train.checkpoint import CheckpointManager, load_for_inference
from tpu_mednet_torch.train.loop import NonFiniteError, Trainer
from tpu_mednet_torch.train.optim import OptimizerConfig
from tpu_mednet_torch.train.state import TrainState, create_train_state, param_count
from tpu_mednet_torch.train.step import make_eval_step, make_predict_step, make_train_step

__all__ = ["CheckpointManager", "NonFiniteError", "OptimizerConfig", "Trainer",
           "TrainState", "create_train_state", "load_for_inference", "make_eval_step",
           "make_predict_step", "make_train_step", "param_count"]
