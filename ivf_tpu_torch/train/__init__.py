"""Training of the port (port of ``ivf_tpu/train``): metrics, optimizers,
LR schedules, the train state and the train / eval loops."""

from ivf_tpu_torch.train.loop import evaluate, fit, make_eval_step, make_train_step, train_epoch
from ivf_tpu_torch.train.metrics import AverageMeter, topk_accuracy
from ivf_tpu_torch.train.optim import Optimizer, OptState, build_optimizer, get_learning_rate, set_learning_rate
from ivf_tpu_torch.train.schedule import PatienceHalving, ReduceLROnPlateau
from ivf_tpu_torch.train.state import TrainState, create_train_state, step_generator

__all__ = [
    "AverageMeter",
    "OptState",
    "Optimizer",
    "PatienceHalving",
    "ReduceLROnPlateau",
    "TrainState",
    "build_optimizer",
    "create_train_state",
    "evaluate",
    "fit",
    "get_learning_rate",
    "make_eval_step",
    "make_train_step",
    "set_learning_rate",
    "step_generator",
    "topk_accuracy",
    "train_epoch",
]
