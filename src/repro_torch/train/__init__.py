from . import train_step, trainer
from .train_step import build_train_step, make_state
from .trainer import Trainer, TrainerConfig
