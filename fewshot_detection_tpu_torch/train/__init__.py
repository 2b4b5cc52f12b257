from .optim import init_momentum, lr_schedule, neg_ratio_lr_factor, sgd_update
from .trainer import MetaTrainer, PlainTrainer

__all__ = [
    "init_momentum",
    "lr_schedule",
    "neg_ratio_lr_factor",
    "sgd_update",
    "MetaTrainer",
    "PlainTrainer",
]
