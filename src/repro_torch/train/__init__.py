"""Training: checkpoints (both halves), the optimizers and the train step."""
from . import checkpoint, optimizer, trainer  # noqa: F401
from .optimizer import OptConfig  # noqa: F401
from .trainer import TrainConfig, init_train_state, make_train_step  # noqa: F401
