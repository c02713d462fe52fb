"""Training of the port: the layer-decay AdamW, the train state and the
top-down train step."""
from .optim import OptimConfig, layer_decay_adamw, make_lr_schedule
from .state import TrainState, create_train_state
from .step import make_train_step
