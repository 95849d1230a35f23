"""The port's training path (counterpart of ``repro.train``)."""
from .step import TrainConfig, loss_fn, make_train_step  # noqa: F401
from .loop import Trainer  # noqa: F401
