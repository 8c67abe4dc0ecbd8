from . import channels, hyperparameters, metrics  # noqa: F401
