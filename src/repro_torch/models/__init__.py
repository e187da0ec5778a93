"""The dense LM forward of the port (the JAX package's `models/`, dense
family): configs in `repro_torch.configs`, parameters in `params`,
primitives in `layers`, the forward and loss in `model`."""
from . import layers, model, params, steps
from .model import RunConfig, forward, lm_loss
from .params import count_params, init_params

__all__ = ["layers", "model", "params", "steps", "RunConfig", "forward",
           "lm_loss", "count_params", "init_params"]
