"""The LM of the port (the JAX package's `models/`, dense family and the
VLM backbone): configs in `repro_torch.configs`, parameters in `params`,
primitives in `layers`, the forward and loss in `model`, the KV-cache
decode path in `decode`, the step builders in `steps`."""
from . import decode, layers, model, params, steps
from .model import RunConfig, forward, lm_loss
from .params import count_params, init_params

__all__ = ["decode", "layers", "model", "params", "steps", "RunConfig",
           "forward", "lm_loss", "count_params", "init_params"]
