"""The LM of the port (the JAX package's `models/`, every family): configs
in `repro_torch.configs`, parameters in `params`, primitives in `layers`,
the MoE FFN in `moe`, RWKV6's mixing in `rwkv6`, hymba's SSM branch in
`mamba`, the forward and loss in `model`, the KV-cache decode path in
`decode`, the step builders in `steps`."""
from . import decode, layers, mamba, model, moe, params, rwkv6, steps
from .model import RunConfig, forward, lm_loss
from .params import count_params, init_params, param_pspecs, param_shapes

__all__ = ["decode", "layers", "mamba", "model", "moe", "params", "rwkv6",
           "steps", "RunConfig",
           "forward", "lm_loss", "count_params", "init_params",
           "param_pspecs", "param_shapes"]
