"""The compute-dtype policy constant (counterpart of the JAX package's
``dtypes.py``): params and accumulations in float32, conv inputs and
weights in bfloat16."""

import torch

DEFAULT_DTYPE = torch.bfloat16
