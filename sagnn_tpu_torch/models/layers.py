"""Parameter initialisers and small layers; the port's copy of the parts of
`sagnn_tpu/models/layers.py` that the model uses.

Initialisers match TF1: glorot/xavier uniform with TF's fan computation
(`_compute_fans`): for an N-D shape, receptive_field = prod(shape[:-2]),
fan_in = shape[-2]*rf, fan_out = shape[-1]*rf. This matters for the
[g, U, D] embedding tables (NNLayers.py:47-50). Draws come from an explicit
`torch.Generator`, so the values differ from `jax.random`'s for the same
seed; tests hand both packages the same numpy weights instead.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

import torch


def tf_glorot_uniform(gen: torch.Generator, shape: Sequence[int],
                      device: torch.device | str = "cpu",
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    shape = tuple(shape)
    if len(shape) < 1:
        fan_in = fan_out = 1
    elif len(shape) == 1:
        fan_in = fan_out = shape[0]
    else:
        rf = math.prod(shape[:-2]) if len(shape) > 2 else 1
        fan_in = shape[-2] * rf
        fan_out = shape[-1] * rf
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return (u * (2.0 * limit) - limit).to(device)


def scalar_as(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype` where that is a 16-bit float type, as JAX
    rounds a Python scalar (a weak type) to the array's dtype before a
    bf16 op; PyTorch would apply the scalar unrounded. Other dtypes get
    `value` as given (f32 ops round it to f32 either way)."""
    if dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(value, dtype=dtype))
    return value


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """NNLayers.py:136: maximum(leaky*data, data)."""
    return torch.maximum(scalar_as(slope, x.dtype) * x, x)


def l2_sum(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Σ ||p||² over tensors (NNLayers.Regularize method='L2', 168-174)."""
    return sum(torch.sum(p * p) for p in tensors)
