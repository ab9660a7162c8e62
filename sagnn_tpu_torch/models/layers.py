"""Parameter initialisers and small layers; the port of
`sagnn_tpu/models/layers.py`.

Initialisers match TF1: glorot/xavier uniform with TF's fan computation
(`_compute_fans`): for an N-D shape, receptive_field = prod(shape[:-2]),
fan_in = shape[-2]*rf, fan_out = shape[-1]*rf. This matters for the
[g, U, D] embedding tables (NNLayers.py:47-50). `tf_glorot_uniform` draws
from an explicit `torch.Generator`, so its values differ from
`jax.random`'s for the same seed; `models.selfgnn.init_params_jax` draws
JAX's own values (`utils/jax_random.py`) with the same bound.

The TF1 layer library (`activate`, `batch_norm`, `dropout`, `fc`;
NNLayers.py:80-181) is dead in the reference model and kept for
completeness, in plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

import torch


def glorot_limit(shape: Sequence[int]) -> float:
    """TF glorot uniform's bound sqrt(6 / (fan_in + fan_out)) for `shape`
    (JAX `tf_glorot_uniform`, layers.py:21-33)."""
    shape = tuple(shape)
    if len(shape) < 1:
        fan_in = fan_out = 1
    elif len(shape) == 1:
        fan_in = fan_out = shape[0]
    else:
        rf = math.prod(shape[:-2]) if len(shape) > 2 else 1
        fan_in = shape[-2] * rf
        fan_out = shape[-1] * rf
    return math.sqrt(6.0 / (fan_in + fan_out))


def tf_glorot_uniform(gen: torch.Generator, shape: Sequence[int],
                      device: torch.device | str = "cpu",
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    shape = tuple(shape)
    limit = glorot_limit(shape)
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


def activate(x: torch.Tensor, method: str, leaky: float = 0.1
             ) -> torch.Tensor:
    """The activation zoo of NNLayers.ActivateHelp (126-148); ValueError on
    an unknown method, as JAX raises."""
    if method == "relu":
        return torch.relu(x)
    if method == "sigmoid":
        return torch.sigmoid(x)
    if method == "tanh":
        return torch.tanh(x)
    if method == "softmax":
        return torch.softmax(x, dim=-1)
    if method == "leakyRelu":
        return leaky_relu(x, leaky)
    if method == "-1relu":
        return torch.clamp(x, min=-1.0)
    if method == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if method == "relu3":
        return torch.clamp(x, 0.0, 3.0)
    raise ValueError(f"Error Activation Function: {method}")


def batch_norm(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               ema_mean: torch.Tensor, ema_var: torch.Tensor, train: bool,
               decay: float = 0.5, eps: float = 1e-8):
    """NNLayers.BN (80-96): batch moments over axis 0 (biased variance)
    folded into an EMA (decay 0.5) in training, the EMA itself in
    evaluation. Returns (y, new_ema_mean, new_ema_var)."""
    if train:
        mean = x.mean(dim=0)
        var = x.var(dim=0, unbiased=False)
        new_mean = decay * ema_mean + (1 - decay) * mean
        new_var = decay * ema_var + (1 - decay) * var
    else:
        mean, var = ema_mean, ema_var
        new_mean, new_var = ema_mean, ema_var
    y = (x - mean) * torch.rsqrt(var + eps) * scale + shift
    return y, new_mean, new_var


def dropout(gen: torch.Generator, x: torch.Tensor, rate: float
            ) -> torch.Tensor:
    """Inverted dropout as tf.nn.dropout (NNLayers.Dropout, 177-181): each
    entry kept with probability 1 - rate, drawn from `gen` (on x's
    device), and scaled by 1 / (1 - rate)."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def fc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
       activation: str | None = None, leaky: float = 0.1) -> torch.Tensor:
    """NNLayers.FC (98-115): x @ w, the bias if given, the activation if
    named."""
    y = x @ w
    if b is not None:
        y = y + b
    if activation is not None:
        y = activate(y, activation, leaky)
    return y


def l2_sum(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Σ ||p||² over tensors (NNLayers.Regularize method='L2', 168-174)."""
    return sum(torch.sum(p * p) for p in tensors)
