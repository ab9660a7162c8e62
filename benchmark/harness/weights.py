"""Initial weights made from the seed on the device, handed alike to the
program and to the reference: TF glorot uniform for weights and tables,
zeros for biases and shifts, ones for layer-norm scales (the model's
initialisers), drawn as one uniform block per device call."""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.selfgnn import glorot_bound, init_kind, \
    param_shapes


def weight_seed(seed: int) -> int:
    return (int(seed) * 2 + 1) % (2 ** 63)


def mask_seed(seed: int) -> int:
    """The seed of the training step's dropout generator."""
    return (int(seed) * 2 + 2) % (2 ** 63)


def make_weights(model: dict, num_users: int, num_items: int, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{key: f32 tensor on `device`} for a model config, from `seed`: one
    torch.rand of every glorot leaf's elements, cut into the leaves and
    scaled to each one's bound."""
    shapes = param_shapes(model, num_users, num_items)
    gen = torch.Generator(device=device).manual_seed(weight_seed(seed))
    drawn = [k for k in shapes if init_kind(k) == "glorot"]
    total = sum(math.prod(shapes[k]) for k in drawn)
    flat = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for key in drawn:
        n = math.prod(shapes[key])
        bound = glorot_bound(shapes[key])
        out[key] = (flat[at:at + n] * (2 * bound) - bound).view(shapes[key])
        at += n
    del flat
    for key, shape in shapes.items():
        if key not in out:
            fill = torch.ones if init_kind(key) == "ones" else torch.zeros
            out[key] = fill(shape, device=device)
    return {k: out[k] for k in shapes}
