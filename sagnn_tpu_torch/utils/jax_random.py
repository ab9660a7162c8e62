"""JAX's default PRNG (threefry2x32, `jax_threefry_partitionable` on, as in
jax 0.9) in plain PyTorch, so the port can draw the JAX package's own
initial values and dropout masks from a seed alone, on any device.

A key is a [2] int64 tensor on the CPU holding two uint32 words, JAX's
raw key (`np.asarray(jax.random.PRNGKey(s))`). Words ride in int64 and are
masked to 32 bits after every add and shift: `torch.uint32` has partial op
coverage, and `>>` on int32 is arithmetic. The draws run on `device`
(default the CPU) in blocks of `BLOCK` counters, so a draw of tens of
millions of values never holds more than one block's int64 temporaries.

What JAX computes, and this module with it:
  * `prng_key(seed)`: [0, seed mod 2^32] (JAX's 32-bit mode, its
    default: the seed is an int32 before `threefry_seed` splits it);
  * `split(key, n)`: key i is threefry2x32(key, (0, i));
  * `fold_in(key, d)`: threefry2x32(key, (0, d mod 2^32));
  * `random_bits(key, shape)`: for flat index j, the two words of
    threefry2x32(key, (j >> 32, j & 0xFFFFFFFF)) XORed;
  * `uniform(key, shape, minval, maxval)`: f = bitcast((bits >> 9) |
    0x3F800000) - 1 in [0, 1); then f * (maxval - minval) + minval
    rounded once to f32 (XLA's CPU backend emits a fused multiply-add;
    two roundings differ from it in about half the entries), then
    max(minval, .), with minval and maxval rounded to f32 first;
  * `bernoulli(key, p, shape)`: uniform(key, shape) < f32(p).

Integer ops do not round and the one float step is a single rounding, so
the CPU's and a card's draws are the same bits.
"""

from __future__ import annotations

import math
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
BLOCK = 1 << 22   # counters hashed at a time


def _words(key: torch.Tensor) -> Tuple[int, int]:
    k = [int(v) for v in key.reshape(2).tolist()]
    if not all(0 <= v <= M32 for v in k):
        raise ValueError(f"key words {k} are not uint32")
    return k[0], k[1]


def _key(w1: int, w2: int) -> torch.Tensor:
    return torch.tensor([w1, w2], dtype=torch.int64)


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter words (x1, x2) (int64 tensors
    of uint32 values) under the key (k1, k2): five groups of four rounds,
    a key injection after each (JAX `_threefry2x32_lowering`)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1.add_(x2).bitwise_and_(M32)
            x2 = ((x2 << r) | (x2 >> (32 - r))).bitwise_and_(M32)
            x2.bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x2.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(M32)
    return x1, x2


def prng_key(seed: int) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` in JAX's default 32-bit mode."""
    return _key(0, int(np.int64(seed)) & M32)


def split(key: torch.Tensor, n: int = 2,
          device: torch.device | str = "cpu") -> torch.Tensor:
    """`jax.random.split(key, n)`: [n, 2] keys (on the CPU, hashed on
    `device`)."""
    k1, k2 = _words(key)
    o1, o2 = threefry2x32(k1, k2,
                          torch.zeros(n, dtype=torch.int64, device=device),
                          torch.arange(n, dtype=torch.int64, device=device))
    return torch.stack([o1, o2], dim=1).cpu()


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`."""
    o1, o2 = threefry2x32(*_words(key), torch.tensor([0]),
                          torch.tensor([int(data) & M32]))
    return _key(int(o1), int(o2))


def _bit_blocks(key: torch.Tensor, n: int, device: torch.device | str
                ) -> Iterator[Tuple[int, torch.Tensor]]:
    """(start, bits) for the flat counters [start, start + BLOCK) of a draw
    of n values; bits are int64 tensors of uint32 values on `device`."""
    k1, k2 = _words(key)
    for start in range(0, n, BLOCK):
        j = torch.arange(start, min(n, start + BLOCK), dtype=torch.int64,
                         device=device)
        o1, o2 = threefry2x32(k1, k2, j >> 32, j & M32)
        yield start, o1.bitwise_xor_(o2)


def _draw(key: torch.Tensor, shape: Sequence[int], dtype: torch.dtype,
          device: torch.device | str, convert) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=dtype, device=device)
    for start, bits in _bit_blocks(key, n, device):
        out[start:start + bits.numel()] = convert(bits)
    return out.reshape(shape)


def random_bits(key: torch.Tensor, shape: Sequence[int] = (),
                device: torch.device | str = "cpu") -> torch.Tensor:
    """`jax.random.bits(key, shape)` (32 bits) as an int64 tensor of
    uint32 values."""
    return _draw(key, shape, torch.int64, device, lambda b: b)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """f32 in [0, 1) from the top 23 bits of each word, as JAX makes
    them."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def _fma_f32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """a * b + c rounded once to f32, as XLA's fused multiply-add rounds
    it, for f32 `a` in [0, 1) on the 2^-23 grid and f32 b and c: the
    product is exact in f64 (24 x 24 bits) and so is the sum when c is not
    far finer than b (c = -b / 2, the initialisers' ±limit, always), so
    rounding the f64 sum to f32 is the one rounding."""
    return (a.double() * b + c).float()


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0,
            device: torch.device | str = "cpu") -> torch.Tensor:
    """`jax.random.uniform(key, shape, jnp.float32, minval, maxval)`."""
    lo, hi = float(np.float32(minval)), float(np.float32(maxval))
    span = float(np.float32(hi) - np.float32(lo))

    def convert(bits):
        return torch.clamp_min(_fma_f32(_unit_floats(bits), span, lo), lo)

    return _draw(key, shape, torch.float32, device, convert)


def bernoulli(key: torch.Tensor, p: float = 0.5,
              shape: Sequence[int] = (),
              device: torch.device | str = "cpu") -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)`: bool."""
    p32 = float(np.float32(p))
    return _draw(key, shape, torch.bool, device,
                 lambda bits: _unit_floats(bits) < p32)
