"""`sagnn_tpu_torch/utils/jax_random.py` against `jax.random` (0.9, its
default threefry with `jax_threefry_partitionable` on, 32-bit mode), bit
for bit: keys from seeds, split, fold_in, 32-bit random bits, the f32
uniform with the initialisers' ±limit bounds and with asymmetric ones,
and bernoulli."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagnn_tpu_torch.utils import jax_random as jr

from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

KEY = jax.random.fold_in(jax.random.PRNGKey(0), 5)
SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 32]
SPLITS = [2, 3, 64]
FOLDS = [0, 1, 7, 2 ** 31]
SHAPES = [(), (1,), (7,), (3, 1031, 64), (2, 5, 3, 64)]
PS = [0.5, 0.8]
BERNOULLI_SHAPE = (77, 3, 64)


def _glorot(shape):
    rf = math.prod(shape[:-2])
    return math.sqrt(6.0 / (shape[-2] * rf + shape[-1] * rf))


UNIFORMS = {
    # the initialisers' symmetric bounds: tf_glorot_uniform on a [g, N, D]
    # table, the 131k recipe's u_embed bound on fewer rows, xavier
    "glorot": ((3, 1031, 64), -_glorot((3, 1031, 64)),
               _glorot((3, 1031, 64))),
    "glorot_131k_bound": ((3, 4096, 64), -_glorot((3, 131072, 64)),
                          _glorot((3, 131072, 64))),
    "xavier": ((128, 256), -(6.0 / 384) ** 0.5, (6.0 / 384) ** 0.5),
    # asymmetric bounds: one rounding of f * span + minval, as XLA's FMA
    "shifted": ((1 << 16,), 0.3, 1.7),
    "asymmetric": ((1 << 16,), -2.5, 0.1),
}


@pytest.fixture(scope="module")
def want():
    """Every reference draw from one jitted JAX function (one compile)."""

    def draws(key):
        return {
            "split": [jax.random.split(key, n) for n in SPLITS],
            "fold_in": [jax.random.fold_in(key, d) for d in FOLDS],
            "bits": [jax.random.bits(key, s, jnp.uint32) for s in SHAPES],
            "uniform": {k: jax.random.uniform(key, s, jnp.float32, lo, hi)
                        for k, (s, lo, hi) in UNIFORMS.items()},
            "bernoulli": [jax.random.bernoulli(key, p, BERNOULLI_SHAPE)
                          for p in PS],
        }

    return jax.tree_util.tree_map(np.asarray, jax.jit(draws)(KEY))


def tkey(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    np.testing.assert_array_equal(jr.prng_key(seed).numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("i", range(len(SPLITS)), ids=map(str, SPLITS))
def test_split(want, i):
    np.testing.assert_array_equal(jr.split(tkey(KEY), SPLITS[i]).numpy(),
                                  want["split"][i])


@pytest.mark.parametrize("i", range(len(FOLDS)), ids=map(str, FOLDS))
def test_fold_in(want, i):
    np.testing.assert_array_equal(jr.fold_in(tkey(KEY), FOLDS[i]).numpy(),
                                  want["fold_in"][i])


@pytest.mark.parametrize("i", range(len(SHAPES)), ids=map(str, SHAPES))
def test_random_bits(want, i):
    w = want["bits"][i]
    got = jr.random_bits(tkey(KEY), SHAPES[i]).numpy()
    assert got.shape == w.shape
    np.testing.assert_array_equal(got, w.astype(np.int64))


def test_draws_cross_blocks(want, monkeypatch):
    """A draw longer than one block of counters is the same draw."""
    monkeypatch.setattr(jr, "BLOCK", 1000)
    np.testing.assert_array_equal(
        jr.bernoulli(tkey(KEY), PS[0], BERNOULLI_SHAPE).numpy(),
        want["bernoulli"][0])


@pytest.mark.parametrize("name", list(UNIFORMS))
def test_uniform(want, name):
    shape, lo, hi = UNIFORMS[name]
    got = jr.uniform(tkey(KEY), shape, lo, hi).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  want["uniform"][name].view(np.int32))


@pytest.mark.parametrize("i", range(len(PS)), ids=map(str, PS))
def test_bernoulli(want, i):
    got = jr.bernoulli(tkey(KEY), PS[i], BERNOULLI_SHAPE).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want["bernoulli"][i])
