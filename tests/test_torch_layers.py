"""The port's TF1 layer library, additive attention, the streaming edge
generator and the named timers against the JAX package on the CPU.

`activate`, `batch_norm`, `fc` and `additive_attention` take the same
numpy inputs (JAX's attention params carried over as numpy) and agree to
rtol 1e-6, atol 1e-6 (f32, the same op order); `synthetic_edges` and
`synthetic_interval_mats` are byte-equal. `dropout` draws from a
`torch.Generator` and the timers read the host clock, so they get
statistical and behavioural checks. The LSTM output dropout of the
fusion stack, which the port draws from its own generator, is held to
JAX's with JAX's own masks handed over.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagnn_tpu.config import ModelConfig as JModelConfig
from sagnn_tpu.data import synthetic as jsyn
from sagnn_tpu.models import layers as jlayers
from sagnn_tpu.models import selfgnn as js
from sagnn_tpu.ops import attention as jatt
from sagnn_tpu.utils import logger as jlogger
from sagnn_tpu_torch.config import ModelConfig as TModelConfig
from sagnn_tpu_torch.convert import params_from_numpy
from sagnn_tpu_torch.data import synthetic as tsyn
from sagnn_tpu_torch.models import layers as tlayers
from sagnn_tpu_torch.models import selfgnn as ts
from sagnn_tpu_torch.ops import attention as tatt
from sagnn_tpu_torch.utils import logger as tlogger

from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

METHODS = ["relu", "sigmoid", "tanh", "softmax", "leakyRelu", "-1relu",
           "relu6", "relu3"]


def _x(seed, shape, scale=4.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("method", METHODS)
def test_activate_matches_jax(method):
    x = _x(0, (16, 12))
    want = np.asarray(jlayers.activate(jnp.asarray(x), method, leaky=0.3))
    got = tlayers.activate(torch.from_numpy(x), method, leaky=0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_activate_unknown_method_raises_as_jax():
    x = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError) as jerr:
        jlayers.activate(jnp.asarray(x), "gelu")
    with pytest.raises(ValueError) as terr:
        tlayers.activate(torch.from_numpy(x), "gelu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_jax(train):
    x = _x(1, (64, 8), 3.0) + 1.0
    scale, shift = _x(2, (8,), 1.0), _x(3, (8,), 1.0)
    mean, var = _x(4, (8,), 1.0), np.abs(_x(5, (8,), 1.0)) + 0.5
    want = jlayers.batch_norm(*(jnp.asarray(a) for a in
                                (x, scale, shift, mean, var)), train=train)
    got = tlayers.batch_norm(*(torch.from_numpy(a) for a in
                               (x, scale, shift, mean, var)), train=train)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    if not train:
        assert torch.equal(got[1], torch.from_numpy(mean))


@pytest.mark.parametrize("activation", [None, "leakyRelu", "relu6"])
def test_fc_matches_jax(activation):
    x, w, b = _x(6, (5, 4), 1.0), _x(7, (4, 3), 1.0), _x(8, (3,), 1.0)
    for bias in (b, None):
        want = jlayers.fc(jnp.asarray(x), jnp.asarray(w),
                          None if bias is None else jnp.asarray(bias),
                          activation=activation, leaky=0.5)
        got = tlayers.fc(torch.from_numpy(x), torch.from_numpy(w),
                         None if bias is None else torch.from_numpy(bias),
                         activation=activation, leaky=0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_additive_attention_matches_jax():
    """JAX's params as numpy through both functions; the port's own
    initialiser draws the same shapes and ranges."""
    B, T, D, Q = 4, 5, 8, 6
    jp = jatt.init_additive_attention_params(jax.random.PRNGKey(1), Q, D)
    x = _x(9, (B, T, D), 1.0)
    want = np.asarray(jatt.additive_attention(jp, jnp.asarray(x)))
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    got = tatt.additive_attention(tp, torch.from_numpy(x)).numpy()
    assert got.shape == (B, D)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    mine = tatt.init_additive_attention_params(
        torch.Generator().manual_seed(0), Q, D)
    for k, v in jp.items():
        assert tuple(mine[k].shape) == v.shape
    limit = (6.0 / (D + Q)) ** 0.5
    assert float(mine["w"].abs().max()) <= limit
    assert float(mine["query"].abs().max()) <= 0.1
    assert not mine["b"].any()


def test_dropout_statistics():
    x = torch.ones((1000, 4))
    gen = torch.Generator().manual_seed(0)
    y = tlayers.dropout(gen, x, rate=0.5)
    zeros = (y == 0).float().mean().item()
    assert 0.45 < zeros < 0.55
    assert torch.all(y[y != 0] == 2.0)
    again = tlayers.dropout(torch.Generator().manual_seed(0), x, rate=0.5)
    assert torch.equal(y, again)
    assert tlayers.dropout(gen, x, rate=0.0) is x


def test_timers_behave_as_jax():
    for mod in (jlogger, tlogger):
        mod.marktime("t")
        time.sleep(0.02)
        first = mod.spent_time("t")
        assert 0.02 <= first < 5.0
        assert mod.spent_time("t") >= first
        mod.marktime("t")
        assert mod.spent_time("t") < first
        with pytest.raises(KeyError):
            mod.spent_time("never marked")


def test_synthetic_edges_and_interval_mats_match_jax():
    """The stream in several chunks, each byte-equal, and the interval
    CSRs built from it."""
    args = (10_000, 300, 200, 3)
    got = list(tsyn.synthetic_edges(*args, seed=5, chunk=3_000))
    want = list(jsyn.synthetic_edges(*args, seed=5, chunk=3_000))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype == np.int32
            assert a.tobytes() == b.tobytes()
    gm = tsyn.synthetic_interval_mats(*args, seed=5)
    wm = jsyn.synthetic_interval_mats(*args, seed=5)
    assert len(gm) == len(wm) == 3
    for a, b in zip(gm, wm):
        assert a.shape == b.shape and a.dtype == b.dtype
        for f in ("indptr", "indices", "data"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes()


def test_fusion_dropout_matches_jax_with_its_masks():
    """The LSTM output dropout (keep_rate 0.5) through the fusion stack in
    16-row blocks, as the 131k recipe chunks it (40 users: 16 + 16 + 8):
    JAX's masks rebuilt from its key (split into the users' and items',
    folded in per block) and handed to the port; the outputs agree to
    rtol 1e-5, atol 1e-6, and differ from the outputs without dropout."""
    chunk_rows = 16
    mc = JModelConfig(graph_num=2, latdim=16, num_heads=4, keep_rate=0.5,
                      fusion_chunk_rows=chunk_rows)
    tmc = TModelConfig(**dataclasses.asdict(mc))
    U, I, g, D = 40, 56, mc.graph_num, mc.latdim

    def mhsa(seed):
        return {k: _x(seed + i, (D, D) if k[0] == "w" else (D,), 0.3)
                for i, k in enumerate(("wq", "bq", "wk", "bk", "wv", "bv"))}

    def ln(seed):
        return {"scale": 1.0 + _x(seed, (D,), 0.1),
                "shift": _x(seed + 1, (D,), 0.1)}

    free = {"lstm": {"kernel": _x(30, (2 * D, 4 * D), 0.2),
                     "bias": _x(31, (4 * D,), 0.1)},
            "mhsa_user": mhsa(40), "ln_user": ln(50),
            "mhsa_item": mhsa(60), "ln_item": ln(70)}
    jp = {"free": jax.tree_util.tree_map(jnp.asarray, free)}
    tp = params_from_numpy({"free": free})
    uv, iv = _x(20, (g, U, D), 1.0), _x(21, (g, I, D), 1.0)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda p, u, i, k: js._temporal_fusion(
        p, u, i, mc, train=True, rng=k))(jp, uv, iv, key)

    def masks(k, n):
        rows = chunk_rows if 0 < chunk_rows < n else n
        blocks = [np.asarray(jax.random.bernoulli(
            k if rows == n else jax.random.fold_in(k, b), mc.keep_rate,
            (min(rows, n - b * rows), g, D)))
            for b in range(-(-n // rows))]
        return torch.from_numpy(np.concatenate(blocks))

    ku, ki = jax.random.split(key)
    keep = (masks(ku, U), masks(ki, I))
    got = ts._temporal_fusion(tp, torch.from_numpy(uv), torch.from_numpy(iv),
                              tmc, keep=keep)
    plain = ts._temporal_fusion(tp, torch.from_numpy(uv),
                                torch.from_numpy(iv), tmc)
    for a, b, c in zip(got, want, plain):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
        assert not torch.allclose(a, c)
