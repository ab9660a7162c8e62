"""The port's ops against the JAX package's on the same numpy inputs.

Segment-sum tolerances: exact mode rtol 1e-5, atol 1e-5 * sqrt(max
degree) (the sums run in another order than the Pallas kernel's, which
reorders edges by source inside each block). bf16 mode: rtol 1e-2 against
JAX (bf16 rounding), and the exact-mode tolerance against the f32 sum of
the bf16-rounded table. Dense ops: rtol 1e-5 on random f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagnn_tpu.ops import attention as jatt
from sagnn_tpu.ops import chunking as jchunk
from sagnn_tpu.ops import lstm as jlstm
from sagnn_tpu.ops import segment as jseg
from sagnn_tpu.ops.spmm_pallas import _plan_args, plan_spmm, spmm_apply
from sagnn_tpu_torch.ops import attention as tatt
from sagnn_tpu_torch.ops import chunking as tchunk
from sagnn_tpu_torch.ops import lstm as tlstm
from sagnn_tpu_torch.ops import segment as tseg
from sagnn_tpu_torch.ops import spmm_cuda

from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)


def _graph(rng, n_tgt, n_src, n_edges, n_pad, skew=False):
    """Target-sorted COO with `n_pad` pad edges (tgt == n_tgt) at the end;
    `skew` puts a third of the edges on target 1 (a hot row)."""
    tgt = rng.integers(0, n_tgt, n_edges)
    if skew:
        tgt[: n_edges // 3] = 1
    tgt = np.sort(tgt).astype(np.int32)
    src = rng.integers(0, n_src, n_edges).astype(np.int32)
    src = np.concatenate([src, np.zeros(n_pad, np.int32)])
    tgt = np.concatenate([tgt, np.full(n_pad, n_tgt, np.int32)])
    return src, tgt


def _tol(tgt, n_tgt):
    deg = np.bincount(tgt[tgt < n_tgt], minlength=n_tgt)
    return 1e-5 * np.sqrt(max(1, deg.max()))


GRAPHS = [  # (n_tgt, n_src, edges, pads, skew, D)
    (130, 90, 900, 37, False, 64),
    (300, 257, 2500, 0, True, 16),
    (50, 40, 0, 24, False, 64),       # empty interval: all padding
    (200, 60, 150, 10, False, 8),     # many empty rows
]


@pytest.mark.parametrize("shape", GRAPHS)
def test_segsum_exact_matches_jax(shape):
    n_tgt, n_src, e, pads, skew, D = shape
    rng = np.random.default_rng(e + n_tgt)
    src, tgt = _graph(rng, n_tgt, n_src, e, pads, skew)
    x = rng.standard_normal((n_src, D)).astype(np.float32)
    atol = _tol(tgt, n_tgt)

    want_xla = np.asarray(jseg.gather_segment_sum(
        jnp.asarray(x), jnp.asarray(src), jnp.asarray(tgt), n_tgt))
    want_pl = np.asarray(spmm_apply(
        jnp.asarray(x), *_plan_args(plan_spmm(src, tgt, n_tgt)), exact=True))

    got_seg = tseg.gather_segment_sum(torch.from_numpy(x),
                                      torch.from_numpy(src),
                                      torch.from_numpy(tgt), n_tgt).numpy()
    ptr = torch.from_numpy(spmm_cuda.csr_row_ptr(tgt, n_tgt))
    got_k = spmm_cuda.spmm_apply(torch.from_numpy(x), torch.from_numpy(src),
                                 ptr, exact=True).numpy()
    assert got_k.shape == (n_tgt, D) and got_k.dtype == np.float32
    for got in (got_seg, got_k):
        np.testing.assert_allclose(got, want_xla, rtol=1e-5, atol=atol)
        np.testing.assert_allclose(got, want_pl, rtol=1e-5, atol=atol)
    if e == 0:
        assert not got_k.any()


@pytest.mark.parametrize("shape", GRAPHS)
def test_segsum_bf16_matches_jax(shape):
    n_tgt, n_src, e, pads, skew, D = shape
    rng = np.random.default_rng(7 * e + n_tgt)
    src, tgt = _graph(rng, n_tgt, n_src, e, pads, skew)
    x = rng.standard_normal((n_src, D)).astype(np.float32)
    want = np.asarray(spmm_apply(
        jnp.asarray(x), *_plan_args(plan_spmm(src, tgt, n_tgt)),
        exact=False))
    ptr = torch.from_numpy(spmm_cuda.csr_row_ptr(tgt, n_tgt))
    got = spmm_cuda.spmm_apply(torch.from_numpy(x), torch.from_numpy(src),
                               ptr, exact=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=_tol(tgt, n_tgt))
    # f32-level agreement with the f32 sum over the bf16-rounded table
    x16 = torch.from_numpy(x).to(torch.bfloat16).float()
    ref = tseg.gather_segment_sum(x16, torch.from_numpy(src),
                                  torch.from_numpy(tgt), n_tgt).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=_tol(tgt, n_tgt))
    np.testing.assert_allclose(want, ref, rtol=1e-5, atol=_tol(tgt, n_tgt))


def test_propagate_matches_jax():
    rng = np.random.default_rng(5)
    src, tgt = _graph(rng, 80, 60, 500, 12)
    x = rng.standard_normal((60, 32)).astype(np.float32)
    want = np.asarray(jseg.propagate(jnp.asarray(x), jnp.asarray(src),
                                     jnp.asarray(tgt), 80, 0.5))
    got = tseg.propagate(torch.from_numpy(x), torch.from_numpy(src),
                         torch.from_numpy(tgt), 80, 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_gather_segment_sum_keeps_no_messages_for_backward(weighted):
    """The "xla" backend's hop keeps no [E, D] tensor for its backward
    (only its index and weights), as the JAX package keeps none; its
    gradient is still the transpose sum, and JAX's."""
    rng = np.random.default_rng(11)
    n_tgt, n_src, D = 300, 200, 16
    src, tgt = _graph(rng, n_tgt, n_src, 6000, 40, skew=True)
    w = rng.random(len(src)).astype(np.float32) if weighted else None
    x = torch.from_numpy(rng.standard_normal((n_src, D)).astype(
        np.float32)).requires_grad_()
    cot = rng.standard_normal((n_tgt, D)).astype(np.float32)
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tseg.gather_segment_sum(
            x, torch.from_numpy(src), torch.from_numpy(tgt), n_tgt,
            None if w is None else torch.from_numpy(w))
    message_bytes = len(src) * D * x.element_size()
    assert saved and all(t.untyped_storage().nbytes() < message_bytes
                         for t in saved), [tuple(t.shape) for t in saved]
    dx, = torch.autograd.grad(out, x, torch.from_numpy(cot))
    want = jax.grad(lambda x_: jnp.vdot(jseg.gather_segment_sum(
        x_, jnp.asarray(src), jnp.asarray(tgt), n_tgt,
        None if w is None else jnp.asarray(w)), jnp.asarray(cot)))(
            jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want), rtol=1e-5,
                               atol=_tol(src[tgt < n_tgt], n_src))


def test_spmm_wrapper_rejects_other_devices():
    x = torch.zeros((4, 2), device="meta")
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        spmm_cuda.spmm_apply(x, idx, idx)


def _mhsa_params(rng, D):
    p = {}
    for n in ("q", "k", "v"):
        p[f"w{n}"] = (rng.standard_normal((D, D)) * 0.3).astype(np.float32)
        p[f"b{n}"] = (rng.standard_normal(D) * 0.1).astype(np.float32)
    return p


@pytest.mark.parametrize("T", [3, 1, 20])
@pytest.mark.parametrize("stable", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_mhsa_matches_jax(T, stable, masked):
    rng = np.random.default_rng(T * 10 + stable * 2 + masked)
    B, D, H = 7, 16, 4
    p = _mhsa_params(rng, D)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = (rng.random((B, T)) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    want = np.asarray(jatt.multi_head_self_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), H,
        stable=stable, mask=jnp.asarray(mask) if masked else None))
    got = tatt.multi_head_self_attention(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        H, stable=stable,
        mask=torch.from_numpy(mask) if masked else None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(9, 3, 16), (5, 1, 8), (4, 2, 3, 6)])
def test_layer_norm_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    shift = rng.standard_normal(shape[-1]).astype(np.float32)
    want = np.asarray(jatt.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(shift)))
    got = tatt.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                          torch.from_numpy(shift)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T", [1, 3, 6])
def test_lstm_scan_matches_jax(T):
    rng = np.random.default_rng(T)
    N, D = 11, 16
    p = {"kernel": (rng.standard_normal((2 * D, 4 * D)) * 0.2
                    ).astype(np.float32),
         "bias": (rng.standard_normal(4 * D) * 0.1).astype(np.float32)}
    x = rng.standard_normal((N, T, D)).astype(np.float32)
    want = np.asarray(jlstm.lstm_scan(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = tlstm.lstm_scan({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_lstm_dropout_only_with_generator():
    x = torch.ones((4, 3, 8))
    p = {"kernel": torch.full((16, 32), 0.1), "bias": torch.zeros(32)}
    a = tlstm.lstm_scan(p, x, keep_rate=0.5)
    keep = tlstm.dropout_keep_mask(torch.Generator().manual_seed(0),
                                   (4, 3, 8), 0.5, "cpu")
    b = tlstm.lstm_scan(p, x, keep_rate=0.5, keep_mask=keep)
    kept = b != 0
    assert torch.allclose(b[kept], a[kept] / 0.5)
    assert 0 < kept.float().mean() < 1


@pytest.mark.parametrize("base", [0, 5, 37])
@pytest.mark.parametrize("use_valid", [False, True])
def test_scatter_local_mask_matches_jax(base, use_valid):
    rng = np.random.default_rng(base)
    B, K, width = 6, 9, 20
    ids = rng.integers(-3, 60, (B, K)).astype(np.int32)  # many out of window
    ids[0, :3] = base                                    # duplicates
    valid = (rng.random((B, K)) < 0.6).astype(np.float32)
    want = np.asarray(jchunk.scatter_local_mask(
        jnp.asarray(ids), base, width,
        valid=jnp.asarray(valid) if use_valid else None))
    got = tchunk.scatter_local_mask(
        torch.from_numpy(ids), base, width,
        valid=torch.from_numpy(valid) if use_valid else None).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [10, 131_072, 131_073, 10 ** 6])
def test_auto_chunk_rows_matches_jax(n):
    assert tchunk.auto_chunk_rows(n) == jchunk.auto_chunk_rows(n)


@pytest.mark.parametrize("exact", [True, False])
def test_spmm_plain_f64_reference(exact):
    """An f64 table gives an f64 sum (the kernel checks' reference); bf16
    mode rounds the table to bf16 first in either precision."""
    rng = np.random.default_rng(11)
    src, tgt = _graph(rng, 60, 40, 700, 5, skew=True)
    x = torch.from_numpy(rng.standard_normal((40, 8)))
    ptr = torch.from_numpy(spmm_cuda.csr_row_ptr(tgt, 60))
    s = torch.from_numpy(src)
    out64 = spmm_cuda.spmm_apply_plain(x, s, ptr, exact)
    out32 = spmm_cuda.spmm_apply_plain(x.float(), s, ptr, exact)
    assert out64.dtype == torch.float64 and out32.dtype == torch.float32
    table = x if exact else x.to(torch.bfloat16).double()
    want = np.zeros((61, 8))
    np.add.at(want, tgt, table.numpy()[src])
    np.testing.assert_allclose(out64.numpy(), want[:60], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(out32.numpy(), want[:60], rtol=1e-5,
                               atol=_tol(tgt, 60))


def test_layers_match_jax():
    import jax

    from sagnn_tpu.models import layers as jlayers
    from sagnn_tpu_torch.models import layers as tlayers

    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        tlayers.leaky_relu(torch.from_numpy(x), 0.5).numpy(),
        np.asarray(jlayers.leaky_relu(jnp.asarray(x), 0.5)))
    tree = {"a": x, "b": [x[:2], x[3]]}
    want = float(jlayers.l2_sum(jax.tree_util.tree_map(jnp.asarray, tree)))
    got = float(tlayers.l2_sum([torch.from_numpy(a) for a in
                                (x, x[:2], x[3])]))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # TF glorot limits, incl. the [g, N, D] receptive-field fans
    gen = torch.Generator().manual_seed(0)
    for shape in ((3, 50, 8), (16, 4), (9,)):
        w = tlayers.tf_glorot_uniform(gen, shape)
        j = np.asarray(jlayers.tf_glorot_uniform(jax.random.PRNGKey(0),
                                                 shape))
        rf = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
        fans = (shape[-2] * rf + shape[-1] * rf) if len(shape) > 1 \
            else 2 * shape[0]
        limit = np.sqrt(6.0 / fans)
        assert w.shape == shape and float(w.abs().max()) <= limit
        assert np.abs(j).max() <= limit
        assert float(w.abs().max()) > 0.8 * limit
