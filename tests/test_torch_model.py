"""The port's SelfGNN serving path against the JAX package's, on the same
graphs and weights.

Tolerances: propagation (user_vec/item_vec) rtol 1e-5, atol 1e-5; the
fused outputs (LSTM + attention + layer norms) and scores rtol 1e-4,
atol 1e-5. Top-k ids are compared where scores are distinct, scores with
allclose.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagnn_tpu.models.selfgnn import chunked_topk as j_chunked_topk
from sagnn_tpu.models.selfgnn import init_params as j_init
from sagnn_tpu.train.metrics import topk_metrics as j_topk_metrics
from sagnn_tpu_torch.convert import flatten_tree, load_npz, save_npz
from sagnn_tpu_torch.models.selfgnn import (SelfGNN, chunked_topk,
                                            init_params, param_shapes)
from sagnn_tpu_torch.ops import spmm_cuda
from sagnn_tpu_torch.train.metrics import topk_metrics

from tests.torch_port_helpers import MCFG, numpy_tree, setup, t, torch_cfg
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

ATT = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def env():
    return setup()


def _requests(bundle, B=6, L=10, seed=0):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, bundle.num_users, B).astype(np.int32)
    seq = rng.integers(0, bundle.num_items, (B, L)).astype(np.int32)
    mask = (rng.random((B, L)) > 0.4).astype(np.float32)
    return users, seq, mask


def test_init_params_layout_matches_jax():
    mcfg = dataclasses.replace(MCFG, att_layer=3)
    jp = flatten_tree(numpy_tree(j_init(jax.random.PRNGKey(1), mcfg, 7, 9)))
    want = {k: v.shape for k, v in jp.items()}
    assert param_shapes(torch_cfg(mcfg), 7, 9) == want
    tp = init_params(torch.Generator().manual_seed(0), torch_cfg(mcfg), 7, 9)
    assert {k: tuple(v.shape) for k, v in tp.items()} == want
    assert all(v.dtype == torch.float32 for v in tp.values())
    # the same initialisers: zeros where JAX has zeros, ones where ones
    for k, v in jp.items():
        if not v.any():
            assert not tp[k].any(), k
        elif (v == 1).all():
            assert (tp[k] == 1).all(), k
        else:
            limit = np.abs(v).max()
            assert float(tp[k].abs().max()) <= limit * 1.2 + 1e-6, k


def test_npz_round_trip(tmp_path, env):
    tp = env[-1]
    path = str(tmp_path / "p.npz")
    save_npz(path, tp)
    back = load_npz(path)
    assert back.keys() == tp.keys()
    assert all(torch.equal(back[k], tp[k]) for k in tp)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_encode_matches_jax(env, backend):
    bundle, jm, jg, jp, tm, tg, tp = env
    jm.cfg = dataclasses.replace(MCFG, spmm_backend=backend)
    tm = SelfGNN(torch_cfg(jm.cfg), bundle.num_users, bundle.num_items)
    spmm_cuda.reset_launches()
    want = [np.asarray(a) for a in jm.encode(jp, jg, train=False)]
    got = [a.numpy() for a in tm.encode(tp, tg)]
    # the CPU runs the kernel's plain version: no launch is counted
    assert sum(spmm_cuda.LAUNCHES.values()) == 0
    for name, w, g, tol in zip(
            ("final_user", "final_item", "user_vec", "item_vec"), want, got,
            (ATT, ATT, dict(rtol=1e-5, atol=1e-5),
             dict(rtol=1e-5, atol=1e-5))):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


def test_encode_pallas_bf16_matches_jax(env):
    bundle, jm, jg, jp, tm, tg, tp = env
    mcfg = dataclasses.replace(MCFG, spmm_backend="pallas", spmm_exact=False)
    jm.cfg = mcfg
    tm = SelfGNN(torch_cfg(mcfg), bundle.num_users, bundle.num_items)
    want = [np.asarray(a) for a in jm.encode(jp, jg, train=False)]
    got = [a.numpy() for a in tm.encode(tp, tg)]
    # both sum the same bf16-rounded tables in f32: the exact-mode
    # tolerances hold
    for w, g, tol in zip(want, got, (ATT, ATT, dict(rtol=1e-5, atol=1e-5),
                                     dict(rtol=1e-5, atol=1e-5))):
        np.testing.assert_allclose(g, w, **tol)


def test_fusion_chunk_rows_equals_unchunked(env):
    bundle, jm, jg, jp, tm, tg, tp = env
    base = tm.encode(tp, tg)
    mc = dataclasses.replace(torch_cfg(MCFG), fusion_chunk_rows=16)
    got = SelfGNN(mc, bundle.num_users, bundle.num_items).encode(tp, tg)
    for a, b in zip(base, got):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_score_with_encodings_and_metrics_match_jax(env):
    bundle, jm, jg, jp, tm, tg, tp = env
    jm.cfg = MCFG
    users, seq, mask = _requests(bundle, seed=1)
    rng = np.random.default_rng(2)
    cands = rng.integers(0, bundle.num_items, (len(users), 9)
                         ).astype(np.int32)
    ju, ji, _, _ = jm.encode(jp, jg, train=False)
    want = np.array(jm.score_with_encodings(
        jp, ju, ji, jnp.asarray(users), jnp.asarray(cands), jnp.asarray(seq),
        jnp.asarray(mask)))
    tu, ti, _, _ = tm.encode(tp, tg)
    got = tm.score_with_encodings(tp, tu, ti, t(users), t(cands), t(seq),
                                  t(mask))
    np.testing.assert_allclose(got.numpy(), want, **ATT)
    # metrics on the same score matrix (positive = last column), incl. ties
    want[:, 3] = want[:, -1]
    valid = np.array([1, 1, 0, 1, 1, 1], np.float32)
    jmet = j_topk_metrics(jnp.asarray(want), valid=jnp.asarray(valid))
    tmet = topk_metrics(t(want), valid=t(valid))
    assert jmet.keys() == tmet.keys()
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-6)


def test_score_all_items_matches_jax(env):
    bundle, jm, jg, jp, tm, tg, tp = env
    jm.cfg = MCFG
    users, seq, mask = _requests(bundle, seed=3)
    ju, ji, _, _ = jm.encode(jp, jg, train=False)
    want = np.asarray(jm.score_all_items(
        jp, ju, ji, jnp.asarray(users), jnp.asarray(seq), jnp.asarray(mask)))
    tu, ti, _, _ = tm.encode(tp, tg)
    got = tm.score_all_items(tp, tu, ti, t(users), t(seq), t(mask))
    assert got.shape == (len(users), bundle.num_items)
    np.testing.assert_allclose(got.numpy(), want, **ATT)


def _assert_topk_equal(got_v, got_i, want_v, want_i, scores):
    got_v, got_i = got_v.numpy(), got_i.numpy()
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    np.testing.assert_allclose(got_v, want_v, **ATT)
    # ids agree wherever the score is not tied with a neighbour
    sv = np.sort(scores, axis=1)[:, ::-1]
    with np.errstate(invalid="ignore"):   # -inf - -inf: masked, not distinct
        gaps = np.minimum(np.abs(np.diff(sv, axis=1, prepend=np.inf)),
                          np.abs(np.diff(sv, axis=1, append=-np.inf)))
    k = got_i.shape[1]
    distinct = gaps[:, :k] > 1e-3 * np.maximum(1.0, np.abs(sv[:, :k]))
    assert distinct.mean() > 0.5
    np.testing.assert_array_equal(got_i[distinct], want_i[distinct])


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("chunk_rows", [-1, 24])
def test_recommend_top_k_matches_jax(env, exclude, chunk_rows):
    bundle, jm, jg, jp, tm, tg, tp = env
    jm.cfg = MCFG
    users, seq, mask = _requests(bundle, seed=4)
    want_v, want_i = jm.recommend_top_k(
        jp, jg, jnp.asarray(users), jnp.asarray(seq), jnp.asarray(mask),
        k=7, exclude_seen=exclude, chunk_rows=chunk_rows)
    got_v, got_i = tm.recommend_top_k(tp, tg, t(users), t(seq), t(mask),
                                      k=7, exclude_seen=exclude,
                                      chunk_rows=chunk_rows)
    tu, ti, _, _ = tm.encode(tp, tg)
    scores = tm.score_all_items(tp, tu, ti, t(users), t(seq),
                                t(mask)).numpy()
    if exclude:
        for b in range(len(users)):
            seen = set(seq[b][mask[b] > 0].tolist())
            assert not seen & set(got_i[b].tolist())
            scores[b, list(seen)] = -np.inf
    _assert_topk_equal(got_v, got_i, want_v, want_i, scores)


@pytest.mark.parametrize("chunk", [64, 100, 333, 512])
def test_chunked_topk_matches_jax(chunk):
    rng = np.random.default_rng(chunk)
    B, I, D, L, k = 8, 333, 16, 12, 10
    q = rng.standard_normal((B, D)).astype(np.float32)
    tbl = rng.standard_normal((I, D)).astype(np.float32)
    seen = rng.integers(0, I, (B, L)).astype(np.int32)
    smask = (rng.random((B, L)) < 0.7).astype(np.float32)
    want_v, want_i = j_chunked_topk(
        jnp.asarray(q), jnp.asarray(tbl), I, k, chunk_rows=chunk,
        seen_seq=jnp.asarray(seen), seen_mask=jnp.asarray(smask))
    got_v, got_i = chunked_topk(t(q), t(tbl), I, k, chunk_rows=chunk,
                                seen_seq=t(seen), seen_mask=t(smask))
    scores = q @ tbl.T
    for b in range(B):
        scores[b, seen[b][smask[b] > 0]] = -np.inf
    _assert_topk_equal(got_v, got_i, want_v, want_i, scores)


@pytest.mark.parametrize("field,value", [
    ("spmm_backend", "cusparse"), ("seq_parallel", True)])
def test_options_not_ported_raise(field, value):
    """An unknown backend raises NotImplementedError; seq_parallel is
    ported (ROADMAP A6(d)) and raises JAX's ValueErrors: without
    per-token attention, and without the model's mesh."""
    cfg = dataclasses.replace(torch_cfg(MCFG), **{field: value})
    if field == "spmm_backend":
        with pytest.raises(NotImplementedError, match=field):
            SelfGNN(cfg, 4, 4)
        return
    with pytest.raises(ValueError, match="per_token_seq_attention"):
        SelfGNN(cfg, 4, 4)
    with pytest.raises(ValueError, match="seq_parallel requires a mesh"):
        SelfGNN(dataclasses.replace(cfg, per_token_seq_attention=True), 4,
                4)
