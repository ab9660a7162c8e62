"""The port's top-k options against the JAX package's: recall_target on
`topk_descending`, `chunked_topk` and `recommend_top_k`, and the bf16
score stream of `chunked_topk` (quantised selection, exact f32 rerank).

JAX's approx_max_k trades recall for speed on a TPU only: on the CPU it
returns the exact top-k at any recall_target (checked here), and the
port's torch.topk is exact too. So at recall_target 0.95 and 1.0 the ids
are JAX's exactly and the values JAX's at rtol 1e-6 (the catalog scores
come from two f32 matmuls); the scores are drawn so that no two of a row's
top k + 1 lie within 1e-4 of each other. The bf16 stream: the returned
scores are the f32 scores of the returned ids (rtol 1e-6); wherever the
stream's k-th and (k+1)-th bf16 scores differ, the selected set is JAX's;
winners that were -inf in the stream stay -inf after the rerank, as in
JAX. At 500 items the returned
scores also meet tests/test_recommend.py's bound, the exact score at
each place less 2^-8 |v| + 1e-6; at 20,000 items JAX's own bf16 top-k
misses it (ties in the stream), and both packages are held to the
stream's rounding bound instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagnn_tpu.models.selfgnn import chunked_topk as j_chunked_topk
from sagnn_tpu.models.selfgnn import topk_descending as j_topk
from sagnn_tpu_torch import config as tcfg
from sagnn_tpu_torch import serve
from sagnn_tpu_torch.convert import save_npz
from sagnn_tpu_torch.models.selfgnn import (SelfGNN, chunked_topk,
                                            init_params, topk_descending)
from sagnn_tpu_torch.serve import Recommender

from tests.test_torch_cuda import bf16_stream_error
from tests.torch_port_helpers import MCFG, setup, t, torch_cfg
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

B, I, D, K = 8, 333, 16, 10


def _separated(seed, b=B, i=I, d=D):
    """Queries and a table whose per-row scores have distinct tops."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        q = rng.standard_normal((b, d)).astype(np.float32)
        tbl = rng.standard_normal((i, d)).astype(np.float32)
        top = -np.sort(-(q.astype(np.float64) @ tbl.T.astype(np.float64)),
                       axis=1)[:, :K + 1]
        if np.abs(np.diff(top, axis=1)).min() > 1e-4:
            return q, tbl
    raise AssertionError("no separated draw")


@pytest.mark.parametrize("recall", [0.95, 1.0])
def test_topk_descending_matches_jax(recall):
    q, tbl = _separated(1)
    scores = q @ tbl.T
    want_v, want_i = j_topk(jnp.asarray(scores), K, recall_target=recall)
    got_v, got_i = topk_descending(t(scores), K, recall_target=recall)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # off the TPU JAX's approximate top-k is the exact one
    exact = np.argsort(-scores, axis=1, kind="stable")[:, :K]
    np.testing.assert_array_equal(np.asarray(want_i), exact)


@pytest.mark.parametrize("recall", [0.95, 1.0])
@pytest.mark.parametrize("chunk", [64, 512])
def test_chunked_topk_recall_matches_jax(recall, chunk):
    q, tbl = _separated(2)
    want_v, want_i = j_chunked_topk(jnp.asarray(q), jnp.asarray(tbl), I, K,
                                    chunk_rows=chunk, recall_target=recall)
    got_v, got_i = chunked_topk(t(q), t(tbl), I, K, chunk, recall)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-6)


def _bf16_scores(q, tbl):
    """The bf16 stream's scores: bf16 operands, f32 sums, bf16 result."""
    qb = torch.from_numpy(q).bfloat16().float()
    tb = torch.from_numpy(tbl).bfloat16().float()
    return (qb @ tb.T).bfloat16().float().numpy()


@pytest.mark.parametrize("chunk", [64, 128, 512])
def test_chunked_topk_bf16_rerank_matches_jax(chunk):
    rng = np.random.default_rng(chunk)
    q = rng.standard_normal((B, 32)).astype(np.float32)
    tbl = rng.standard_normal((500, 32)).astype(np.float32)
    want_v, want_i = j_chunked_topk(jnp.asarray(q), jnp.asarray(tbl), 500, K,
                                    chunk_rows=chunk,
                                    score_dtype=jnp.bfloat16)
    got_v, got_i = chunked_topk(t(q), t(tbl), 500, K, chunk,
                                score_dtype=torch.bfloat16)
    assert got_v.dtype == torch.float32
    got_v, got_i = got_v.numpy(), got_i.numpy()
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    dense = q @ tbl.T
    # the returned scores are the f32 scores of the returned ids, sorted
    np.testing.assert_allclose(np.take_along_axis(dense, got_i, axis=1),
                               got_v, rtol=1e-6)
    assert (got_v[:, :-1] >= got_v[:, 1:]).all()
    # where the stream's k-th and (k+1)-th scores differ, the selection is
    # determined, and it is JAX's (and then so are the reranked scores)
    stream = -np.sort(-_bf16_scores(q, tbl), axis=1)
    determined = stream[:, K - 1] > stream[:, K]
    assert determined.sum() >= B // 2
    for b in np.nonzero(determined)[0]:
        assert set(got_i[b]) == set(want_i[b]), b
        np.testing.assert_allclose(got_v[b], want_v[b], rtol=1e-6)
    # selection differs from exact only within bf16 resolution (at this
    # size, tests/test_recommend.py's bound)
    exact = -np.sort(-dense, axis=1)[:, :K]
    assert (got_v >= exact - (np.abs(exact) * 2.0 ** -8 + 1e-6)).all()


def test_bf16_selection_is_held_to_its_rounding_bound():
    """At 20,000 items (seed 0) JAX's own bf16 top-k falls short of
    tests/test_recommend.py's bound (the exact score at each place less
    2^-8 |v| + 1e-6): two items tied in the bf16 stream are one ulp, up
    to 2^-7 |v|, apart, and either may be chosen. Both packages' results
    meet the stream's rounding bound (`bf16_stream_error`: each returned
    score at least the exact k-th less its own and the top k's largest
    stream error), which `chip_smoke.py` and the card test hold."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((64, 64)).astype(np.float32)
    tbl = rng.standard_normal((20_000, 64)).astype(np.float32)
    dense = q.astype(np.float64) @ tbl.T.astype(np.float64)
    order = np.argsort(-dense, 1)[:, :K]
    want_v = t(np.take_along_axis(dense, order, 1))
    want_i = t(order)
    jv, ji = j_chunked_topk(jnp.asarray(q), jnp.asarray(tbl), 20_000, K,
                            chunk_rows=4096, score_dtype=jnp.bfloat16)
    tv, ti = chunked_topk(t(q), t(tbl), 20_000, K, 4096,
                          score_dtype=torch.bfloat16)
    jv, ji = t(np.array(jv)).double(), t(np.array(ji)).long()
    half_ulp = want_v - (want_v.abs() * 2.0 ** -8 + 1e-6)
    assert float((half_ulp - jv).max()) > 0       # JAX misses it
    e_top = bf16_stream_error(t(q), t(tbl), want_i).max(
        1, keepdim=True).values
    for v, i in ((jv, ji), (tv.double(), ti)):
        slack = bf16_stream_error(t(q), t(tbl), i) + e_top
        assert bool((v >= want_v[:, -1:] - slack).all())


def test_chunked_topk_bf16_keeps_minus_inf():
    """k above the real candidates (the seen items and the pad rows past
    num_items excluded): the winners that were -inf in the stream stay
    -inf after the f32 rerank, in JAX's places."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    tbl = rng.standard_normal((12, 8)).astype(np.float32)
    seen = np.array([[0, 1, 2, 3, 4, 5]] * 3, np.int32)
    smask = np.ones((3, 6), np.float32)
    smask[1, 4:] = 0.0
    want_v, want_i = j_chunked_topk(
        jnp.asarray(q), jnp.asarray(tbl), 10, 6, chunk_rows=4,
        seen_seq=jnp.asarray(seen), seen_mask=jnp.asarray(smask),
        score_dtype=jnp.bfloat16)
    got_v, got_i = chunked_topk(t(q), t(tbl), 10, 6, 4, seen_seq=t(seen),
                                seen_mask=t(smask),
                                score_dtype=torch.bfloat16)
    want_v, got_v = np.asarray(want_v), got_v.numpy()
    np.testing.assert_array_equal(np.isneginf(got_v), np.isneginf(want_v))
    assert np.isneginf(got_v).sum() == 2 + 0 + 2     # 4, 6 and 4 real
    fin = np.isfinite(want_v)
    np.testing.assert_allclose(got_v[fin], want_v[fin], rtol=1e-6)
    np.testing.assert_array_equal(got_i.numpy()[fin], np.asarray(want_i)[fin])


@pytest.fixture(scope="module")
def env():
    return setup()


@pytest.mark.parametrize("chunk_rows", [-1, 24])
def test_recommend_top_k_recall_matches_jax(env, chunk_rows):
    bundle, jm, jg, jp, _tm, tg, tp = env
    jm.cfg = MCFG
    tm = SelfGNN(torch_cfg(MCFG), bundle.num_users, bundle.num_items)
    rng = np.random.default_rng(4)
    users = rng.integers(0, bundle.num_users, 6).astype(np.int32)
    seq = rng.integers(0, bundle.num_items, (6, 10)).astype(np.int32)
    mask = (rng.random((6, 10)) > 0.4).astype(np.float32)
    want_v, want_i = jm.recommend_top_k(
        jp, jg, jnp.asarray(users), jnp.asarray(seq), jnp.asarray(mask), k=5,
        recall_target=0.95, chunk_rows=chunk_rows)
    got_v, got_i = tm.recommend_top_k(tp, tg, t(users), t(seq), t(mask),
                                      k=5, recall_target=0.95,
                                      chunk_rows=chunk_rows)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-4,
                               atol=1e-5)
    exact = tm.recommend_top_k(tp, tg, t(users), t(seq), t(mask), k=5,
                               chunk_rows=chunk_rows)
    assert torch.equal(exact[0], got_v) and torch.equal(exact[1], got_i)


def _recommender(env):
    bundle, _jm, _jg, _jp, _tm, _tg, tp = env
    cfg = tcfg.Config(model=dataclasses.replace(torch_cfg(MCFG),
                                                spmm_backend="pallas"))
    return Recommender(cfg, bundle, tp, device="cpu")


def test_recommender_passes_recall_target(env):
    rec = _recommender(env)
    users = [0, 3, 7]
    exact = rec.recommend(users, k=5)
    for recall in (0.5, 0.95):
        got = rec.recommend(users, k=5, recall_target=recall)
        assert torch.equal(got[0], exact[0]) and torch.equal(got[1],
                                                             exact[1])
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="recall_target"):
            rec.recommend(users, k=5, recall_target=bad)
        with pytest.raises(ValueError, match="recall_target"):
            rec.recommend(users, k=5, recall_target=bad, chunk_rows=16)


@pytest.mark.parametrize("bad", [0.0, 1.5])
def test_recall_target_outside_the_unit_interval_raises(bad):
    x = torch.randn(3, 20)
    with pytest.raises(ValueError, match="recall_target"):
        topk_descending(x, 4, recall_target=bad)
    with pytest.raises(ValueError, match="recall_target"):
        chunked_topk(torch.randn(3, 8), torch.randn(20, 8), 20, 4, 8, bad)
    # JAX refuses the same values
    with pytest.raises(Exception, match="recall_target"):
        jax.block_until_ready(j_topk(jnp.asarray(x.numpy()), 4,
                                     recall_target=bad))


def test_serve_cli_recall(tmp_path, capsys):
    """python -m sagnn_tpu_torch.serve --recall 0.95 serves what --recall
    1.0 serves (the port's top-k is exact at any recall)."""
    cfg = tcfg.PRESETS["gowalla"].model
    path = str(tmp_path / "w.npz")
    save_npz(path, init_params(torch.Generator().manual_seed(1), cfg, 40, 60))
    base = ["--device", "cpu", "--synth_users", "40", "--synth_items", "60",
            "--users", "0", "3", "--k", "5", "--params", path]
    out = []
    for recall in ("0.95", "1.0"):
        serve.main(base + ["--recall", recall])
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and len(out[0].splitlines()) == 2
