"""The port's path for huge graphs against the JAX package on the CPU: the
large synthetic generator, source-sharded plans and propagation (K3),
out-of-core slices (K3), row-folded gathers (K4), the sharded model, and
training with `remat_propagation` and `fusion_chunk_rows`.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_spmm_pallas.py does; the port's wrappers take their plain
versions on the CPU. Tolerances are JAX's own for these paths
(tests/test_spmm_pallas.py): sharded forward rtol 1e-5, atol 1e-4, its
gradient rtol 1e-4, atol 1e-3; the sharded model's encode rtol 1e-4,
atol 1e-4 and its gradients rtol 1e-3, atol 1e-3 against the "xla"
backend; training losses rtol 1e-5 and gradients rtol 1e-4, atol
1e-6·max|g|, as tests/test_torch_train.py holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagnn_tpu.data.sampler import Sampler as JSampler
from sagnn_tpu.data.synthetic import synthetic_dataset as j_synthetic
from sagnn_tpu.data.synthetic import synthetic_large_dataset as j_large
from sagnn_tpu.models.selfgnn import SelfGNN as JSelfGNN
from sagnn_tpu.models.selfgnn import reg_loss as j_reg_loss
from sagnn_tpu.ops import spmm_pallas as jsp
from sagnn_tpu_torch import config as tcfg
from sagnn_tpu_torch.convert import flatten_tree
from sagnn_tpu_torch.data.graph import compile_interval_graphs
from sagnn_tpu_torch.data.synthetic import synthetic_large_dataset
from sagnn_tpu_torch.models import selfgnn as tmodel
from sagnn_tpu_torch.models.selfgnn import (SelfGNN, TrainBatch,
                                            graphs_to_device, reg_loss)
from sagnn_tpu_torch.ops import spmm_cuda as sc

from tests.torch_port_helpers import MCFG, numpy_tree, setup, torch_cfg
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

R = jsp.R


# -- the large generator -------------------------------------------------------

def test_synthetic_large_dataset_matches_jax():
    kw = dict(num_users=2000, num_items=1500, total_edges=30_000,
              graph_num=3, test_size=20, num_test_users=300, seed=3)
    got, want = synthetic_large_dataset(**kw), j_large(**kw)
    assert (got.num_users, got.num_items) == (want.num_users, want.num_items)
    assert got.time_mat is None and want.time_mat is None
    for a, b in zip([got.trn_mat] + got.sub_mats,
                    [want.trn_mat] + want.sub_mats):
        assert a.shape == b.shape and a.dtype == b.dtype
        for f in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert len(got.sequences) == len(want.sequences) == 2000
    for a, b in zip(got.sequences, want.sequences):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert list(got.tst_int) == list(want.tst_int)
    assert got.test_dict == want.test_dict
    assert len(got.tst_usrs) == 300


# -- source-sharded plans and SpMM ----------------------------------------------

U, I, D, E, PADS = 900, 700, 16, 12_000, 5


def _graph(seed=7):
    """A target-sorted U-target COO over I sources with an unused source
    range (an empty shard at shard_rows 100) and pad slots, and its
    transpose (the item-target COO)."""
    rng = np.random.default_rng(seed)
    tgt = np.sort(rng.integers(0, U, E)).astype(np.int32)
    src = rng.integers(0, I, E).astype(np.int32)
    src = np.where((src >= 300) & (src < 400), 50, src).astype(np.int32)
    o = np.argsort(src, kind="stable")
    return src, tgt, tgt[o].copy(), src[o].copy()


def _padded(src, tgt, num_tgt):
    return (np.concatenate([src, np.zeros(PADS, np.int32)]),
            np.concatenate([tgt, np.full(PADS, num_tgt, np.int32)]))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_shard_edges(p, s):
    """(target, shard-local source) of JAX's shard s, sorted."""
    tl = p["tgt_local"][s]
    real = tl < R
    tgt = (p["chunk_block"][s][:, None] * R + tl)[real]
    src = p["src"][s].reshape(tl.shape)[real]
    o = np.lexsort((src, tgt))
    return tgt[o], src[o]


@pytest.mark.parametrize("shard_rows", [100, 256, 1024])
def test_sharded_plan_edges_match_jax(shard_rows):
    src, tgt, _, _ = _graph()
    want = jsp.plan_spmm_src_sharded(src, tgt, U, I, shard_rows)
    ps, pt = _padded(src, tgt, U)
    local, ptr = sc.plan_src_sharded(ps, pt, U, I, shard_rows)
    assert ptr.shape == (want["num_shards"], U + 1) and ptr.dtype == np.int32
    assert ptr[0, 0] == 0 and ptr[-1, -1] == E and len(local) == E + PADS
    assert (np.diff(ptr, axis=1) >= 0).all()
    assert (ptr[1:, 0] == ptr[:-1, -1]).all()       # shards back to back
    for s in range(ptr.shape[0]):
        rows = np.repeat(np.arange(U), np.diff(ptr[s]))
        ids = local[ptr[s, 0]:ptr[s, -1]]
        assert (ids >= 0).all() and (ids < shard_rows).all()
        o = np.lexsort((ids, rows))
        jt, js = _jax_shard_edges(want, s)
        np.testing.assert_array_equal(rows[o], jt)
        np.testing.assert_array_equal(ids[o], js)
    if shard_rows == 100:                            # sources 300..399
        assert ptr[3, 0] == ptr[3, -1]


def test_sharded_plan_checks_its_input():
    src, tgt, _, _ = _graph()
    with pytest.raises(ValueError, match="out of range"):
        sc.plan_src_sharded(src, tgt, U, 600, 128)
    with pytest.raises(ValueError, match="sorted"):
        sc.plan_src_sharded(src, tgt[::-1].copy(), U, I, 128)
    _, ptr = sc.plan_src_sharded(src, tgt, U, I, 128)
    with pytest.raises(ValueError, match="shards"):
        sc.spmm_apply_src_sharded(torch.zeros((I + 128, D)), _t(src),
                                  _t(ptr), 128)


def _jax_sharded(x, p, shard_rows, num_tgt, folded=False, exact=True):
    return np.asarray(jsp.spmm_apply_src_sharded(
        jnp.asarray(x), jnp.asarray(p["src"]), jnp.asarray(p["tgt_local"]),
        jnp.asarray(p["chunk_block"]), jnp.asarray(p["chunk_first"]),
        p["num_blocks"], num_tgt, shard_rows, exact=exact, folded=folded))


@pytest.mark.parametrize("shard_rows", [100, 256, 1024])
def test_src_sharded_spmm_and_grad_match_jax(shard_rows):
    src, tgt, bsrc, btgt = _graph()
    rng = np.random.default_rng(shard_rows)
    x = rng.standard_normal((I, D)).astype(np.float32)
    cot = rng.standard_normal((U, D)).astype(np.float32)
    fp = jsp.plan_spmm_src_sharded(src, tgt, U, I, shard_rows)
    bp = jsp.plan_spmm_src_sharded(bsrc, btgt, I, U, shard_rows)
    want = _jax_sharded(x, fp, shard_rows, U)
    fa, fnb, fnt, fsr = jsp._sharded_args(fp)
    ba, bnb, bnt, bsr = jsp._sharded_args(bp)
    want_dx = np.asarray(jax.grad(lambda x_: jnp.sum(jsp.spmm_src_sharded(
        x_, fa, ba, fnb, fnt, fsr, bnb, bnt, bsr, I) * cot))(jnp.asarray(x)))

    f_local, f_ptr = sc.plan_src_sharded(*_padded(src, tgt, U), U, I,
                                         shard_rows)
    b_local, b_ptr = sc.plan_src_sharded(*_padded(bsrc, btgt, I), I, U,
                                         shard_rows)
    got = sc.spmm_apply_src_sharded(_t(x), _t(f_local), _t(f_ptr),
                                    shard_rows)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    xt = _t(x).requires_grad_()
    out = sc.spmm_src_sharded(xt, _t(f_local), _t(f_ptr), _t(b_local),
                              _t(b_ptr), shard_rows)
    dx, = torch.autograd.grad(out, xt, _t(cot))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("num_slices", [2, 3])
def test_sliced_spmm_matches_jax(num_slices):
    src, tgt, _, _ = _graph(3)
    x = np.random.default_rng(1).standard_normal((I, D)).astype(np.float32)
    p = jsp.plan_spmm(src, tgt, U, num_slices=num_slices)
    want = np.asarray(jsp.spmm_apply(jnp.asarray(x), *jsp._plan_args(p),
                                     num_slices=num_slices))
    ps, pt = _padded(src, tgt, U)
    ptr = _t(sc.csr_row_ptr(pt, U))
    slices = sc._slice_ptrs(ptr, num_slices)
    # contiguous edge ranges that cover the plan once
    assert int(slices[0][0]) == 0 and int(slices[-1][-1]) == E
    assert all(int(a[-1]) == int(b[0]) for a, b in zip(slices, slices[1:]))
    got = sc.spmm_apply(_t(x), _t(ps), ptr, num_slices=num_slices)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    whole = sc.spmm_apply(_t(x), _t(ps), ptr)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5)


def _seg_atol(ptr):
    return 1e-5 * np.sqrt(max(1, int(np.diff(np.asarray(ptr)).max())))


@pytest.mark.parametrize("exact", [True, False])
def test_folded_modes_match_unfolded_and_jax(exact):
    """K4 in every place JAX folds: the unsharded and sliced spmm_apply,
    the differentiable spmm, and the sharded path; bit-equal to the
    unfolded mode in the port, within rtol 1e-5 of JAX's folded path, in
    f32 and on bf16 tables. An odd row count runs unfolded, as JAX's."""
    rng = np.random.default_rng(9)
    n_u, n_i = 384, 256
    tgt = np.sort(rng.integers(0, n_u, 6000)).astype(np.int32)
    src = rng.integers(0, n_i, 6000).astype(np.int32)
    x = rng.standard_normal((n_i, 64)).astype(np.float32)
    ps, pt = _padded(src, tgt, n_u)
    ptr = _t(sc.csr_row_ptr(pt, n_u))
    atol = _seg_atol(ptr)
    p = jsp.plan_spmm(src, tgt, n_u)
    want = np.asarray(jsp.spmm_apply(jnp.asarray(x), *jsp._plan_args(p),
                                     exact=exact, folded=True))
    fold = sc.spmm_apply(_t(x), _t(ps), ptr, exact, folded=True)
    assert torch.equal(fold, sc.spmm_apply(_t(x), _t(ps), ptr, exact))
    np.testing.assert_allclose(fold.numpy(), want, rtol=1e-5, atol=atol)

    p3 = jsp.plan_spmm(src, tgt, n_u, num_slices=2)
    want3 = np.asarray(jsp.spmm_apply(jnp.asarray(x), *jsp._plan_args(p3),
                                      exact=exact, num_slices=2,
                                      folded=True))
    fold3 = sc.spmm_apply(_t(x), _t(ps), ptr, exact, num_slices=2,
                          folded=True)
    assert torch.equal(fold3, sc.spmm_apply(_t(x), _t(ps), ptr, exact,
                                            num_slices=2))
    np.testing.assert_allclose(fold3.numpy(), want3, rtol=1e-5, atol=atol)

    pss = jsp.plan_spmm_src_sharded(src, tgt, n_u, n_i, 128)
    want_ss = _jax_sharded(x, pss, 128, n_u, folded=True, exact=exact)
    local, sptr = sc.plan_src_sharded(ps, pt, n_u, n_i, 128)
    fold_ss = sc.spmm_apply_src_sharded(_t(x), _t(local), _t(sptr), 128,
                                        exact, folded=True)
    assert torch.equal(fold_ss, sc.spmm_apply_src_sharded(
        _t(x), _t(local), _t(sptr), 128, exact))
    np.testing.assert_allclose(fold_ss.numpy(), want_ss, rtol=1e-5,
                               atol=atol)

    o = np.argsort(src, kind="stable")
    bs, bt = _padded(tgt[o], src[o], n_i)
    bptr = _t(sc.csr_row_ptr(bt, n_i))
    xt = _t(x).requires_grad_()
    cot = _t(rng.standard_normal((n_u, 64)).astype(np.float32))
    grads = [torch.autograd.grad(
        sc.spmm(xt, _t(ps), ptr, _t(bs), bptr, exact, folded), xt, cot)[0]
        for folded in (False, True)]
    assert torch.equal(*grads)

    keep = src < n_i - 1                          # an odd row count
    ps_odd, pt_odd = _padded(src[keep], tgt[keep], n_u)
    ptr_odd = _t(sc.csr_row_ptr(pt_odd, n_u))
    want_odd = np.asarray(jsp.spmm_apply(
        jnp.asarray(x[:-1]), *jsp._plan_args(jsp.plan_spmm(
            src[keep], tgt[keep], n_u)), exact=exact, folded=True))
    got_odd = sc.spmm_apply(_t(x[:-1]), _t(ps_odd), ptr_odd, exact,
                            folded=True)
    np.testing.assert_allclose(got_odd.numpy(), want_odd, rtol=1e-5,
                               atol=atol)


# -- the sharded model -----------------------------------------------------------

def _model_setup(**opts):
    """JAX's "xla" model and the port's sharded "pallas" model on one
    40-user x 60-item bundle (shard_rows 16: 3 user shards, 4 item
    shards) with the same weights."""
    jcfg = dataclasses.replace(MCFG, att_layer=1, keep_rate=1.0,
                               spmm_backend="xla")
    bundle = j_synthetic(num_users=40, num_items=60, graph_num=2, seed=5)
    from sagnn_tpu.data.graph import compile_interval_graphs as j_compile
    from sagnn_tpu.train.trainer import graphs_to_device as j_graphs
    jg = j_graphs(j_compile(bundle.sub_mats, pad_multiple=8))
    jm = JSelfGNN(jcfg, 40, 60)
    jp = jm.init(jax.random.PRNGKey(0))
    tc = dataclasses.replace(torch_cfg(jcfg), spmm_backend="pallas",
                             spmm_src_shard_rows=16, **opts)
    tg = graphs_to_device(compile_interval_graphs(bundle.sub_mats,
                                                  pad_multiple=8), "cpu", tc)
    from sagnn_tpu_torch.convert import params_from_numpy
    return jm, jg, jp, SelfGNN(tc, 40, 60), tg, params_from_numpy(
        numpy_tree(jp))


@pytest.mark.parametrize("folded", [False, True])
def test_src_sharded_model_matches_jax_xla(folded):
    jm, jg, jp, tm, tg, tp = _model_setup(spmm_fold_gather=folded)
    assert tg["plans_ss"]["u_ptr"].shape[1] == 4
    assert tg["plans_ss"]["i_ptr"].shape[1] == 3

    def j_loss(p):
        fu, fi, _, _ = jm.encode(p, jg, train=False)
        return jnp.sum(fu ** 2) + jnp.sum(fi ** 2), (fu, fi)

    (_, (jfu, jfi)), jgrads = jax.jit(
        jax.value_and_grad(j_loss, has_aux=True))(jp)
    p = {k: v.clone().requires_grad_() for k, v in tp.items()}
    fu, fi, _, _ = tm.encode(p, tg, train=True)
    np.testing.assert_allclose(fu.detach().numpy(), np.asarray(jfu),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(fi.detach().numpy(), np.asarray(jfi),
                               rtol=1e-4, atol=1e-4)
    keys = sorted(p)
    grads = torch.autograd.grad((fu ** 2).sum() + (fi ** 2).sum(),
                                [p[k] for k in keys], allow_unused=True)
    want = flatten_tree(numpy_tree(jgrads))
    for k, g in zip(keys, grads):
        got = np.zeros_like(want[k]) if g is None else g.numpy()
        np.testing.assert_allclose(got, want[k], rtol=1e-3, atol=1e-3,
                                   err_msg=k)


@pytest.mark.parametrize("variant,match", [
    (dict(edge_norm="sym_sqrt"), "unweighted"),
    (dict(edge_attention=True), "unweighted"),
])
def test_src_sharding_refuses_edge_weights(variant, match):
    cfg = tcfg.ModelConfig(spmm_backend="pallas", spmm_src_shard_rows=128,
                           **variant)
    with pytest.raises(ValueError, match=match):
        SelfGNN(cfg, 4, 4)


def test_src_sharding_refuses_edge_dropout_in_training():
    cfg = tcfg.ModelConfig(spmm_backend="pallas", spmm_src_shard_rows=128,
                           edge_dropout_keep=0.8)
    SelfGNN(cfg, 4, 4)                       # serving draws no edge mask
    with pytest.raises(ValueError, match="unweighted"):
        tmodel.check_ported(cfg, train=True)
    # the "xla" backend never shards, as in JAX
    tmodel.check_ported(dataclasses.replace(cfg, spmm_backend="xla"),
                        train=True)


# -- training with remat_propagation and fusion_chunk_rows -------------------------

@pytest.fixture(scope="module")
def env():
    bundle, _jm, jg, jp, _tm, tg, tp = setup()
    sampler = JSampler(bundle, batch=16, samp_num=5, ssl_num=3, pred_num=5,
                       pos_length=MCFG.pos_length, test_size=9, seed=3,
                       backend="numpy")
    batch = sampler.train_batch(sampler.epoch_user_ids(40)[:16])
    return bundle, jg, jp, tp, batch


def _torch_batch(jbatch) -> TrainBatch:
    return TrainBatch(*(np.array(getattr(jbatch, f.name))
                        for f in dataclasses.fields(TrainBatch))).to("cpu")


def _port_step(bundle, cfg, params, batch, gen=None):
    """(preLoss, sslloss, {param: grad}) of one step's loss on the port."""
    graphs = graphs_to_device(compile_interval_graphs(bundle.sub_mats,
                                                      pad_multiple=8),
                              "cpu", cfg, bundle.sub_mats)
    model = SelfGNN(cfg, bundle.num_users, bundle.num_items)
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    pre, ssl, _ = model.train_losses(p, graphs, batch, gen)
    loss = pre + 1e-2 * reg_loss(p) + 1e-3 * ssl
    keys = sorted(p)
    grads = torch.autograd.grad(loss, [p[k] for k in keys],
                                allow_unused=True)
    return pre, ssl, {k: torch.zeros_like(p[k]) if g is None else g
                      for k, g in zip(keys, grads)}


MEMORY_OPTIONS = [
    dict(remat_propagation=True),
    dict(fusion_chunk_rows=16),
    dict(remat_propagation=True, fusion_chunk_rows=16),
    dict(remat_propagation=True, fusion_chunk_rows=16,
         spmm_src_shard_rows=16, spmm_fold_gather=True),
]


@pytest.mark.parametrize("opts", MEMORY_OPTIONS,
                         ids=["remat", "chunks", "remat_chunks",
                              "flagship_recipe"])
def test_remat_and_chunked_training_match_jax(env, opts):
    """keepRate 1: the losses and every gradient with the memory options
    equal JAX's with the same options ("xla" backend; the port takes the
    plain versions of its kernels)."""
    bundle, jg, jp, tp, jbatch = env
    jcfg = dataclasses.replace(MCFG, spmm_backend="xla",
                               remat_propagation=opts.get(
                                   "remat_propagation", False),
                               fusion_chunk_rows=opts.get(
                                   "fusion_chunk_rows", 0))
    jm = JSelfGNN(jcfg, bundle.num_users, bundle.num_items)

    def loss_fn(p):
        pre, ssl, _ = jm.train_losses(p, jg, jbatch, rng=None)
        return pre + 1e-2 * j_reg_loss(p) + 1e-3 * ssl, (pre, ssl)

    (_, (j_pre, j_ssl)), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jp)
    cfg = dataclasses.replace(torch_cfg(MCFG), spmm_backend="pallas", **opts)
    pre, ssl, grads = _port_step(bundle, cfg, tp, _torch_batch(jbatch))
    np.testing.assert_allclose(pre.item(), float(j_pre), rtol=1e-5)
    np.testing.assert_allclose(ssl.item(), float(j_ssl), rtol=1e-5)
    want = flatten_tree(numpy_tree(j_grads))
    g_max = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=1e-4,
                                   atol=1e-6 * g_max, err_msg=k)


@pytest.mark.parametrize("opts", MEMORY_OPTIONS + [
    dict(remat_propagation=True, edge_dropout_keep=0.8)],
    ids=["remat", "chunks", "remat_chunks", "flagship_recipe",
         "remat_edge_dropout"])
def test_memory_options_keep_the_dropout_masks(env, opts):
    """keepRate 0.5 (and edge dropout): the same generator seed gives the
    same losses and gradients with the options as without them. A
    recompute that drew its masks anew from the explicit generator would
    give other gradients with the same loss."""
    bundle, _jg, _jp, tp, jbatch = env
    batch = _torch_batch(jbatch)
    base = dataclasses.replace(torch_cfg(MCFG), spmm_backend="pallas",
                               keep_rate=0.5,
                               edge_dropout_keep=opts.get(
                                   "edge_dropout_keep", 1.0))
    want = _port_step(bundle, base, tp, batch,
                      torch.Generator().manual_seed(21))
    other = _port_step(bundle, base, tp, batch,
                       torch.Generator().manual_seed(22))
    assert other[0].item() != want[0].item()          # dropout is on
    got = _port_step(bundle, dataclasses.replace(base, **opts), tp, batch,
                     torch.Generator().manual_seed(21))
    np.testing.assert_allclose(got[0].item(), want[0].item(), rtol=1e-6)
    np.testing.assert_allclose(got[1].item(), want[1].item(), rtol=1e-6)
    g_max = max(float(g.abs().max()) for g in want[2].values())
    for k, w in want[2].items():
        np.testing.assert_allclose(got[2][k].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6 * g_max, err_msg=k)


# -- entry points ----------------------------------------------------------------

def test_trainer_src_sharded_end_to_end(tmp_path):
    """As JAX's test_src_sharded_trainer_end_to_end: an explicit
    spmm_src_shard_rows trains through the sharded Function (forward,
    backward, Adam) and evaluates."""
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.train.trainer import Trainer

    bundle = synthetic_dataset(num_users=40, num_items=60, graph_num=2,
                               test_size=10, seed=11)
    cfg = tcfg.Config(
        model=tcfg.ModelConfig(graph_num=2, gnn_layer=2, att_layer=1,
                               latdim=16, num_heads=4, ssldim=8,
                               pos_length=12, keep_rate=1.0,
                               spmm_backend="pallas",
                               spmm_src_shard_rows=16),
        train=tcfg.TrainConfig(batch=8, samp_num=3, ssl_num=2, trn_num=24,
                               test_size=10, lr=1e-2))
    tr = Trainer(cfg, bundle, ckpt_root=str(tmp_path), device="cpu")
    assert tr.cfg.model.spmm_src_shard_rows == 16
    assert set(tr.graphs["plans_ss"]) == {"u_src", "u_ptr", "i_src",
                                          "i_ptr"}
    first = tr.train_epoch(verbose=False)
    assert np.isfinite(first["Loss"])
    for _ in range(3):
        last = tr.train_epoch(verbose=False)
    assert last["preLoss"] < first["preLoss"]
    assert 0.0 <= tr.test_epoch()["HR"] <= 1.0


def test_recommender_serves_resolved_source_sharding(monkeypatch):
    """The Recommender resolves spmm_src_shard_rows=0 as the Trainer does
    and serves through the sharded plans; the encode equals the
    unsharded one. The threshold is lowered so that a small table
    crosses it."""
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.serve import Recommender

    bundle = synthetic_dataset(num_users=300, num_items=200, graph_num=2,
                               test_size=10, seed=2)
    mc = tcfg.ModelConfig(graph_num=2, gnn_layer=2, att_layer=1, latdim=16,
                          num_heads=4, ssldim=8, pos_length=12,
                          spmm_backend="pallas")
    cfg = tcfg.Config(model=mc, train=tcfg.TrainConfig(test_size=10))
    plain = Recommender(cfg, bundle, device="cpu")
    assert plain.cfg.model.spmm_src_shard_rows == -1
    assert "plans_ss" not in plain.graphs
    monkeypatch.setattr(tcfg, "SRC_SHARD_BYTES", 128 * 4 * 16)
    rec = Recommender(cfg, bundle, plain.params, device="cpu")
    assert rec.cfg.model.spmm_src_shard_rows == 128
    assert rec.graphs["plans_ss"]["u_ptr"].shape == (2, 2, 301)
    for a, b in zip(rec.encode(), plain.encode()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    scores, items = rec.recommend([0, 1, 2], k=5)
    assert items.shape == (3, 5) and bool(torch.isfinite(scores).all())


def test_cli_trains_the_large_generator_with_the_flagship_options(
        tmp_path, capsys):
    from sagnn_tpu_torch import main as cli
    cli.main(["--data", "synthetic", "--device", "cpu", "--synth_users",
              "200", "--synth_items", "150", "--synth_edges", "3000",
              "--synth_test_users", "20", "--graphNum", "2", "--epoch", "1",
              "--trnNum", "32", "--batch", "16", "--testSize", "8",
              "--sslNum", "3", "--sampNum", "4", "--latdim", "16",
              "--num_attention_heads", "4", "--ssldim", "8", "--pos_length",
              "10", "--att_layer", "1", "--tstEpoch", "1", "--spmm_backend",
              "pallas", "--spmm_src_shard_rows", "64", "--spmm_fold_gather",
              "--remat", "--fusion_chunk_rows", "64", "--ckpt_root",
              str(tmp_path), "--save_path", "big"])
    out = capsys.readouterr().out
    assert "Load Data: USER 200 ITEM 150" in out
    assert "Epoch 0/1, Train: Loss = " in out and ", max: " in out
