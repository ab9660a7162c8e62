"""The port's edge-weighted and edge-attention propagation against the JAX
package, on the CPU: edge weights and the cross-direction permutation,
the weighted segment-sum (K2) and the SDDMM (K5) with their gradients, the
edge softmax, encode and training gradients of each variant, edge
dropout, and the trainer, CLI and config surfaces of the variants.

The JAX functions run as tests/test_sddmm.py and tests/test_variants.py
run them (Pallas in interpret mode on the CPU); on the CPU the port's
kernel wrappers run their plain versions.

Tolerances, with their reasons:
  * weights and permutations: byte-equal (the same numpy arithmetic);
  * K2: rtol 1e-5, atol 1e-5·sqrt(max degree)·max|w| (f32 sums of up to
    max-degree terms, in another order); bf16 tables rtol 1e-2 with the
    same atol. JAX rounds the weights to bf16 inside its one-hot operand
    and the port keeps them in f32, so the bf16 cases use weights (and
    cotangents that act as weights) exactly representable in bf16: the
    comparison is then about the table's rounding, not the weights';
  * K5: rtol 1e-5, atol 1e-5·sqrt(D)·max|x|·max|y| (an f32 dot product
    of D terms);
  * edge softmax and attention hops: rtol 1e-4, atol 1e-5 (exp and
    division in f32 after an f32 dot product);
  * encode: slice 1's rtol 1e-4, atol 1e-5 on every output;
  * training: slice 2's losses rtol 1e-5, gradients rtol 1e-4 and atol
    1e-6·max|g| over the whole gradient.
"""

import dataclasses
import os
import stat
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sagnn_tpu.data import graph as jgraph
from sagnn_tpu.data.sampler import Sampler as JSampler
from sagnn_tpu.models.selfgnn import SelfGNN as JSelfGNN
from sagnn_tpu.models.selfgnn import _interval_propagation as j_propagation
from sagnn_tpu.models.selfgnn import reg_loss as j_reg_loss
from sagnn_tpu.ops import edge_attention as jatt
from sagnn_tpu.ops.spmm_pallas import (_plan_args_tracked, plan_spmm,
                                       sddmm_from_plans,
                                       spmm_weighted_from_plans)
from sagnn_tpu.ops.spmm_pallas import build_stacked_plans as j_plans
from sagnn_tpu_torch.config import Config, ModelConfig, TrainConfig
from sagnn_tpu_torch.convert import flatten_tree
from sagnn_tpu_torch.data import graph as tgraph
from sagnn_tpu_torch.data.synthetic import synthetic_dataset
from sagnn_tpu_torch.models import selfgnn as tmodel
from sagnn_tpu_torch.models.selfgnn import (SelfGNN, TrainBatch,
                                            graphs_to_device, reg_loss)
from sagnn_tpu_torch.ops import _build
from sagnn_tpu_torch.ops import edge_attention as tatt
from sagnn_tpu_torch.ops import segment as tseg
from sagnn_tpu_torch.ops import spmm_cuda as sc
from sagnn_tpu_torch.serve import Recommender
from sagnn_tpu_torch.train.trainer import Trainer

from tests.torch_port_helpers import MCFG, numpy_tree, setup, torch_cfg
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATT = dict(rtol=1e-4, atol=1e-5)
PROP = dict(rtol=1e-5, atol=1e-5)


# -- edge weights and the cross-direction permutation -------------------------

SIZES = [dict(num_users=40, num_items=70, graph_num=3, test_size=12, seed=3),
         dict(num_users=25, num_items=30, graph_num=2, test_size=8, seed=11,
              seq_len_range=(2, 9))]


def _with_duplicates(bundle):
    """The bundle's interval matrices, the first one rebuilt as a COO with
    repeated (user, item) entries and an empty user row and item column."""
    m = sp.coo_matrix(bundle.sub_mats[0])
    keep = (m.row != 1) & (m.col != 2)
    rows = np.concatenate([m.row[keep], m.row[keep][:5]])
    cols = np.concatenate([m.col[keep], m.col[keep][:5]])
    dup = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=m.shape)
    return [dup] + list(bundle.sub_mats[1:])


@pytest.mark.parametrize("kw", SIZES)
@pytest.mark.parametrize("norm", ["sym_sqrt", "mean"])
def test_edge_weights_byte_equal(kw, norm):
    mats = _with_duplicates(synthetic_dataset(**kw))
    tg = tgraph.compile_interval_graphs(mats, pad_multiple=8)
    jg = jgraph.compile_interval_graphs(mats, pad_multiple=8)
    t = tgraph.edge_weights(tg, mats, norm)
    j = jgraph.edge_weights(jg, mats, norm)
    assert t.dtype == j.dtype == np.float32 and t.shape == j.shape
    assert np.array_equal(t, j)
    if norm == "mean":   # direction-dependent: the two halves differ
        assert not np.array_equal(t[0], t[1])


@pytest.mark.parametrize("kw", SIZES)
def test_direction_permutation_byte_equal(kw):
    mats = _with_duplicates(synthetic_dataset(**kw))
    tg = tgraph.compile_interval_graphs(mats, pad_multiple=8)
    jg = jgraph.compile_interval_graphs(mats, pad_multiple=8)
    t = tgraph.direction_permutation(tg, mats)
    j = jgraph.direction_permutation(jg, mats)
    assert t.dtype == j.dtype and np.array_equal(t, j)
    inv = tgraph.inverse_permutation(t)
    for k in range(tg.graph_num):
        # the permutation carries each u-slot's edge to its i-slot
        n = tg.edge_counts[k]
        assert np.array_equal(tg.u_src[k][t[k]][:n], tg.i_tgt[k][:n])
        assert np.array_equal(tg.u_tgt[k][t[k]][:n], tg.i_src[k][:n])
        assert np.array_equal(t[k][inv[k]], np.arange(tg.edges_padded))


def test_edge_weights_rejects_an_unknown_norm():
    bundle = synthetic_dataset(**SIZES[1])
    g = tgraph.compile_interval_graphs(bundle.sub_mats)
    with pytest.raises(ValueError):
        tgraph.edge_weights(g, bundle.sub_mats, "max")


# -- K2 and K5 (plain versions) against the Pallas kernels --------------------

def _bipartite(seed, n_u=37, n_i=53, n_edges=400):
    """One interval with duplicate edges and empty rows on both sides: the
    port's graphs (with the permutations) and JAX's tracked plans for
    both directions, in JAX's canonical (u-direction) edge order."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_u - 2, n_edges)        # users n_u-2.. empty
    cols = rng.integers(1, n_i, n_edges)            # item 0 empty
    rows[: n_edges // 5] = 4                        # one long user row
    rows = np.concatenate([rows, rows[:4]])         # duplicate edges
    cols = np.concatenate([cols, cols[:4]])
    m = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n_u, n_i))
    gb = tgraph.compile_interval_graphs([m], pad_multiple=16)
    cfg = ModelConfig(edge_norm="mean")
    g = {k: v[0] for k, v in graphs_to_device(gb, "cpu", cfg, [m]).items()}
    perm = jgraph.direction_permutation(gb, [m])[0]
    plans = {"u": plan_spmm(gb.u_src[0], gb.u_tgt[0], n_u, track_edges=True),
             "i": plan_spmm(gb.i_src[0], gb.i_tgt[0], n_i, edge_ids=perm)}
    return g, plans, perm


def _max_degree(ptr):
    return max(1, int((ptr[1:] - ptr[:-1]).max()))


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _hop(side):
    return side, "i" if side == "u" else "u"


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("side", ["u", "i"])
def test_spmm_weighted_matches_jax(exact, side):
    """K2's plain version, its dx (K2 on the transpose plan) and its dw (K5
    over the forward plan) against JAX `spmm_weighted` and its VJP."""
    g, plans, perm = _bipartite(3)
    side, other = _hop(side)
    n_src = g[f"{other}_ptr"].numel() - 1
    n_tgt = g[f"{side}_ptr"].numel() - 1
    E = g["u_src"].numel()
    rng = np.random.default_rng(11)
    x = rng.standard_normal((n_src, 16)).astype(np.float32)
    w_canon = rng.uniform(0.1, 2.0, E).astype(np.float32)
    cot = rng.standard_normal((n_tgt, 16)).astype(np.float32)
    if not exact:
        w_canon = _bf16(w_canon)
    # JAX runs both hops in the u-direction's order; the port each hop in
    # its own order (the i-direction's values are the canonical ones
    # gathered through the permutation)
    to_own = np.arange(E) if side == "u" else perm

    def jax_loss(x_, w_):
        out = spmm_weighted_from_plans(x_, w_, plans[side], plans[other],
                                       exact)
        return jnp.sum(out * cot), out

    (_, want), (jdx, jdw) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                                jnp.asarray(w_canon))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w_canon[to_own]).requires_grad_()
    out = sc.spmm_weighted(xt, wt, g[f"{side}_src"], g[f"{side}_tgt"],
                           g[f"{side}_ptr"], g[f"{other}_src"],
                           g[f"{other}_ptr"], g[f"{other}_from_{side}"],
                           exact)
    dx, dw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(cot))
    rtol = 1e-5 if exact else 1e-2
    w_max = float(np.abs(w_canon).max())
    atol = 1e-5 * np.sqrt(_max_degree(g[f"{side}_ptr"])) * w_max
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)
    atol_dx = 1e-5 * np.sqrt(_max_degree(g[f"{other}_ptr"])) * w_max
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=rtol,
                               atol=atol_dx)
    atol_dw = 1e-5 * 4.0 * np.abs(x).max() * np.abs(cot).max()
    n = int(g[f"{side}_ptr"][-1])
    np.testing.assert_allclose(dw.numpy()[:n], np.asarray(jdw)[to_own][:n],
                               rtol=rtol, atol=atol_dw)
    assert not dw.numpy()[n:].any()          # pad slots get no gradient


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("side", ["u", "i"])
def test_sddmm_matches_jax(exact, side):
    """K5's plain version, its dx (K2 on the transpose plan) and its dy
    (K2 on the forward plan) against JAX `sddmm` and its VJP."""
    g, plans, perm = _bipartite(5)
    side, other = _hop(side)
    n_src = g[f"{other}_ptr"].numel() - 1
    n_tgt = g[f"{side}_ptr"].numel() - 1
    E = g["u_src"].numel()
    rng = np.random.default_rng(13)
    x = rng.standard_normal((n_src, 16)).astype(np.float32)
    y = rng.standard_normal((n_tgt, 16)).astype(np.float32)
    cot_canon = rng.standard_normal(E).astype(np.float32)
    if not exact:
        cot_canon = _bf16(cot_canon)
    to_own = np.arange(E) if side == "u" else perm

    def jax_loss(x_, y_):
        s = sddmm_from_plans(x_, y_, plans[side], plans[other], exact)
        return jnp.sum(s * cot_canon), s

    (_, want), (jdx, jdy) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                                jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    s = sc.sddmm(xt, yt, g[f"{side}_src"], g[f"{side}_tgt"],
                 g[f"{side}_ptr"], g[f"{other}_src"], g[f"{other}_ptr"],
                 g[f"{other}_from_{side}"], exact)
    dx, dy = torch.autograd.grad(s, (xt, yt),
                                 torch.from_numpy(cot_canon[to_own]))
    rtol = 1e-5 if exact else 1e-2
    atol = 1e-5 * 4.0 * np.abs(x).max() * np.abs(y).max()
    n = int(g[f"{side}_ptr"][-1])
    assert s.shape == (E,) and not s.detach().numpy()[n:].any()
    np.testing.assert_allclose(s.detach().numpy()[:n],
                               np.asarray(want)[to_own][:n], rtol=rtol,
                               atol=atol)
    c_max = float(np.abs(cot_canon).max())
    for got, jwant, plan in ((dx, jdx, other), (dy, jdy, side)):
        atol_g = 1e-5 * np.sqrt(_max_degree(g[f"{plan}_ptr"])) * c_max * \
            max(np.abs(x).max(), np.abs(y).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant),
                                   rtol=rtol, atol=atol_g)


def test_weighted_functions_gradcheck():
    """f64 gradcheck of both Functions (their backwards are the plain
    versions of K2 and K5 here) on a 20-node graph with duplicate edges
    and empty rows."""
    g, _plans, _perm = _bipartite(7, n_u=8, n_i=12, n_edges=30)
    gen = torch.Generator().manual_seed(0)
    E = g["u_src"].numel()
    x = torch.randn((12, 4), dtype=torch.float64, generator=gen,
                    requires_grad=True)
    y = torch.randn((8, 4), dtype=torch.float64, generator=gen,
                    requires_grad=True)
    w = torch.rand(E, dtype=torch.float64, generator=gen, requires_grad=True)
    plan = (g["u_src"], g["u_tgt"], g["u_ptr"], g["i_src"], g["i_ptr"],
            g["i_from_u"], True)
    assert torch.autograd.gradcheck(
        lambda x_, w_: sc.spmm_weighted(x_, w_, *plan), (x, w))
    assert torch.autograd.gradcheck(
        lambda x_, y_: sc.sddmm(x_, y_, *plan), (x, y))


def test_edge_norm_weights_launch_no_sddmm_gradient():
    """A constant w (edge_norm) asks for no dw: the backward computes dx
    only, so on the card no K5 launches in a training step."""
    g, _plans, _perm = _bipartite(9)
    calls = []
    real = sc._sddmm

    def spy(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    x = torch.randn((g["i_ptr"].numel() - 1, 8), requires_grad=True)
    w = torch.rand(g["u_src"].numel())
    plan = (g["u_src"], g["u_tgt"], g["u_ptr"], g["i_src"], g["i_ptr"],
            g["i_from_u"], True)
    sc._sddmm = spy
    try:
        out = sc.spmm_weighted(x, w, *plan)
        torch.autograd.grad(out.sum(), x)
        assert calls == []
        wg = w.clone().requires_grad_()
        torch.autograd.grad(sc.spmm_weighted(x, wg, *plan).sum(), (x, wg))
        assert len(calls) == 1
    finally:
        sc._sddmm = real


def test_weighted_plain_matches_a_dense_product():
    """K2's and K5's plain versions against dense products built from the
    edge list (duplicates counted), in f64."""
    g, _plans, _perm = _bipartite(2, n_u=30, n_i=41, n_edges=250)
    n = int(g["u_ptr"][-1])
    src, tgt = g["u_src"][:n].long(), g["u_tgt"][:n].long()
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, g["u_src"].numel()))
    a = torch.zeros((30, 41), dtype=torch.float64)
    a.index_put_((tgt, src), w[:n], accumulate=True)
    x = torch.from_numpy(rng.standard_normal((41, 6)))
    y = torch.from_numpy(rng.standard_normal((30, 6)))
    got = sc.spmm_weighted_apply_plain(x, w, g["u_src"], g["u_ptr"])
    torch.testing.assert_close(got, a @ x, rtol=1e-12, atol=1e-12)
    s = sc.sddmm_apply_plain(x, y, g["u_src"], g["u_tgt"], g["u_ptr"])
    torch.testing.assert_close(s[:n], (x[src] * y[tgt]).sum(-1), rtol=1e-12,
                               atol=1e-12)
    assert not s[n:].any()


def test_kernel_wrappers_reject_other_devices_and_bad_plans():
    g, _plans, _perm = _bipartite(4)
    x = torch.zeros((g["i_ptr"].numel() - 1, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sc.spmm_weighted_apply(x, torch.zeros(3, device="meta"),
                               g["u_src"], g["u_ptr"])
    y = torch.zeros((5, 8))
    with pytest.raises(ValueError, match="rows"):
        sc.sddmm_apply(torch.zeros((53, 8)), y, g["u_src"], g["u_tgt"],
                       g["u_ptr"])
    w = torch.zeros(3)
    with pytest.raises(ValueError, match="to_bwd"):
        sc.spmm_weighted(torch.zeros((53, 8)), w, g["u_src"], g["u_tgt"],
                         g["u_ptr"], g["i_src"], g["i_ptr"], g["i_from_u"])


# -- edge softmax and the attention hop ---------------------------------------

def test_edge_softmax_matches_jax_with_empty_rows():
    g, _plans, _perm = _bipartite(6)
    E = g["u_src"].numel()
    n = int(g["u_ptr"][-1])
    num_users = g["u_ptr"].numel() - 1
    rng = np.random.default_rng(3)
    scores = (rng.standard_normal(E) * 4).astype(np.float32)
    tgt = g["u_tgt"].numpy()
    mask = (tgt < num_users).astype(np.float32)
    want = np.asarray(jatt.edge_softmax(jnp.asarray(scores),
                                        jnp.asarray(tgt), num_users,
                                        mask=jnp.asarray(mask)))
    st = torch.from_numpy(scores).requires_grad_()
    got = tatt.edge_softmax(st, g["u_tgt"], g["u_ptr"])
    np.testing.assert_allclose(got.detach().numpy(), want, **ATT)
    assert not got.detach().numpy()[n:].any()
    # every non-empty row sums to 1; empty rows own no edge
    sums = np.bincount(tgt[:n], weights=got.detach().numpy()[:n],
                       minlength=num_users)
    deg = np.diff(g["u_ptr"].numpy())
    np.testing.assert_allclose(sums[deg > 0], 1.0, rtol=1e-5)
    assert (deg == 0).any()
    cot = rng.standard_normal(E).astype(np.float32)
    jgrad = jax.grad(lambda s: jnp.sum(jatt.edge_softmax(
        s, jnp.asarray(tgt), num_users, mask=jnp.asarray(mask)) * cot))(
            jnp.asarray(scores))
    tgrad, = torch.autograd.grad(got, st, torch.from_numpy(cot))
    assert np.isfinite(tgrad.numpy()).all()
    np.testing.assert_allclose(tgrad.numpy()[:n], np.asarray(jgrad)[:n],
                               **ATT)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("side", ["u", "i"])
def test_attention_propagate_matches_jax(exact, side):
    """One attention hop and its gradients in both tables against JAX
    `attention_propagate` (Pallas SDDMM and weighted SpMM in interpret
    mode). JAX runs the item-target hop in the u-direction's order with
    unsorted targets; the port in the i-direction's own order."""
    g, plans, _perm = _bipartite(8)
    side, other = _hop(side)
    n_src = g[f"{other}_ptr"].numel() - 1
    n_tgt = g[f"{side}_ptr"].numel() - 1
    rng = np.random.default_rng(17)
    x = rng.standard_normal((n_src, 16)).astype(np.float32)
    y = rng.standard_normal((n_tgt, 16)).astype(np.float32)
    cot = rng.standard_normal((n_tgt, 16)).astype(np.float32)
    num_users = g["u_ptr"].numel() - 1
    emask = jnp.asarray((g["u_tgt"].numpy() < num_users).astype(np.float32))
    canon_tgt = jnp.asarray(g["u_tgt"].numpy() if side == "u"
                            else g["u_src"].numpy())
    fa, fnb, fnt = _plan_args_tracked(plans[side])
    ba, bnb, bnt = _plan_args_tracked(plans[other])

    def jax_loss(x_, y_):
        out = jatt.attention_propagate(x_, y_, canon_tgt, fa, ba, fnb, fnt,
                                       bnb, bnt, mask=emask, exact=exact,
                                       sorted_targets=side == "u")
        return jnp.sum(out * cot), out

    (_, want), (jdx, jdy) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                                jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    out = tatt.attention_propagate(xt, yt, g[f"{side}_src"],
                                   g[f"{side}_tgt"], g[f"{side}_ptr"],
                                   g[f"{other}_src"], g[f"{other}_ptr"],
                                   g[f"{other}_from_{side}"], exact=exact)
    dx, dy = torch.autograd.grad(out, (xt, yt), torch.from_numpy(cot))
    # bf16: JAX rounds the softmax weights to bf16 in its one-hot, the
    # port keeps them f32 (~2^-9 relative)
    tol = ATT if exact else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **tol)
    for got, w in ((dx, jdx), (dy, jdy)):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **tol)
    empty = np.diff(g[f"{side}_ptr"].numpy()) == 0
    assert empty.any() and not out.detach().numpy()[empty].any()


# -- the model: encode and training gradients per variant ---------------------

VARIANTS = {"sym_sqrt": dict(edge_norm="sym_sqrt"),
            "mean": dict(edge_norm="mean"),
            "attention": dict(edge_attention=True)}


@pytest.fixture(scope="module")
def env():
    """The shared bundle and weights, with JAX's graphs carrying tracked
    plans and both weight layouts (per direction for "xla", canonical for
    "pallas") for each norm."""
    bundle, _jm, jg, jp, _tm, _tg, tp = setup()
    gb = jgraph.compile_interval_graphs(bundle.sub_mats, pad_multiple=8)
    perm = jgraph.direction_permutation(gb, bundle.sub_mats)
    plans = j_plans(gb.u_src, gb.u_tgt, gb.i_src, gb.i_tgt, gb.num_users,
                    gb.num_items, gb.edge_counts, track_edges=True,
                    i_edge_ids=perm)
    jg["plans"] = {d: {k: jnp.asarray(v) for k, v in plans[d].items()}
                   for d in ("u", "i")}
    jgs = {}
    for norm in ("sym_sqrt", "mean"):
        ew = jgraph.edge_weights(gb, bundle.sub_mats, norm)
        jgs[norm] = dict(jg, edge_weights=jnp.asarray(ew),
                         edge_weights_canon=jnp.asarray(
                             jgraph.edge_weights_canonical(ew, perm)))
    jgs["attention"] = jg
    sampler = JSampler(bundle, batch=16, samp_num=5, ssl_num=3, pred_num=5,
                       pos_length=MCFG.pos_length, test_size=9, seed=3,
                       backend="numpy")
    batch = sampler.train_batch(sampler.epoch_user_ids(40)[:16])
    return bundle, gb, perm, jgs, jp, tp, batch


def _port(bundle, mcfg):
    tcfg = torch_cfg(mcfg)
    tg = graphs_to_device(
        tgraph.compile_interval_graphs(bundle.sub_mats, pad_multiple=8),
        "cpu", tcfg, bundle.sub_mats)
    return SelfGNN(tcfg, bundle.num_users, bundle.num_items), tg


@pytest.mark.parametrize("variant,jax_backend,port_backend", [
    ("sym_sqrt", "pallas", "pallas"), ("sym_sqrt", "xla", "xla"),
    ("sym_sqrt", "pallas", "xla"), ("mean", "pallas", "pallas"),
    ("mean", "xla", "xla"), ("mean", "xla", "pallas"),
    ("attention", "pallas", "pallas")])
def test_encode_matches_jax(env, variant, jax_backend, port_backend):
    bundle, _gb, _perm, jgs, jp, tp, _batch = env
    jm = JSelfGNN(dataclasses.replace(MCFG, spmm_backend=jax_backend,
                                      **VARIANTS[variant]),
                  bundle.num_users, bundle.num_items)
    want = [np.asarray(a) for a in jm.encode(jp, jgs[variant], train=False)]
    tm, tg = _port(bundle, dataclasses.replace(
        MCFG, spmm_backend=port_backend, **VARIANTS[variant]))
    sc.reset_launches()
    got = [a.numpy() for a in tm.encode(tp, tg)]
    assert sum(sc.LAUNCHES.values()) == 0      # plain versions on the CPU
    for name, w, g in zip(("final_user", "final_item", "user_vec",
                           "item_vec"), want, got):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **ATT)
    # the variant changes the values: it is not the unweighted path
    parity = SelfGNN(torch_cfg(MCFG), bundle.num_users, bundle.num_items)
    assert not np.allclose(parity.encode(tp, tg)[2].numpy(), got[2])


def test_encode_bf16_attention_tracks_f32(env):
    bundle, _gb, _perm, _jgs, _jp, tp, _batch = env
    f32, tg = _port(bundle, dataclasses.replace(MCFG, spmm_backend="pallas",
                                                edge_attention=True))
    bf16, _ = _port(bundle, dataclasses.replace(
        MCFG, spmm_backend="pallas", edge_attention=True, spmm_exact=False))
    for a, b in zip(f32.encode(tp, tg), bf16.encode(tp, tg)):
        assert torch.isfinite(b).all()
        # bf16 tables keep ~3 decimal digits
        torch.testing.assert_close(b, a, rtol=5e-2, atol=5e-2)


def _torch_batch(jbatch) -> TrainBatch:
    return TrainBatch(*(np.array(getattr(jbatch, f.name))
                        for f in dataclasses.fields(TrainBatch))).to("cpu")


@pytest.mark.parametrize("variant,backend", [
    ("mean", "pallas"), ("mean", "xla"), ("attention", "pallas")])
def test_losses_and_grads_match_jax(env, variant, backend):
    bundle, _gb, _perm, jgs, jp, tp, jbatch = env
    mcfg = dataclasses.replace(MCFG, spmm_backend=backend,
                               **VARIANTS[variant])
    jm = JSelfGNN(mcfg, bundle.num_users, bundle.num_items)
    reg, ssl_reg = 1e-2, 1e-3

    def loss_fn(p):
        pre, ssl, _ = jm.train_losses(p, jgs[variant], jbatch, rng=None)
        return pre + reg * j_reg_loss(p) + ssl_reg * ssl, (pre, ssl)

    (_, (j_pre, j_ssl)), j_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(jp)
    tm, tg = _port(bundle, mcfg)
    p = {k: v.clone().requires_grad_() for k, v in tp.items()}
    pre, ssl, _ = tm.train_losses(p, tg, _torch_batch(jbatch))
    keys = sorted(p)
    grads = torch.autograd.grad(pre + reg * reg_loss(p) + ssl_reg * ssl,
                                [p[k] for k in keys])
    np.testing.assert_allclose(pre.item(), float(j_pre), rtol=1e-5)
    np.testing.assert_allclose(ssl.item(), float(j_ssl), rtol=1e-5)
    want = flatten_tree(numpy_tree(j_grads))
    g_max = max(np.abs(w).max() for w in want.values())
    for k, g in zip(keys, grads):
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4,
                                   atol=1e-6 * g_max, err_msg=k)


# -- edge dropout -------------------------------------------------------------

def _jax_dropout_masks(key, keep, shape):
    """The masks JAX's `_interval_propagation` draws from dropout_rng:
    one per direction, from the halves of one split."""
    ku, ki = jax.random.split(key)
    return tuple(np.asarray(jax.random.bernoulli(k, keep, shape),
                            np.float32) for k in (ku, ki))


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
@pytest.mark.parametrize("port_backend", ["xla", "pallas"])
def test_edge_dropout_with_jax_masks_matches_jax(env, jax_backend,
                                                 port_backend):
    """JAX's own dropout masks fed to the port's propagation, and the
    gradient of a loss on the node states. The two JAX backends draw in
    different orders: "xla" draws each direction's mask in that
    direction's own COO order, "pallas" both in the canonical
    (u-direction) order, so the i-direction's mask reaches the port
    through the permutation there."""
    bundle, gb, perm, jgs, jp, tp, _batch = env
    keep, key = 0.7, jax.random.PRNGKey(21)
    mcfg = dataclasses.replace(MCFG, spmm_backend=jax_backend,
                               edge_norm="sym_sqrt", edge_dropout_keep=keep)
    m_u, m_i = _jax_dropout_masks(key, keep, gb.u_src.shape)
    if jax_backend == "pallas":
        m_i = np.take_along_axis(m_i, perm, axis=1)
    ew = jgraph.edge_weights(gb, bundle.sub_mats, "sym_sqrt")
    w_u, w_i = ew[0] * m_u / keep, ew[1] * m_i / keep

    def jloss(p):
        uv, iv = j_propagation(p, jgs["sym_sqrt"], mcfg, bundle.num_users,
                               bundle.num_items, dropout_rng=key)
        return jnp.sum(uv ** 2) + jnp.sum(iv * 0.5), (uv, iv)

    (_, (juv, jiv)), jgrad = jax.value_and_grad(jloss, has_aux=True)(jp)
    tm, tg = _port(bundle, dataclasses.replace(mcfg,
                                               spmm_backend=port_backend))
    p = {k: v.clone().requires_grad_() for k, v in tp.items()}
    uv, iv = tmodel._interval_propagation(
        p, tg, tm.cfg, bundle.num_users, bundle.num_items,
        (torch.from_numpy(w_u), torch.from_numpy(w_i)))
    np.testing.assert_allclose(uv.detach().numpy(), np.asarray(juv), **PROP)
    np.testing.assert_allclose(iv.detach().numpy(), np.asarray(jiv), **PROP)
    keys = ["reg/u_embed", "reg/i_embed"]
    grads = torch.autograd.grad(torch.sum(uv ** 2) + torch.sum(iv * 0.5),
                                [p[k] for k in keys])
    want = flatten_tree(numpy_tree(jgrad))
    for k, g in zip(keys, grads):
        np.testing.assert_allclose(g.numpy(), want[k], err_msg=k, **ATT)
    # the mask did drop edges: not the undropped propagation
    plain, _ = tmodel._interval_propagation(tp, tg, tm.cfg, bundle.num_users,
                                            bundle.num_items)
    assert not np.allclose(plain.numpy(), uv.detach().numpy())


def test_edge_dropout_weights_keep_rate_and_scale():
    gen = torch.Generator().manual_seed(3)
    w = tseg.edge_dropout_weights(gen, (4, 50_000), 0.8)
    vals = set(np.unique(w.numpy()).tolist())
    assert vals == {0.0, np.float32(1 / 0.8)}
    kept = float((w > 0).float().mean())
    # 200,000 Bernoulli(0.8) draws: sd 0.0009
    assert abs(kept - 0.8) < 0.005
    base = torch.rand((4, 50_000), generator=gen)
    again = tseg.edge_dropout_weights(torch.Generator().manual_seed(3),
                                      (4, 50_000), 0.8, base)
    torch.testing.assert_close(again, w * base)


def test_model_draws_edge_dropout_per_step_and_direction(env):
    """encode(train=True, gen) draws the u-direction mask, then the
    i-direction mask, from `gen` before any LSTM mask; without a
    generator (serving) nothing is dropped."""
    bundle, _gb, _perm, _jgs, _jp, tp, _batch = env
    mcfg = dataclasses.replace(MCFG, spmm_backend="pallas",
                               edge_dropout_keep=0.6)
    tm, tg = _port(bundle, mcfg)
    gen = torch.Generator().manual_seed(9)
    w_u, w_i = tmodel.edge_dropout(tg, tm.cfg, gen)
    assert not torch.equal(w_u > 0, w_i > 0)
    uv, _iv = tmodel._interval_propagation(tp, tg, tm.cfg, bundle.num_users,
                                           bundle.num_items, (w_u, w_i))
    got = tm.encode(tp, tg, train=True,
                    gen=torch.Generator().manual_seed(9))[2]
    torch.testing.assert_close(got, uv, rtol=0, atol=0)
    parity = SelfGNN(torch_cfg(MCFG), bundle.num_users, bundle.num_items)
    serve = tm.encode(tp, tg)[2]
    torch.testing.assert_close(serve, parity.encode(tp, tg)[2], rtol=0,
                               atol=0)
    assert not torch.equal(serve, got)


# -- trainer, CLI, serving and config surfaces --------------------------------

def _cfg(epoch=2, backend="pallas", **model):
    m = dict(latdim=16, graph_num=2, gnn_layer=2, att_layer=1, num_heads=4,
             ssldim=8, pos_length=10, keep_rate=0.5, spmm_backend=backend)
    m.update(model)
    return Config(model=ModelConfig(**m), train=TrainConfig(
        lr=2e-3, batch=16, reg=1e-2, ssl_reg=1e-3, epoch=epoch, trn_num=32,
        samp_num=4, ssl_num=3, test_size=8, tst_epoch=1, seed=5,
        save_path="run"))


@pytest.fixture(scope="module")
def bundle():
    return synthetic_dataset(num_users=48, num_items=64, graph_num=2,
                             test_size=8, seed=2)


@pytest.mark.parametrize("variant", [
    dict(edge_norm="sym_sqrt"), dict(edge_norm="mean", backend="xla"),
    dict(edge_dropout_keep=0.8), dict(edge_dropout_keep=0.8, backend="xla"),
    dict(edge_attention=True)], ids=["sym_sqrt", "mean-xla", "dropout",
                                     "dropout-xla", "attention"])
def test_trainer_runs_each_variant(bundle, tmp_path, variant):
    tr = Trainer(_cfg(**variant), bundle, ckpt_root=str(tmp_path),
                 device="cpu")
    best = tr.run()
    losses = tr.history.data["TrainLoss"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert 0.0 <= best["HR"] <= 1.0
    assert all(torch.isfinite(v).all() for v in tr.state["params"].values())


def test_resume_with_edge_dropout_replays_the_uninterrupted_run(bundle,
                                                                tmp_path):
    """The edge-dropout masks come from the checkpointed dropout
    generator: a resumed run reproduces the uninterrupted one bit for
    bit."""
    full = Trainer(_cfg(epoch=3, edge_dropout_keep=0.8), bundle,
                   ckpt_root=str(tmp_path / "a"), device="cpu")
    full.run()
    Trainer(_cfg(epoch=1, edge_dropout_keep=0.8), bundle,
            ckpt_root=str(tmp_path / "b"), device="cpu").run()
    cfg = _cfg(epoch=3, edge_dropout_keep=0.8)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, load_model="run"))
    resumed = Trainer(cfg, bundle, ckpt_root=str(tmp_path / "b"),
                      device="cpu")
    resumed.run()
    assert resumed.history.data["TrainLoss"] == \
        full.history.data["TrainLoss"]
    for k, v in full.state["params"].items():
        assert torch.equal(resumed.state["params"][k], v), k


@pytest.mark.parametrize("flags", [["--edge_attention"],
                                   ["--edge_norm", "mean",
                                    "--edge_dropout_keep", "0.8"]],
                         ids=["attention", "mean-dropout"])
def test_cli_trains_a_variant_on_the_cpu(tmp_path, flags):
    cmd = [sys.executable, "-m", "sagnn_tpu_torch.main", "--data",
           "synthetic", "--device", "cpu", "--synth_users", "48",
           "--synth_items", "64", "--graphNum", "2", "--epoch", "1",
           "--trnNum", "32", "--batch", "16", "--testSize", "8",
           "--sslNum", "3", "--sampNum", "4", "--latdim", "16",
           "--num_attention_heads", "4", "--ssldim", "8", "--pos_length",
           "10", "--att_layer", "1", "--tstEpoch", "1", "--spmm_backend",
           "pallas", "--ckpt_root", str(tmp_path), *flags]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Epoch 0/1, Train: Loss = " in out.stdout
    assert ", max: " in out.stdout


def test_serve_cli_with_edge_attention(tmp_path):
    cmd = [sys.executable, "-m", "sagnn_tpu_torch.serve", "--data",
           "synthetic", "--preset", "gowalla", "--device", "cpu",
           "--synth_users", "48", "--synth_items", "64", "--users", "0",
           "5", "--k", "4", "--edge_attention"]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2 and '"items"' in lines[0]


def test_converted_jax_params_serve_with_edge_attention(env):
    """JAX params carry no attention parameters (edge attention has
    none): converted as they are, they serve through a Recommender with
    edge_attention=True and give JAX's encode."""
    bundle, _gb, _perm, jgs, jp, _tp, _batch = env
    from sagnn_tpu_torch.convert import params_from_numpy
    mcfg = dataclasses.replace(MCFG, spmm_backend="pallas",
                               edge_attention=True)
    jm = JSelfGNN(mcfg, bundle.num_users, bundle.num_items)
    want = [np.asarray(a) for a in jm.encode(jp, jgs["attention"])[:2]]
    cfg = Config(model=torch_cfg(mcfg), train=TrainConfig(test_size=9))
    rec = Recommender(cfg, bundle, params_from_numpy(numpy_tree(jp)),
                      device="cpu")
    # compile_interval_graphs pads to 512 here, JAX's graphs to 8: the
    # padding changes no value
    for w, g in zip(want, rec.encode()):
        np.testing.assert_allclose(g.numpy(), w, **ATT)
    scores, items = rec.recommend([0, 1, 2], k=5)
    assert torch.isfinite(scores).all() and items.shape == (3, 5)


@pytest.mark.parametrize("model", [
    dict(edge_norm="sym_sqrt"), dict(edge_norm="mean"),
    dict(edge_attention=True), dict(edge_dropout_keep=0.5)],
    ids=["sym_sqrt", "mean", "attention", "dropout"])
def test_check_ported_accepts_the_variants(model):
    cfg = dataclasses.replace(torch_cfg(MCFG), spmm_backend="pallas",
                              **model)
    tmodel.check_ported(cfg, train=True)


@pytest.mark.parametrize("model", [
    dict(edge_attention=True, spmm_backend="xla"),
    dict(edge_attention=True, edge_norm="sym_sqrt"),
    dict(edge_attention=True, edge_dropout_keep=0.9)],
    ids=["xla", "edge_norm", "dropout"])
def test_edge_attention_exclusivity(model):
    cfg = dataclasses.replace(torch_cfg(MCFG),
                              **{"spmm_backend": "pallas", **model})
    with pytest.raises(ValueError, match="edge_attention"):
        SelfGNN(cfg, 4, 4)


def test_graphs_for_a_variant_need_the_interval_matrices(bundle):
    gb = tgraph.compile_interval_graphs(bundle.sub_mats)
    cfg = dataclasses.replace(torch_cfg(MCFG), edge_norm="mean")
    with pytest.raises(ValueError, match="sub_mats"):
        graphs_to_device(gb, "cpu", cfg)
    assert "edge_weights" not in graphs_to_device(gb, "cpu", torch_cfg(MCFG))


# -- the build --------------------------------------------------------------

def test_build_compiles_each_source_and_links_once(tmp_path, monkeypatch):
    """With a stand-in nvcc that logs its calls: one compile per .cu
    source, started before any is waited for, then one link; the library
    lands under a name that hashes the sources; a second build reuses
    it."""
    calls = tmp_path / "calls.txt"
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\n"
                    f"echo \"$@\" >> {calls}\n"
                    "while [ \"$1\" != \"-o\" ]; do shift; done\n"
                    "echo built > \"$2\"\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "c.cuh"):
        (csrc / name).write_text(f"// {name}\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    info = _build.build.__wrapped__()
    lines = calls.read_text().splitlines()
    assert len(lines) == 3
    assert all("-c" in ln.split() for ln in lines[:2])
    assert {ln.split()[-1].rsplit("/", 1)[-1] for ln in lines[:2]} == \
        {"a.cu", "b.cu"}
    assert "-shared" in lines[2].split()
    assert os.path.isfile(info.path) and info.path == _build.library_path()
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        [os.path.basename(info.path), os.path.basename(info.path) + ".log"])
    again = _build.build.__wrapped__()
    assert again.seconds == 0.0 and len(calls.read_text().splitlines()) == 3
