"""The CUDA kernels on the card against their plain versions: the
segment-sum (K1) forward and backward, its weighted mode (K2), its
accumulating (K3) and row-folded (K4) modes on sharded and sliced plans,
the SDDMM (K5) with both autograd Functions (also on a 10,000-edge
target row; its bf16 rounding in registers held bit for bit against
tables cast first; one CUDA kernel per call; independent of the grid),
the ring buckets (K6) over a one-card mesh of four ranks with their
backward, and the probes (P1, the row gather, in every template mode,
one CUDA kernel per call, independent of the grid; P2, the ablated
segment-sum); the segment-sum kernel's edge-balanced schedule in every
mode on the plans that stress it (one row with every edge, rows ending on
piece boundaries, mostly empty rows, a shard's and a slice's plan), with
its determinism, its clean scratch and its independence of the grid; the
serving encode (parity, each edge variant and the ring) and a training step on
the card against the CPU; the all-gather edge partition's hop (K1 per
rank) forward and backward; the supervisor declaring a hung CUDA call
(blocking sync) before and after the child's first log line; a 2 x 2
one-card mesh step against the single-device step, and two processes
sharing the card over gloo against one process on a 2 x 1 mesh; the
interval attention kernel pair (forward and its backward) against the
plain small-T path, NaN for NaN where raw exp overflows, under a
checkpoint, and its launches in a training step, an encode and a request.

These tests need an NVIDIA card and nvcc; elsewhere they skip. They import
neither JAX nor the JAX package, so they run on a machine with PyTorch
alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import math

import numpy as np
import pytest
import torch

from sagnn_tpu_torch.ops import spmm_cuda as sc

pytestmark = pytest.mark.cuda

F32_EPS = float(torch.finfo(torch.float32).eps)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _graph(n_tgt, n_src, n_edges, n_pad, seed, skew=False):
    rng = np.random.default_rng(seed)
    tgt = rng.integers(0, n_tgt, n_edges)
    if skew:
        tgt[: n_edges // 2] = n_tgt // 3      # one hot row
    tgt = np.sort(tgt)
    src = rng.integers(0, n_src, n_edges + n_pad).astype(np.int32)
    ptr = sc.csr_row_ptr(np.concatenate([tgt, np.full(n_pad, n_tgt)]), n_tgt)
    return torch.from_numpy(src), torch.from_numpy(ptr)


def _tol(ptr, x):
    """rtol 1e-5, and an atol that bounds the f32 rounding of the hottest
    row's sum: the f32 epsilon times max degree x max|x|, a bound on that
    row's sum of absolute values. The rounding grows with the row's length
    (about as the degree for a row of N(0, 1) terms), so the bound does
    too."""
    deg = int((ptr[1:] - ptr[:-1]).max()) if ptr.numel() > 1 else 0
    amax = float(x.abs().max()) if x.numel() else 0.0
    return dict(rtol=1e-5, atol=F32_EPS * max(1, deg) * amax)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("d", [2, 16, 64, 96, 128])
@pytest.mark.parametrize("skew", [False, True])
def test_kernel_matches_plain(dev, exact, d, skew):
    src, ptr = _graph(1000, 700, 20_000, 37, seed=d, skew=skew)
    x = torch.randn((700, d), generator=torch.Generator().manual_seed(d))
    # the plain version on the CPU, summed in f64: the reference for the
    # kernel's own f32 rounding
    want = sc.spmm_apply_plain(x.double(), src, ptr, exact)
    before = dict(sc.LAUNCHES)
    got = sc.spmm_apply(x.to(dev), src.to(dev), ptr.to(dev), exact)
    torch.cuda.synchronize()
    name = "segsum_f32" if exact else "segsum_bf16"
    assert sc.LAUNCHES[name] == before[name] + 1
    assert got.shape == (1000, d) and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu().double(), want, **_tol(ptr, x))


def test_kernel_is_deterministic(dev):
    src, ptr = _graph(500, 400, 30_000, 0, seed=1, skew=True)
    x = torch.randn((400, 64), device=dev)
    a = sc.spmm_apply(x, src.to(dev), ptr.to(dev))
    b = sc.spmm_apply(x, src.to(dev), ptr.to(dev))
    assert torch.equal(a, b)


def test_kernel_empty_graph_and_rows(dev):
    x = torch.randn((50, 64), device=dev)
    ptr = torch.zeros(65, dtype=torch.int32, device=dev)
    src = torch.zeros(512, dtype=torch.int32, device=dev)
    for exact in (True, False):
        out = sc.spmm_apply(x, src, ptr, exact)
        torch.cuda.synchronize()
        assert out.shape == (64, 64) and not out.any()
    before = dict(sc.LAUNCHES)
    none = sc.spmm_apply(x, src, ptr[:1])                # no target rows
    assert none.shape == (0, 64) and sc.LAUNCHES == before


def test_kernel_rejects_bad_inputs(dev):
    x = torch.randn((10, 64), device=dev)
    src = torch.zeros(4, dtype=torch.int32, device=dev)
    ptr = torch.zeros(5, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        sc.spmm_apply(torch.randn((10, 63), device=dev), src, ptr)
    with pytest.raises(ValueError):
        sc.spmm_apply(x, src.long(), ptr)
    with pytest.raises(ValueError):
        sc.spmm_apply(x, src.cpu(), ptr)
    # the backward plan's targets must be x's rows
    with pytest.raises(ValueError, match="backward plan"):
        sc.spmm(x, src, ptr, src, ptr)


def _f64_encode(rec):
    """The encode of `rec`'s weights on the CPU with every op in f64 (the
    plain propagation and the fusion stack)."""
    from sagnn_tpu_torch.models.selfgnn import graphs_to_device
    from sagnn_tpu_torch.data.graph import compile_interval_graphs

    graphs = graphs_to_device(compile_interval_graphs(rec.bundle.sub_mats),
                              "cpu", rec.cfg.model, rec.bundle.sub_mats)
    p64 = {k: v.detach().cpu().double() for k, v in rec.params.items()}
    return rec.model.encode(p64, graphs)[:2]


def _check_against_f64(sides, ref, names=("final_user", "final_item")):
    """Hold each side's encode against the f64 reference at rtol 1e-4 and
    atol 1e-5 x the output's max |value|, and print what the former
    card-vs-CPU check (rtol 1e-4, atol 1e-5 per element) would have
    failed: each failing element's values, row and column.

    Why this tolerance: an encode output is computed from values up to
    ~3.6 through the LSTM, the raw-exp attention and the layer norms, so
    an element near 0 carries the honest f32 error of that scale
    (~1e-5 x 3.6), which a per-element atol of 1e-5 does not allow for.
    Each side is held against f64 rather than against the other, so the
    check measures each side's own rounding."""
    for i, name in enumerate(names):
        r = ref[i]
        scale = float(r.abs().max())
        errs = {side: float((t[i].cpu().double() - r).abs().max())
                for side, t in sides.items()}
        cpu, card = (sides[k][i].cpu() for k in ("cpu", "card"))
        bad = ~torch.isclose(card, cpu, rtol=1e-4, atol=1e-5)
        rows, cols = torch.nonzero(bad, as_tuple=True)
        print(f"{name}: max|v| {scale:.4f}; max abs err vs f64: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f"; card-vs-cpu elements outside rtol 1e-4/atol 1e-5: "
              f"{int(bad.sum())} of {bad.numel()}"
              + "".join(f"; [row {int(a)}, col {int(b)}] card "
                        f"{float(card[a, b]):.6e} cpu {float(cpu[a, b]):.6e}"
                        f" f64 {float(r[a, b]):.6e}"
                        for a, b in zip(rows[:8], cols[:8])))
        for side, t in sides.items():
            torch.testing.assert_close(t[i].cpu().double(), r, rtol=1e-4,
                                       atol=1e-5 * scale,
                                       msg=f"{side} {name}")


def test_recommender_on_card_matches_cpu(dev):
    import dataclasses

    from sagnn_tpu_torch.config import PRESETS
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.serve import Recommender

    base = PRESETS["gowalla"]
    cfg = base.replace(
        model=dataclasses.replace(base.model, spmm_backend="pallas"),
        train=dataclasses.replace(base.train, test_size=30, batch=32,
                                  seed=1))
    bundle = synthetic_dataset(num_users=70, num_items=90, graph_num=3,
                               test_size=30, seed=2)
    cpu = Recommender(cfg, bundle, device="cpu")
    gpu = Recommender(cfg, bundle, cpu.params, device=dev)
    _check_against_f64({"cpu": cpu.encode(), "card": gpu.encode()},
                       _f64_encode(cpu))
    assert cpu.evaluate() == pytest.approx(gpu.evaluate(), abs=1e-6)


@pytest.mark.parametrize("variant", [
    dict(edge_norm="sym_sqrt"), dict(edge_norm="mean"),
    dict(edge_attention=True)], ids=["sym_sqrt", "mean", "attention"])
def test_variant_encode_on_card_matches_cpu(dev, variant):
    """Each edge variant's encode on the card (K2; K5 + K2 for attention)
    and on the CPU, each held against the f64 encode; the launches."""
    import dataclasses

    from sagnn_tpu_torch.config import PRESETS
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.serve import Recommender

    base = PRESETS["gowalla"]
    cfg = base.replace(
        model=dataclasses.replace(base.model, spmm_backend="pallas",
                                  **variant),
        train=dataclasses.replace(base.train, test_size=30, seed=1))
    bundle = synthetic_dataset(num_users=70, num_items=90, graph_num=3,
                               test_size=30, seed=2)
    cpu = Recommender(cfg, bundle, device="cpu")
    gpu = Recommender(cfg, bundle, cpu.params, device=dev)
    sc.reset_launches()
    card = gpu.encode()
    torch.cuda.synchronize()
    hops = 12
    want = {"wsegsum_f32": hops}
    if variant.get("edge_attention"):
        want["sddmm_f32"] = hops
    assert {k: v for k, v in sc.LAUNCHES.items() if v} == want
    _check_against_f64({"cpu": cpu.encode(), "card": card},
                       _f64_encode(cpu))


def test_encode_is_repeatable_on_card(dev):
    """The kernel path's encode has no atomics: repeated encodes on the
    card give the same bits, as repeated CPU encodes do."""
    import dataclasses

    from sagnn_tpu_torch.config import PRESETS
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.serve import Recommender

    base = PRESETS["gowalla"]
    cfg = base.replace(
        model=dataclasses.replace(base.model, spmm_backend="pallas"),
        train=dataclasses.replace(base.train, test_size=30, seed=1))
    bundle = synthetic_dataset(num_users=70, num_items=90, graph_num=3,
                               test_size=30, seed=2)
    for device in ("cpu", dev):
        rec = Recommender(cfg, bundle, device=device)
        first = [t.clone() for t in rec.encode()]
        for _ in range(10):
            for a, b in zip(first, rec.encode()):
                assert torch.equal(a, b), device


def _bipartite(dev, n_u, n_i, n_edges, seed):
    """Both directions' plans of one random U x I interval graph with
    duplicate edges and empty rows, on `dev`."""
    import scipy.sparse as sp

    from sagnn_tpu_torch.data.graph import compile_interval_graphs
    from sagnn_tpu_torch.models.selfgnn import graphs_to_device

    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_u - 2, n_edges)
    cols = rng.integers(1, n_i, n_edges)
    rows[: n_edges // 4] = 3                    # one hot user row
    rows = np.concatenate([rows, rows[:9]])     # duplicate edges
    cols = np.concatenate([cols, cols[:9]])
    m = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n_u, n_i))
    g = graphs_to_device(compile_interval_graphs([m]), dev)
    return {k: v[0] for k, v in g.items()}


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("side", ["u", "i"])
def test_backward_matches_plain(dev, exact, side):
    """dx of `spmm` (the kernel on the transpose plan) against the plain
    transpose sum in f64."""
    g = _bipartite(dev, 600, 800, 20_000, seed=4)
    other = "i" if side == "u" else "u"
    n_x = g[f"{other}_ptr"].numel() - 1
    n_t = g[f"{side}_ptr"].numel() - 1
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((n_x, 64), generator=gen).to(dev).requires_grad_()
    cot = torch.randn((n_t, 64), generator=gen)
    out = sc.spmm(x, g[f"{side}_src"], g[f"{side}_ptr"], g[f"{other}_src"],
                  g[f"{other}_ptr"], exact)
    name = "segsum_f32_bwd" if exact else "segsum_bf16_bwd"
    before = dict(sc.LAUNCHES)
    dx, = torch.autograd.grad(out, x, cot.to(dev))
    torch.cuda.synchronize()
    assert sc.LAUNCHES[name] == before[name] + 1
    want = sc.spmm_apply_plain(cot.double(), g[f"{other}_src"].cpu(),
                               g[f"{other}_ptr"].cpu(), exact)
    torch.testing.assert_close(dx.cpu().double(), want,
                               **_tol(g[f"{other}_ptr"], cot))


def test_train_step_on_card_matches_cpu(dev, tmp_path):
    """One training step (keep_rate 1, so no dropout stream is involved)
    through the Trainer on the card and on the CPU from the same weights
    and batch: losses at rtol 1e-5, every gradient at rtol 1e-4 and atol
    1e-5 x max|g|; 12 forward and 12 backward launches on the card."""
    import dataclasses

    from sagnn_tpu_torch.config import PRESETS
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.models.selfgnn import reg_loss
    from sagnn_tpu_torch.train.trainer import Trainer

    base = PRESETS["gowalla"]
    cfg = base.replace(
        model=dataclasses.replace(base.model, spmm_backend="pallas",
                                  keep_rate=1.0),
        train=dataclasses.replace(base.train, test_size=30, batch=32,
                                  trn_num=64, samp_num=8, ssl_num=6,
                                  seed=1))
    bundle = synthetic_dataset(num_users=70, num_items=90, graph_num=3,
                               test_size=30, seed=2)
    results = []
    for device in ("cpu", dev):
        tr = Trainer(cfg, bundle, ckpt_root=str(tmp_path), device=device)
        ids = tr.sampler.epoch_user_ids(cfg.train.trn_num)
        batch = tr.sampler.train_batch(ids[:cfg.train.batch]).to(device)
        params = tr.state["params"]
        sc.reset_launches()
        pre, ssl, _ = tr.model.train_losses(params, tr.graphs, batch)
        loss = pre + cfg.train.reg * reg_loss(params) + \
            cfg.train.ssl_reg * ssl
        keys = sorted(params)
        grads = torch.autograd.grad(loss, [params[k] for k in keys])
        torch.cuda.synchronize()
        launches = dict(sc.LAUNCHES)
        results.append((pre.item(), ssl.item(),
                         {k: g.cpu() for k, g in zip(keys, grads)}))
        stats = tr.train_step(batch)
        assert all(np.isfinite(float(v)) for v in stats.values())
    assert {k: v for k, v in launches.items() if v} == {
        "segsum_f32": 12, "segsum_f32_bwd": 12}
    (pre_c, ssl_c, g_c), (pre_d, ssl_d, g_d) = results
    assert pre_d == pytest.approx(pre_c, rel=1e-5)
    assert ssl_d == pytest.approx(ssl_c, rel=1e-5)
    g_max = max(float(g.abs().max()) for g in g_c.values())
    for k in g_c:
        torch.testing.assert_close(g_d[k], g_c[k], rtol=1e-4,
                                   atol=1e-5 * g_max, msg=k)


# -- K2 and K5 ---------------------------------------------------------------

@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("d", [2, 16, 64, 96])
@pytest.mark.parametrize("skew", [False, True])
def test_weighted_kernel_matches_plain(dev, exact, d, skew):
    """K2 against its plain version summed in f64, at `_tol` with the
    largest term max|x| x max|w|."""
    src, ptr = _graph(1000, 700, 20_000, 37, seed=d + 1, skew=skew)
    gen = torch.Generator().manual_seed(d)
    x = torch.randn((700, d), generator=gen)
    w = torch.rand(src.numel(), generator=gen) * 2 - 0.5
    want = sc.spmm_weighted_apply_plain(x.double(), w.double(), src, ptr,
                                        exact)
    before = dict(sc.LAUNCHES)
    got = sc.spmm_weighted_apply(x.to(dev), w.to(dev), src.to(dev),
                                 ptr.to(dev), exact)
    torch.cuda.synchronize()
    name = "wsegsum_f32" if exact else "wsegsum_bf16"
    assert sc.LAUNCHES[name] == before[name] + 1
    torch.testing.assert_close(got.cpu().double(), want,
                               **_tol(ptr, x * float(w.abs().max())))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("d", [2, 16, 64, 96, 130])
def test_sddmm_kernel_matches_plain(dev, exact, d):
    """K5 against its plain version in f64, at rtol 1e-5 and atol
    1e-5 x sqrt(D) x max|x| x max|y|; pad slots score 0."""
    n_tgt, n_src = 1000, 700
    src, ptr = _graph(n_tgt, n_src, 20_003, 41, seed=d, skew=True)
    tgt = torch.repeat_interleave(torch.arange(n_tgt),
                                  (ptr[1:] - ptr[:-1]).long())
    tgt = torch.cat([tgt, torch.full((41,), n_tgt)]).to(torch.int32)
    gen = torch.Generator().manual_seed(d)
    x = torch.randn((n_src, d), generator=gen)
    y = torch.randn((n_tgt, d), generator=gen)
    want = sc.sddmm_apply_plain(x.double(), y.double(), src, tgt, ptr,
                                exact)
    before = dict(sc.LAUNCHES)
    got = sc.sddmm_apply(x.to(dev), y.to(dev), src.to(dev), tgt.to(dev),
                         ptr.to(dev), exact)
    torch.cuda.synchronize()
    name = "sddmm_f32" if exact else "sddmm_bf16"
    assert sc.LAUNCHES[name] == before[name] + 1
    assert got.shape == (src.numel(),)
    assert not got[-41:].any()
    atol = 1e-5 * math.sqrt(d) * float(x.abs().max() * y.abs().max())
    torch.testing.assert_close(got.cpu().double(), want, rtol=1e-5,
                               atol=atol)
    again = sc.sddmm_apply(x.to(dev), y.to(dev), src.to(dev), tgt.to(dev),
                           ptr.to(dev), exact)
    assert torch.equal(got, again)            # deterministic


def test_sddmm_kernel_empty_graph(dev):
    x = torch.randn((50, 64), device=dev)
    y = torch.randn((64, 64), device=dev)
    ptr = torch.zeros(65, dtype=torch.int32, device=dev)
    src = torch.zeros(512, dtype=torch.int32, device=dev)
    tgt = torch.full((512,), 64, dtype=torch.int32, device=dev)
    for exact in (True, False):
        s = sc.sddmm_apply(x, y, src, tgt, ptr, exact)
        torch.cuda.synchronize()
        assert s.shape == (512,) and not s.any()


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("side", ["u", "i"])
def test_weighted_functions_backward_match_plain(dev, exact, side):
    """SpmmWeightedFunction (dx: K2 on the transpose plan; dw: K5) and
    SddmmFunction (dy: K2 on the forward plan; dx: K2 on the transpose
    plan) on the card against the same Functions on the CPU in f64 (their
    plain versions); the launches of each backward."""
    import dataclasses

    import scipy.sparse as sp

    from sagnn_tpu_torch.config import ModelConfig
    from sagnn_tpu_torch.data.graph import compile_interval_graphs
    from sagnn_tpu_torch.models.selfgnn import graphs_to_device

    rng = np.random.default_rng(4)
    rows = rng.integers(0, 598, 20_000)
    cols = rng.integers(1, 800, 20_000)
    rows[:5000] = 3
    m = sp.coo_matrix((np.ones(20_000), (rows, cols)), shape=(600, 800))
    cfg = dataclasses.replace(ModelConfig(), edge_norm="mean")
    gb = compile_interval_graphs([m])
    other = "i" if side == "u" else "u"
    plans = {}
    for where in ("cpu", dev):
        g = graphs_to_device(gb, where, cfg, [m])
        plans[str(where)] = tuple(g[k][0] for k in (
            f"{side}_src", f"{side}_tgt", f"{side}_ptr", f"{other}_src",
            f"{other}_ptr", f"{other}_from_{side}"))
    n_x = plans["cpu"][4].numel() - 1
    n_t = plans["cpu"][2].numel() - 1
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((n_x, 64), generator=gen)
    y = torch.randn((n_t, 64), generator=gen)
    w = torch.rand(plans["cpu"][0].numel(), generator=gen)
    g_out = torch.randn((n_t, 64), generator=gen)
    g_s = torch.randn(plans["cpu"][0].numel(), generator=gen)

    def run(where, dtype):
        xs, ws, ys = (t.to(where, dtype).requires_grad_() for t in (x, w, y))
        p = plans[str(where)]
        out = sc.spmm_weighted(xs, ws, *p, exact)
        dx_w, dw = torch.autograd.grad(out, (xs, ws), g_out.to(where, dtype))
        s = sc.sddmm(xs, ys, *p, exact)
        dx_s, dy = torch.autograd.grad(s, (xs, ys), g_s.to(where, dtype))
        return out, dx_w, dw, s, dx_s, dy

    sc.reset_launches()
    got = run(dev, torch.float32)
    torch.cuda.synchronize()
    mode = "f32" if exact else "bf16"
    assert {k: v for k, v in sc.LAUNCHES.items() if v} == {
        f"wsegsum_{mode}": 1, f"wsegsum_{mode}_bwd": 3, f"sddmm_{mode}": 1,
        f"sddmm_{mode}_bwd": 1}
    want = run("cpu", torch.float64)
    deg = max(int((p[1:] - p[:-1]).max()) for p in (plans["cpu"][2],
                                                    plans["cpu"][4]))
    scale = 1e-5 * math.sqrt(max(deg, 64)) * 16.0
    for name, a, b in zip(("out", "dx_w", "dw", "s", "dx_s", "dy"), got,
                          want):
        # bf16 tables: the plain version rounds the same tables to bf16,
        # so the f32 tolerance holds
        torch.testing.assert_close(a.cpu().double(), b.detach().double(),
                                   rtol=1e-5, atol=scale, msg=name)


# -- K3 and K4 -------------------------------------------------------------------

def _sharded(n_tgt, n_src, n_edges, shard_rows, seed, skew=True):
    """A padded target-sorted COO with an unused source range (an empty
    shard) and a hot row of a third of the edges, as its K1 plan and its
    sharded plan (CPU)."""
    rng = np.random.default_rng(seed)
    tgt = np.sort(rng.integers(0, n_tgt, n_edges))
    if skew:
        tgt[: n_edges // 3] = n_tgt // 2
        tgt = np.sort(tgt)
    # sources drawn uniformly outside [shard_rows, 2 * shard_rows)
    src = rng.integers(0, n_src - shard_rows, n_edges)
    src = np.where(src >= shard_rows, src + shard_rows, src)
    src = np.concatenate([src, np.zeros(11, np.int64)]).astype(np.int32)
    tgt = np.concatenate([tgt, np.full(11, n_tgt)]).astype(np.int32)
    local, ptr_ss = sc.plan_src_sharded(src, tgt, n_tgt, n_src, shard_rows)
    return (torch.from_numpy(src), torch.from_numpy(sc.csr_row_ptr(tgt,
                                                                   n_tgt)),
            torch.from_numpy(local), torch.from_numpy(ptr_ss))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("shard_rows", [256, 333])
def test_src_sharded_kernel_matches_plain(dev, exact, folded, shard_rows):
    """K3 (with K4 when folded and shard_rows is even) against the plain
    sharded version summed in f64, one launch per shard under the mode's
    name; bit-equal with and without the fold."""
    src, ptr, local, ptr_ss = _sharded(1200, 1000, 30_000, shard_rows,
                                       seed=shard_rows)
    x = torch.randn((1000, 64), generator=torch.Generator().manual_seed(3))
    want = sc.spmm_apply_src_sharded_plain(x.double(), local, ptr_ss,
                                           shard_rows, exact)
    before = dict(sc.LAUNCHES)
    got = sc.spmm_apply_src_sharded(x.to(dev), local.to(dev),
                                    ptr_ss.to(dev), shard_rows, exact,
                                    folded)
    torch.cuda.synchronize()
    mode = "f32" if exact else "bf16"
    name = f"segsum_{'fold_' if folded and shard_rows % 2 == 0 else ''}" \
        f"acc_{mode}"
    n_shards = ptr_ss.shape[0]
    assert sc.LAUNCHES[name] == before[name] + n_shards
    assert sc.LAUNCHES[f"segsum_{mode}"] == before[f"segsum_{mode}"]
    torch.testing.assert_close(got.cpu().double(), want, **_tol(ptr, x))
    other = sc.spmm_apply_src_sharded(x.to(dev), local.to(dev),
                                      ptr_ss.to(dev), shard_rows, exact,
                                      not folded)
    assert torch.equal(got, other)


@pytest.mark.parametrize("exact", [True, False])
def test_folded_kernel_is_bit_equal_to_unfolded(dev, exact):
    """K4 gives K1's bits; an odd row count runs (and counts) K1."""
    src, ptr, _, _ = _sharded(900, 700, 25_000, 128, seed=1)
    x = torch.randn((700, 64), generator=torch.Generator().manual_seed(4))
    mode = "f32" if exact else "bf16"
    before = dict(sc.LAUNCHES)
    fold = sc.spmm_apply(x.to(dev), src.to(dev), ptr.to(dev), exact,
                         folded=True)
    plain = sc.spmm_apply(x.to(dev), src.to(dev), ptr.to(dev), exact)
    torch.cuda.synchronize()
    assert torch.equal(fold, plain)
    assert sc.LAUNCHES[f"segsum_fold_{mode}"] == \
        before[f"segsum_fold_{mode}"] + 1
    torch.testing.assert_close(
        fold.cpu().double(), sc.spmm_apply_plain(x.double(), src, ptr,
                                                 exact), **_tol(ptr, x))
    odd = torch.cat([x, x[:1]]).to(dev)                 # 701 rows
    before = dict(sc.LAUNCHES)
    sc.spmm_apply(odd, src.to(dev), ptr.to(dev), exact, folded=True)
    assert sc.LAUNCHES[f"segsum_{mode}"] == before[f"segsum_{mode}"] + 1
    assert sc.LAUNCHES[f"segsum_fold_{mode}"] == \
        before[f"segsum_fold_{mode}"]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("folded", [False, True])
def test_sliced_kernel_matches_plain(dev, exact, folded):
    src, ptr, _, _ = _sharded(1000, 800, 20_000, 100, seed=2)
    x = torch.randn((800, 64), generator=torch.Generator().manual_seed(5))
    mode = "f32" if exact else "bf16"
    name = f"segsum_{'fold_' if folded else ''}acc_{mode}"
    before = dict(sc.LAUNCHES)
    got = sc.spmm_apply(x.to(dev), src.to(dev), ptr.to(dev), exact,
                        num_slices=3, folded=folded)
    torch.cuda.synchronize()
    assert sc.LAUNCHES[name] == before[name] + 3
    want = sc.spmm_apply_sliced_plain(x.double(), src, ptr, 3, exact)
    torch.testing.assert_close(got.cpu().double(), want, **_tol(ptr, x))


def test_accumulate_leaves_rows_without_edges(dev):
    """K3 adds each row's sum once and does not touch rows without edges
    (zero_init): a prefilled output keeps those rows' values bit for
    bit."""
    src, ptr, _, _ = _sharded(500, 300, 3_000, 100, seed=6, skew=False)
    deg = (ptr[1:] - ptr[:-1])
    ptr = ptr.clone()
    ptr[1:] = torch.cumsum(torch.where(torch.arange(500) % 3 == 0, 0, deg),
                           0).to(torch.int32)
    x = torch.randn((300, 64), generator=torch.Generator().manual_seed(7))
    base = torch.randn((500, 64), generator=torch.Generator().manual_seed(8))
    out = base.to(dev).clone()
    sc._launch_segsum(x.to(dev).contiguous(), src.to(dev), ptr.to(dev), out,
                      True, False, accumulate=True)
    torch.cuda.synchronize()
    empty = (ptr[1:] == ptr[:-1])
    assert bool(empty[::3].all())
    assert torch.equal(out.cpu()[empty], base[empty])
    want = base.double() + sc.spmm_apply_plain(x.double(), src, ptr)
    torch.testing.assert_close(out.cpu().double(), want, **_tol(ptr, x))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("folded", [False, True])
def test_src_sharded_backward_matches_plain(dev, exact, folded):
    """dx of `spmm_src_sharded` (K3 per shard of the transpose direction's
    sharded plan) against the plain transpose sum in f64."""
    g = _bipartite("cpu", 600, 800, 20_000, seed=9)
    shard_rows = 128
    plans = {}
    for side, n_t, n_s in (("u", 600, 800), ("i", 800, 600)):
        src, tgt = g[f"{side}_src"].numpy(), g[f"{side}_tgt"].numpy()
        plans[side] = [torch.from_numpy(a).to(dev) for a in
                       sc.plan_src_sharded(src, tgt, n_t, n_s, shard_rows)]
    gen = torch.Generator().manual_seed(10)
    x = torch.randn((800, 64), generator=gen).to(dev).requires_grad_()
    cot = torch.randn((600, 64), generator=gen)
    out = sc.spmm_src_sharded(x, *plans["u"], *plans["i"], shard_rows,
                              exact, folded)
    mode = "f32" if exact else "bf16"
    name = f"segsum_{'fold_' if folded else ''}acc_{mode}_bwd"
    before = dict(sc.LAUNCHES)
    dx, = torch.autograd.grad(out, x, cot.to(dev))
    torch.cuda.synchronize()
    assert sc.LAUNCHES[name] == before[name] + plans["i"][1].shape[0]
    want = sc.spmm_apply_plain(cot.double(), g["i_src"], g["i_ptr"], exact)
    torch.testing.assert_close(dx.cpu().double(), want,
                               **_tol(g["i_ptr"], cot))


# -- K6 ----------------------------------------------------------------------------

def _ring_case(case, n_tgt=1500, n_src=1200, n_edges=40_000, seed=12):
    """Both directions of one bipartite graph: (src, tgt, w) target-sorted
    and its transpose, for a K6 case. "empty_bucket": no source in the
    third of four source shards, so every bucket (p, 2) is empty;
    "hot_row": 10,000 edges into one target, their sources spread over all
    four source shards; "weighted": positive weights, the same value for
    an edge in both directions (symmetric, as sym_sqrt's)."""
    from sagnn_tpu_torch.parallel.edge_partition import _round_up
    rng = np.random.default_rng(seed)
    tgt = rng.integers(0, n_tgt, n_edges)
    if case == "hot_row":
        tgt[:10_000] = n_tgt // 2
    src = rng.integers(0, n_src, n_edges)
    if case == "empty_bucket":
        srows = _round_up(-(-n_src // 4), 8)
        third = (src >= 2 * srows) & (src < 3 * srows)
        src = np.where(third, src - srows, src)
    w = (rng.random(n_edges) + 0.25).astype(np.float32) \
        if case == "weighted" else None
    o = np.argsort(tgt, kind="stable")
    tgt, src = tgt[o].astype(np.int32), src[o].astype(np.int32)
    w = None if w is None else w[o]
    t = np.argsort(src, kind="stable")
    return (src, tgt, w), (tgt[t], src[t], None if w is None else w[t])


def _ring_plans(fwd, bwd, n_tgt, n_src, mesh):
    from sagnn_tpu_torch.parallel import edge_partition as ep
    plans = []
    for (s, t, w), nt, ns in ((fwd, n_tgt, n_src), (bwd, n_src, n_tgt)):
        parts = ep.partition_edges_ring(s, t, ns, nt, 4, weights=w)
        plans.append(ep.ring_plan(
            parts.src_local[None], parts.tgt_local[None],
            parts.rows_per_shard, parts.src_rows_per_shard, mesh,
            None if w is None else parts.weights[None]))
    return plans


def _plain_whole(x, s, t, w, n_tgt):
    """The hop's unsharded plain sum in f64 (K1's or K2's plain version),
    and its row pointers."""
    ptr = torch.from_numpy(sc.csr_row_ptr(t, n_tgt))
    src = torch.from_numpy(s)
    if w is None:
        return sc.spmm_apply_plain(x.double(), src, ptr), ptr
    return sc.spmm_weighted_apply_plain(x.double(), torch.from_numpy(w),
                                        src, ptr), ptr


@pytest.mark.parametrize("case", ["unweighted", "weighted", "empty_bucket",
                                  "hot_row"])
def test_ring_kernel_and_backward_match_plain(dev, case):
    """K6 over a one-card mesh of four ranks (all `dev`): the ring hop
    against the hop's unsharded plain sum in f64, P·P launches under its
    name and none of K1's; its backward (the ring on the transpose plan)
    against the plain transpose sum in f64; pad rows zero."""
    from sagnn_tpu_torch.parallel import edge_partition as ep
    from sagnn_tpu_torch.parallel.mesh import make_mesh

    n_tgt, n_src = 1500, 1200
    fwd, bwd = _ring_case(case, n_tgt, n_src)
    mesh = make_mesh(model=4, devices=[dev] * 4)
    fplan, bplan = _ring_plans(fwd, bwd, n_tgt, n_src, mesh)
    if case == "empty_bucket":
        assert all(int(fplan.ptr[p][0, 2, -1]) == 0 for p in range(4))
    gen = torch.Generator().manual_seed(13)
    x = torch.randn((n_src, 64), generator=gen)
    cot = torch.randn((n_tgt, 64), generator=gen)
    name = "ring_segsum_f32" if fwd[2] is None else "ring_wsegsum_f32"
    blocks = [b.requires_grad_() for b in
              ep.shard(x.to(dev), fplan.src_rows, mesh)]
    before = dict(sc.LAUNCHES)
    out = ep.ring_spmm(blocks, fplan, bplan, 0, mesh)
    torch.cuda.synchronize()
    assert sc.LAUNCHES[name] == before[name] + 16
    assert sc.LAUNCHES["segsum_f32"] == before["segsum_f32"]
    got = torch.cat([o.detach() for o in out]).cpu()
    want, ptr = _plain_whole(x, *fwd, n_tgt)
    wmax = 1.0 if fwd[2] is None else float(np.abs(fwd[2]).max())
    torch.testing.assert_close(got[:n_tgt].double(), want,
                               **_tol(ptr, x * wmax))
    assert not got[n_tgt:].any()
    before = dict(sc.LAUNCHES)
    dx = torch.autograd.grad(out, blocks,
                             ep.shard(cot.to(dev), fplan.rows, mesh))
    torch.cuda.synchronize()
    assert sc.LAUNCHES[name + "_bwd"] == before[name + "_bwd"] + 16
    got_dx = torch.cat(dx).cpu()
    want_dx, bptr = _plain_whole(cot, *bwd, n_src)
    torch.testing.assert_close(got_dx[:n_src].double(), want_dx,
                               **_tol(bptr, cot * wmax))
    assert not got_dx[n_src:].any()


def test_ring_encode_matches_pallas_on_card(dev):
    """The gowalla preset's encode on the ring (a one-card mesh of four
    ranks, 192 K6 launches, no K1) and on "pallas" (K1), each held against
    the f64 encode on the CPU."""
    import dataclasses

    from sagnn_tpu_torch.config import PRESETS
    from sagnn_tpu_torch.data.graph import compile_interval_graphs
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.models.selfgnn import SelfGNN
    from sagnn_tpu_torch.parallel.edge_partition import ring_graphs
    from sagnn_tpu_torch.parallel.mesh import make_mesh
    from sagnn_tpu_torch.serve import Recommender

    base = PRESETS["gowalla"]
    cfg = base.replace(
        model=dataclasses.replace(base.model, spmm_backend="pallas"),
        train=dataclasses.replace(base.train, test_size=30, seed=1))
    bundle = synthetic_dataset(num_users=70, num_items=90, graph_num=3,
                               test_size=30, seed=2)
    cpu = Recommender(cfg, bundle, device="cpu")
    gpu = Recommender(cfg, bundle, cpu.params, device=dev)
    mesh = make_mesh(model=4, devices=[dev] * 4)
    ring = SelfGNN(dataclasses.replace(cfg.model, spmm_backend="ring"), 70,
                   90, mesh=mesh)
    graphs = {"ring": ring_graphs(compile_interval_graphs(bundle.sub_mats),
                                  mesh)}
    sc.reset_launches()
    got = ring.encode(gpu.params, graphs)[:2]
    torch.cuda.synchronize()
    assert {k: v for k, v in sc.LAUNCHES.items() if v} == \
        {"ring_segsum_f32": 192}
    _check_against_f64({"cpu": cpu.encode(), "card": gpu.encode(),
                        "ring": got}, _f64_encode(cpu))


# -- the probes ---------------------------------------------------------------

@pytest.mark.parametrize("in_flight", [1, 2, 4, 8])
@pytest.mark.parametrize("run", [1, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_probe_matches_plain(dev, dtype, run, in_flight):
    """P1 against its plain version summed in f64, atol = f32 eps x rows x
    max|x|; an id count that is not a multiple of 32 leaves a ragged last
    group; d = 48 leaves lanes idle."""
    from sagnn_tpu_torch.ops import probes
    for d, fetched in ((64, 40_000), (48, 4_096 + 96)):
        x = torch.randn((5_000, d), generator=torch.Generator()
                        .manual_seed(run)).to(dtype)
        src = torch.from_numpy(probes.probe_ids(5_000, fetched, run,
                                                chunk=512, seed=in_flight))
        want = probes.gather_sum_plain(x.double(), src, run)
        before = dict(probes.LAUNCHES)
        got = probes.gather_sum(x.to(dev), src.to(dev), run, in_flight)
        torch.cuda.synchronize()
        name = "gather_sum_" + ("f32" if dtype == torch.float32 else "bf16")
        assert probes.LAUNCHES[name] == before[name] + 1
        assert got.shape == (d,) and got.dtype == torch.float32
        atol = F32_EPS * src.numel() * run * float(x.float().abs().max())
        torch.testing.assert_close(got.cpu().double(), want, rtol=0,
                                   atol=atol)


def test_gather_probe_is_deterministic_and_handles_no_ids(dev):
    from sagnn_tpu_torch.ops import probes
    x = torch.randn((3_000, 64), device=dev)
    src = torch.from_numpy(probes.probe_ids(3_000, 50_000, 1)).to(dev)
    assert torch.equal(probes.gather_sum(x, src), probes.gather_sum(x, src))
    none = probes.gather_sum(x, src[:0])
    torch.cuda.synchronize()
    assert none.shape == (64,) and not none.any()
    with pytest.raises(ValueError):
        probes.gather_sum(torch.randn((10, 96), device=dev), src)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("skew", [False, True])
def test_ablated_segsum_probe_matches_plain(dev, exact, skew):
    """P2 gives each row's last source row exactly (zeros for empty
    rows), on a plan with a hot row and pad slots."""
    from sagnn_tpu_torch.ops import probes
    src, ptr = _graph(1000, 700, 20_000, 37, seed=5, skew=skew)
    ptr[200:400] = ptr[200]          # a run of empty rows
    x = torch.randn((700, 64), generator=torch.Generator().manual_seed(3))
    want = probes.segsum_ablate_plain(x, src, ptr, exact)
    before = dict(probes.LAUNCHES)
    got = probes.segsum_ablate(x.to(dev), src.to(dev), ptr.to(dev), exact)
    torch.cuda.synchronize()
    name = "segsum_ablate_" + ("f32" if exact else "bf16")
    assert probes.LAUNCHES[name] == before[name] + 1
    assert torch.equal(got.cpu(), want)


# -- the balanced schedule of the segment-sum kernel ------------------------------

SCHEDULE_MODES = ["K1", "K2", "K3", "K4", "K3K4", "K6", "K6w", "P2"]
SCHEDULE_PLANS = ["one_row", "boundary", "sparse", "shard", "slice"]
SCHEDULE_SRC_ROWS = 512


def _schedule_plan(kind, seed=0):
    """(src, ptr) on the CPU, 600 target rows: "one_row", one row holds
    every edge and spans many pieces; "boundary", every row has
    PIECE_ITEMS - 1 edges, so each row's end is the last item of a piece;
    "sparse", nine rows in ten empty; "shard", a shard's plan (ptr[0] > 0,
    after another shard's edges) with pad slots after ptr[-1]; "slice",
    the middle of three slices of a skewed plan (`_slice_ptrs`: ptr[0] > 0,
    rows outside the slice empty, the later slices' edges after ptr[-1])."""
    rng = np.random.default_rng(seed)
    n_tgt = 600
    deg = np.zeros(n_tgt, np.int64)
    if kind == "one_row":
        deg[n_tgt // 3] = 20_000
    elif kind == "boundary":
        deg[:] = sc.PIECE_ITEMS - 1
    elif kind == "sparse":
        rows = rng.choice(n_tgt, n_tgt // 10, replace=False)
        np.add.at(deg, rng.choice(rows, 15_000), 1)
    else:
        np.add.at(deg, rng.integers(0, n_tgt, 15_000), 1)
        deg[n_tgt // 2] += 6000
    ptr0, pad = (4321, 333) if kind == "shard" else (0, 0)
    ptr = np.concatenate([[0], np.cumsum(deg)]) + ptr0
    src = rng.integers(0, SCHEDULE_SRC_ROWS, int(ptr[-1]) + pad)
    ptr = torch.from_numpy(ptr.astype(np.int32))
    if kind == "slice":
        ptr = sc._slice_ptrs(ptr, 3)[1]
    return torch.from_numpy(src.astype(np.int32)), ptr


def _schedule_launch(mode, exact, x, w, src, ptr, base):
    """One call of `mode` on the card's tensors: (out, its counter)."""
    from sagnn_tpu_torch.ops import probes
    mode_name = "f32" if exact else "bf16"
    if mode in ("K1", "K4"):
        fold = mode == "K4"
        out = sc.spmm_apply(x, src, ptr, exact, folded=fold)
        return out, f"segsum_{'fold_' if fold else ''}{mode_name}"
    if mode == "K2":
        return (sc.spmm_weighted_apply(x, w, src, ptr, exact),
                f"wsegsum_{mode_name}")
    if mode in ("K3", "K3K4"):
        out = base.clone()
        fold = mode == "K3K4"
        sc._launch_segsum(sc._kernel_table(x, exact), src, ptr, out, exact,
                          False, accumulate=True, folded=fold)
        return out, f"segsum_{'fold_' if fold else ''}acc_{mode_name}"
    if mode in ("K6", "K6w"):
        weights = w if mode == "K6w" else None
        out = sc.ring_bucket_accumulate(base.clone(), x, src, ptr, weights)
        return out, "ring_wsegsum_f32" if weights is not None \
            else "ring_segsum_f32"
    return probes.segsum_ablate(x, src, ptr, exact), None


def _schedule_want(mode, exact, x, w, src, ptr, base):
    """The plain version of `mode` on the CPU, summed in f64 (P2: its
    exact gather in f32)."""
    from sagnn_tpu_torch.ops import probes
    x64 = x.double()
    if mode == "P2":
        return probes.segsum_ablate_plain(x, src, ptr, exact)
    if mode in ("K2", "K6w"):
        total = sc.spmm_weighted_apply_plain(x64, w.double(), src, ptr,
                                             exact)
    else:
        total = sc.spmm_apply_plain(x64, src, ptr, exact)
    if mode in ("K3", "K3K4", "K6", "K6w"):
        total = base.double() + total
    return total


@pytest.mark.parametrize("d", [2, 16, 64, 96, 128])
@pytest.mark.parametrize("plan", SCHEDULE_PLANS)
@pytest.mark.parametrize("mode", SCHEDULE_MODES)
def test_balanced_schedule_matches_plain(dev, mode, plan, d):
    """Each mode of the segment-sum kernel, on both table types (K6: f32,
    as the ring runs), against its plain version summed in f64 at `_tol`
    (P2: exactly); one launch counted per call; a second launch gives the
    same bits; the accumulating modes (K3, K6) leave rows without edges
    untouched, bit for bit."""
    src, ptr = _schedule_plan(plan)
    gen = torch.Generator().manual_seed(d)
    x = torch.randn((SCHEDULE_SRC_ROWS, d), generator=gen)
    w = torch.rand(src.numel(), generator=gen) * 2 - 0.5
    base = torch.randn((ptr.numel() - 1, d), generator=gen)
    term = float(w.abs().max()) if mode in ("K2", "K6w") else 1.0
    empty = ptr[1:] == ptr[:-1]
    on_card = [t.to(dev) for t in (x, w, src, ptr, base)]
    for exact in (True,) if mode.startswith("K6") else (True, False):
        before = dict(sc.LAUNCHES)
        got, name = _schedule_launch(mode, exact, *on_card)
        again, _ = _schedule_launch(mode, exact, *on_card)
        torch.cuda.synchronize()
        if name is not None:
            assert sc.LAUNCHES[name] == before[name] + 2
        assert torch.equal(got, again), f"{mode} is not deterministic"
        want = _schedule_want(mode, exact, x, w, src, ptr, base)
        if mode == "P2":
            assert torch.equal(got.cpu(), want)
            continue
        torch.testing.assert_close(got.cpu().double(), want,
                                   **_tol(ptr, x * term))
        if mode in ("K3", "K3K4", "K6", "K6w"):
            assert torch.equal(got.cpu()[empty], base[empty])
        else:
            assert not got.cpu()[empty].any()


def test_balanced_schedule_leaves_its_scratch_clean(dev):
    """After launches of every mode on one plan, each mode on a second
    plan gives the bits it gives on fresh scratch, and every arrival
    counter is back at 0: a launch leaves nothing behind for the next."""
    gen = torch.Generator().manual_seed(21)
    plans = [[t.to(dev) for t in _schedule_plan(kind, seed=k)]
             for k, kind in enumerate(("one_row", "slice"))]
    x = torch.randn((SCHEDULE_SRC_ROWS, 64), generator=gen).to(dev)
    ws = [torch.rand(p[0].numel(), generator=gen).to(dev) for p in plans]
    bases = [torch.randn((p[1].numel() - 1, 64), generator=gen).to(dev)
             for p in plans]
    second = (x, ws[1], *plans[1], bases[1])
    alone = {}
    for mode in SCHEDULE_MODES:
        sc._COUNTERS.clear()
        alone[mode] = _schedule_launch(mode, True, *second)[0]
    for mode in SCHEDULE_MODES:
        _schedule_launch(mode, True, x, ws[0], *plans[0], bases[0])
        got = _schedule_launch(mode, True, *second)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, alone[mode]), mode
    for counters in sc._COUNTERS.values():
        assert not counters.any()


def test_balanced_schedule_does_not_depend_on_the_grid(dev, monkeypatch):
    """The grid's size only spreads the pieces: one block per SM on a
    one-SM card gives the bits of the full grid, in every mode."""
    src, ptr = [t.to(dev) for t in _schedule_plan("one_row", seed=4)]
    gen = torch.Generator().manual_seed(22)
    x = torch.randn((SCHEDULE_SRC_ROWS, 64), generator=gen).to(dev)
    w = torch.rand(src.numel(), generator=gen).to(dev)
    base = torch.randn((ptr.numel() - 1, 64), generator=gen).to(dev)
    full = {m: _schedule_launch(m, False if m[:2] != "K6" else True, x, w,
                                src, ptr, base)[0] for m in SCHEDULE_MODES}
    monkeypatch.setattr(sc, "_sm_count", lambda index: 1)
    assert sc.segsum_schedule(ptr.numel() - 1, src.numel(), 64,
                              1).blocks == sc.BLOCKS_PER_SM
    for m in SCHEDULE_MODES:
        got = _schedule_launch(m, False if m[:2] != "K6" else True, x, w,
                               src, ptr, base)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, full[m]), m


# -- K5 and P1 on their Hopper schedules ------------------------------------------

def _hot_row_plans(dev, side):
    """Both directions' plans of one interval in which user 3 holds 10,000
    edges (a u-plan row that crosses ~157 spans of SDDMM_SPAN slots) and
    the other rows runs of every length, with pad slots; the "i" side's
    targets hold one or two edges each. (cpu plans, card plans) as
    `test_weighted_functions_backward_match_plain` takes them."""
    import dataclasses

    import scipy.sparse as sp

    from sagnn_tpu_torch.config import ModelConfig
    from sagnn_tpu_torch.data.graph import compile_interval_graphs
    from sagnn_tpu_torch.models.selfgnn import graphs_to_device

    rng = np.random.default_rng(9)
    n_u, n_i = 500, 12_000
    rows = np.concatenate([np.full(10_000, 3), rng.integers(0, n_u, 15_000)])
    cols = np.concatenate([np.arange(10_000), rng.integers(0, n_i, 15_000)])
    m = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n_u, n_i))
    cfg = dataclasses.replace(ModelConfig(), edge_norm="mean")
    gb = compile_interval_graphs([m])
    other = "i" if side == "u" else "u"
    plans = []
    for where in ("cpu", dev):
        g = graphs_to_device(gb, where, cfg, [m])
        plans.append(tuple(g[k][0] for k in (
            f"{side}_src", f"{side}_tgt", f"{side}_ptr", f"{other}_src",
            f"{other}_ptr", f"{other}_from_{side}")))
    return plans


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("side", ["u", "i"])
def test_sddmm_hot_row_and_crossing_runs(dev, exact, side):
    """K5 on a plan with a 10,000-edge target row whose run crosses many
    spans (u) or with one- and two-edge runs (i): forward, and through
    SpmmWeightedFunction (dw) and SddmmFunction, against the CPU's plain
    versions in f64 at K5's tolerance (rtol 1e-5, atol 1e-5 x sqrt(D) x
    the largest |term|; the weighted sums' atol as `_tol`); pad slots
    score 0; a second run gives the same bits."""
    cpu, card = _hot_row_plans(dev, side)
    n_x, n_t = cpu[4].numel() - 1, cpu[2].numel() - 1
    n_edges, slots = int(cpu[2][-1]), cpu[0].numel()
    assert slots > n_edges                            # pad slots
    if side == "u":
        assert int((cpu[2][1:] - cpu[2][:-1]).max()) >= 10_000
    gen = torch.Generator().manual_seed(10)
    x = torch.randn((n_x, 64), generator=gen)
    y = torch.randn((n_t, 64), generator=gen)
    w = torch.rand(slots, generator=gen)
    g_out = torch.randn((n_t, 64), generator=gen)
    g_s = torch.randn(slots, generator=gen)

    def run(where, plans, dtype):
        xs, ws, ys = (t.to(where, dtype).requires_grad_() for t in (x, w, y))
        s0 = sc.sddmm_apply(xs.detach(), ys.detach(), plans[0], plans[1],
                            plans[2], exact)
        out = sc.spmm_weighted(xs, ws, *plans, exact)
        dw = torch.autograd.grad(out, ws, g_out.to(where, dtype))[0]
        s = sc.sddmm(xs, ys, *plans, exact)
        dx, dy = torch.autograd.grad(s, (xs, ys), g_s.to(where, dtype))
        return s0, dw, s, dx, dy

    sc.reset_launches()
    got = run(dev, card, torch.float32)
    again = run(dev, card, torch.float32)
    torch.cuda.synchronize()
    mode = "f32" if exact else "bf16"
    assert sc.LAUNCHES[f"sddmm_{mode}"] == 4
    assert sc.LAUNCHES[f"sddmm_{mode}_bwd"] == 2
    for name, a, b in zip(("s0", "dw", "s", "dx", "dy"), got, again):
        assert torch.equal(a, b), f"{name}: two runs, different bits"
    want = run("cpu", cpu, torch.float64)
    atol5 = 1e-5 * 8.0 * float(x.abs().max()) * max(float(y.abs().max()),
                                                    float(g_out.abs().max()))
    for name, a, b in zip(("s0", "dw", "s"), got, want):
        torch.testing.assert_close(a.cpu().double(), b.detach().double(),
                                   rtol=1e-5, atol=atol5, msg=name)
        assert not a[n_edges:].any(), f"{name}: pad slots score 0"
    for name, a, b, tbl, p in (("dx", got[3], want[3], y, cpu[4]),
                               ("dy", got[4], want[4], x, cpu[2])):
        torch.testing.assert_close(
            a.cpu().double(), b.detach().double(),
            **_tol(p, tbl * float(g_s.abs().max())), msg=name)


@pytest.mark.parametrize("d", [2, 16, 64, 96, 130])
def test_sddmm_bf16_rounds_f32_tables_in_registers(dev, d):
    """bf16 mode on f32 tables (rounded as the kernel reads them) gives the
    bits it gives on the same tables cast to bf16 beforehand (which the
    wrapper widens back to f32, exactly), either or both: the kernel's
    rounding is `.to(torch.bfloat16)`'s."""
    src, ptr = _graph(1000, 700, 20_003, 41, seed=d, skew=True)
    tgt = torch.repeat_interleave(torch.arange(1000),
                                  (ptr[1:] - ptr[:-1]).long())
    tgt = torch.cat([tgt, torch.full((41,), 1000)]).to(torch.int32)
    gen = torch.Generator().manual_seed(d)
    x = torch.randn((700, d), generator=gen).to(dev)
    y = torch.randn((1000, d), generator=gen).to(dev)
    plan = [t.to(dev) for t in (src, tgt, ptr)]
    bx, by = x.to(torch.bfloat16), y.to(torch.bfloat16)
    rounded = sc.sddmm_apply(x, y, *plan, exact=False)
    for xt, yt in ((bx, by), (bx, y), (x, by)):
        assert torch.equal(sc.sddmm_apply(xt, yt, *plan, exact=False),
                           rounded)


def test_sddmm_does_not_depend_on_the_grid(dev, monkeypatch):
    """The grid only spreads the spans: on a one-SM card (at most
    SDDMM_BLOCKS_PER_SM blocks) K5 gives the full grid's bits."""
    src, ptr = _graph(1000, 700, 60_000, 41, seed=3, skew=True)
    tgt = torch.repeat_interleave(torch.arange(1000),
                                  (ptr[1:] - ptr[:-1]).long())
    tgt = torch.cat([tgt, torch.full((41,), 1000)]).to(torch.int32)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((700, 64), generator=gen).to(dev)
    y = torch.randn((1000, 64), generator=gen).to(dev)
    plan = [t.to(dev) for t in (src, tgt, ptr)]
    full = [sc.sddmm_apply(x, y, *plan, exact) for exact in (True, False)]
    monkeypatch.setattr(sc, "_sm_count", lambda index: 1)
    assert sc.sddmm_schedule(src.numel(), 64, 1).blocks == \
        sc.SDDMM_BLOCKS_PER_SM
    for exact, want in zip((True, False), full):
        assert torch.equal(sc.sddmm_apply(x, y, *plan, exact), want)


def _cuda_kernels(fn) -> int:
    """The CUDA kernels one call of fn launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.lower().startswith(("memset", "memcpy")))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_probe_is_one_kernel_and_grid_free(dev, monkeypatch, dtype):
    """P1 makes one CUDA kernel per call (the last block to finish sums the
    chunks' partials) and gives the same bits on the full grid and on a
    one-SM card's, in each run mode."""
    from sagnn_tpu_torch.ops import probes
    x = torch.randn((20_000, 64), generator=torch.Generator()
                    .manual_seed(11)).to(dtype).to(dev)
    ids = {run: torch.from_numpy(probes.probe_ids(20_000, 300_000, run)
                                 ).to(dev) for run in probes.RUNS}
    full = {run: probes.gather_sum(x, ids[run], run) for run in probes.RUNS}
    assert _cuda_kernels(lambda: probes.gather_sum(x, ids[1], 1)) == 1
    monkeypatch.setattr(sc, "_sm_count", lambda index: 1)
    assert probes.gather_schedule(300_000, 1, 64, 1).blocks == \
        probes.P1_BLOCKS_PER_SM
    for run in probes.RUNS:
        assert torch.equal(probes.gather_sum(x, ids[run], run), full[run])


@pytest.mark.parametrize("exact", [True, False])
def test_sddmm_is_one_kernel_per_call(dev, exact):
    """K5 on f32 tables makes one CUDA kernel per call in both modes: bf16
    mode rounds the tables as it reads them and casts nothing first."""
    src, ptr = _graph(1000, 700, 20_000, 41, seed=12)
    tgt = torch.repeat_interleave(torch.arange(1000),
                                  (ptr[1:] - ptr[:-1]).long())
    tgt = torch.cat([tgt, torch.full((41,), 1000)]).to(torch.int32)
    x = torch.randn((700, 64), device=dev)
    y = torch.randn((1000, 64), device=dev)
    plan = [t.to(dev) for t in (src, tgt, ptr)]
    assert _cuda_kernels(lambda: sc.sddmm_apply(x, y, *plan, exact)) == 1


# -- the bf16 throughput mode, per-token attention, the bf16 top-k --------

def _bf16_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of max |want| (one ulp:
    2^(floor(log2 max|want|) - 7))."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    ulp = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
    return float((got - want).abs().max()) / ulp


def _small_recommenders(dev, **model):
    import dataclasses

    from sagnn_tpu_torch.config import PRESETS
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.serve import Recommender

    base = PRESETS["gowalla"]
    cfg = base.replace(
        model=dataclasses.replace(base.model, spmm_backend="pallas",
                                  **model),
        train=dataclasses.replace(base.train, test_size=30, seed=1))
    bundle = synthetic_dataset(num_users=70, num_items=90, graph_num=3,
                               test_size=30, seed=2)
    cpu = Recommender(cfg, bundle, device="cpu")
    return cpu, Recommender(cfg, bundle, cpu.params, device=dev)


def test_layer_norm_bf16_on_card_matches_cpu(dev):
    """PyTorch's bf16 reductions on the card accumulate in f32 and round
    once (as jnp's do, and as the CPU's do, tests/test_torch_bf16.py): the
    layer norm's mean and variance, the fusion stack's mean and the
    sequence branch's sum. The card's f32 sums run in another order, so
    the norm may differ from the CPU's by an ulp."""
    from sagnn_tpu_torch.ops.attention import layer_norm

    gen = torch.Generator().manual_seed(4)
    x = (torch.randn((4096, 3, 64), generator=gen) * 2 + 0.5).bfloat16()
    sc_, sh = torch.randn((2, 64), generator=gen).bfloat16()
    cpu = layer_norm(x, sc_, sh)
    card = layer_norm(x.to(dev), sc_.to(dev), sh.to(dev))
    assert card.dtype == torch.bfloat16
    assert _bf16_ulps(card, cpu) <= 1.0
    xd = x.to(dev)
    native = (torch.mean(xd, dim=(1, 2)),
              torch.var(xd, dim=(1, 2), unbiased=False),
              torch.mean(xd, dim=1), torch.sum(xd, dim=1))
    explicit = (xd.float().mean(dim=(1, 2)).bfloat16(),
                xd.float().var(dim=(1, 2), unbiased=False).bfloat16(),
                xd.float().mean(dim=1).bfloat16(),
                xd.float().sum(dim=1).bfloat16())
    print(f"layer norm card vs cpu {int((card.cpu() != cpu).sum())} of "
          f"{cpu.numel()} elements differ")
    for a, b in zip(native, explicit):
        assert torch.equal(a, b)


def test_bf16_encode_on_card_matches_cpu(dev):
    """--bf16's model (bf16 table, bf16 fusion, stable softmax): 12
    segsum_bf16 launches, the card's encode within 2 bf16 ulps of the
    largest |value| of the CPU's, finite, and repeatable bit for bit."""
    cpu, gpu = _small_recommenders(dev, spmm_exact=False,
                                   fusion_dtype="bf16", stable_softmax=True)
    sc.reset_launches()
    card = gpu.encode()
    torch.cuda.synchronize()
    assert {k: v for k, v in sc.LAUNCHES.items() if v} == {"segsum_bf16": 12}
    want = cpu.encode()
    for c, w in zip(card, want):
        assert c.dtype == torch.float32 and bool(torch.isfinite(c).all())
        ulps = _bf16_ulps(c, w)
        print(f"bf16 encode card vs cpu: {ulps:.2f} ulps of max")
        assert ulps <= 2.0
    again = gpu.encode()
    assert all(torch.equal(a, b) for a, b in zip(card, again))


@pytest.mark.parametrize("fusion_dtype", ["f32", "bf16"])
def test_per_token_scores_on_card_match_cpu(dev, fusion_dtype):
    """per_token_seq_attention (pos_length 200, 16 heads) scores of every
    item for 20 users, some with padded sequences: f32 within rtol 1e-4,
    atol 1e-5 x max|score| of the CPU's; bf16 within 2 bf16 ulps."""
    from sagnn_tpu_torch.data.sampler import user_sequences

    cpu, gpu = _small_recommenders(dev, per_token_seq_attention=True,
                                   fusion_dtype=fusion_dtype)
    users = np.arange(20)
    seq, mask = user_sequences(cpu.bundle, users, 200)
    assert (mask == 0).any() and (mask.sum(1) > 0).all()
    out = []
    for rec in (cpu, gpu):
        fu, fi = rec.encode()
        out.append(rec.model.score_all_items(
            rec.params, fu, fi, *(torch.from_numpy(a).to(rec.device)
                                  for a in (users, seq, mask))))
    want, got = out[0], out[1].cpu()
    assert bool(torch.isfinite(got).all())
    if fusion_dtype == "f32":
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale)
    else:
        assert _bf16_ulps(got, want) <= 2.0


def bf16_stream_error(q, table, ids):
    """A bound on |bf16 stream score - exact score| of items `ids` [B, k]
    for queries q [B, D]: rounding q and a row to bf16 (2^-9 relative
    each) moves each product q_i t_i by at most (2^-8 + 2^-18)|q_i t_i|,
    the f32 sum adds less than 2^-18 of sum |q_i t_i| at D = 64, and the
    score rounds to bf16 (2^-9 relative): 2^-8 (1.01 sum |q_i t_i| + |s|)
    bounds it. An item is chosen over a missing top-k item only where its
    stream score is at least that item's, so each returned item's exact
    score is at least the exact k-th less its bound and the largest of
    the exact top k's."""
    rows = table[ids].double()
    qd = q.double()[:, None, :]
    return 2.0 ** -8 * (1.01 * (qd.abs() * rows.abs()).sum(-1)
                        + (qd * rows).sum(-1).abs())


def test_chunked_topk_bf16_on_card(dev):
    """The bf16 stream on the card: the returned scores are the f32
    scores of the returned ids, each within the stream's rounding bound
    of the exact k-th (`bf16_stream_error`), and the CPU's selection
    wherever the stream's k-th and (k+1)-th scores differ on both
    devices."""
    from sagnn_tpu_torch.models.selfgnn import chunked_topk

    gen = torch.Generator().manual_seed(6)
    q = torch.randn((64, 64), generator=gen)
    tbl = torch.randn((50_000, 64), generator=gen)
    k = 10
    got_v, got_i = chunked_topk(q.to(dev), tbl.to(dev), 50_000, k, 8192,
                                score_dtype=torch.bfloat16)
    cpu_v, cpu_i = chunked_topk(q, tbl, 50_000, k, 8192,
                                score_dtype=torch.bfloat16)
    got_v, got_i = got_v.cpu(), got_i.cpu()
    dense = q.double() @ tbl.double().T
    torch.testing.assert_close(torch.gather(dense, 1, got_i),
                               got_v.double(), rtol=1e-6, atol=0)
    exact_v, exact_i = torch.topk(dense, k)
    slack = (bf16_stream_error(q, tbl, got_i)
             + bf16_stream_error(q, tbl, exact_i).max(1, keepdim=True).values)
    assert bool((got_v.double() >= exact_v[:, -1:] - slack).all())
    determined = torch.ones(64, dtype=torch.bool)
    for d in ("cpu", dev):
        qb, tb = q.to(d).bfloat16(), tbl.to(d).bfloat16()
        stream = torch.topk((qb @ tb.T).float(), k + 1).values.cpu()
        determined &= stream[:, k - 1] > stream[:, k]
    assert int(determined.sum()) >= 16
    for b in torch.nonzero(determined).flatten().tolist():
        assert set(got_i[b].tolist()) == set(cpu_i[b].tolist()), b


# -- the supervisor sees a hung CUDA call (C1) ------------------------------------

HUNG_CHILD = """
import sys, time, torch
from sagnn_tpu_torch.device import set_blocking_sync
mode, secs, mark = sys.argv[1], float(sys.argv[2]), sys.argv[3]
set_blocking_sync()
torch.ones(1, device="cuda").sum().item()
if mode == "after":
    print("Start", flush=True)
with open(mark, "w") as f:          # the hang starts; not a log line
    f.write(repr(time.time()))
torch.cuda._sleep(int(secs * 2e9))  # at least secs at <= 2 GHz
torch.cuda.synchronize()
print("done", flush=True)
"""


@pytest.mark.parametrize("mode", ["before", "after"])
def test_supervisor_declares_a_hung_cuda_call(dev, tmp_path, mode):
    """A supervised child with blocking sync (what `main --supervise` sets
    on the card) that waits on a device op past wedge_secs is declared a
    WEDGE by the no-log, no-CPU criterion within wedge_secs + 2 polls of
    the hang, before and after its first log line."""
    import os
    import sys
    import threading
    import time

    from sagnn_tpu_torch.train.supervisor import Supervisor

    wedge, poll = 6.0, 1.0
    script, mark = tmp_path / "child.py", tmp_path / "hang_started"
    script.write_text(HUNG_CHILD)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    sup = Supervisor(argv=[sys.executable, str(script), mode,
                           str(4 * wedge), str(mark)],
                     log_path=str(tmp_path / "train.log"), check_every=poll,
                     wedge_secs=wedge, cpu_eps=0.5, startup_grace=wedge,
                     relay_probe=None, env=env)
    declared = []

    def recover(child, crashed):
        declared.append(time.time())
        child.kill()
        child.wait()
        return False

    sup._recover = recover
    th = threading.Thread(target=lambda: sup.run(), daemon=True)
    th.start()
    th.join(60.0)
    assert not th.is_alive(), "no wedge declared within 60 s"
    assert declared and not crashed_events(sup)
    hang = float(mark.read_text())
    reason = [e for e in sup.events if "WEDGE" in e][0]
    assert "no log output" in reason, reason
    assert declared[0] - hang <= wedge + 2 * poll, (declared[0] - hang,
                                                    sup.events)


def crashed_events(sup):
    return [e for e in sup.events if "crashed" in e or "exited" in e]


# -- training on a one-card mesh (A6(a), A6(b)) --------------------------------

def _mesh_cfg(keep_rate=1.0):
    from sagnn_tpu_torch import config as tcfg
    return tcfg.Config(
        model=tcfg.ModelConfig(graph_num=2, gnn_layer=1, att_layer=1,
                               latdim=16, num_heads=4, ssldim=8,
                               pos_length=16, keep_rate=keep_rate,
                               spmm_backend="pallas"),
        train=tcfg.TrainConfig(batch=16, samp_num=4, ssl_num=2, trn_num=32,
                               test_size=10, lr=5e-3))


@pytest.mark.parametrize("keep_rate", [1.0, 0.5])
def test_mesh_step_on_card_matches_single_device(dev, tmp_path, keep_rate):
    """A 2 x 2 mesh with every rank on the card: one step's losses (rtol
    1e-5) and every gradient (atol 1e-5 x max|g|) against the
    single-device "pallas" step on the same batch and generator state;
    K1 runs once per hop on each (data, model) rank, forward and
    backward."""
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.models.selfgnn import reg_loss
    from sagnn_tpu_torch.parallel.mesh import make_mesh
    from sagnn_tpu_torch.parallel.sharding import gather
    from sagnn_tpu_torch.train.trainer import Trainer

    cfg = _mesh_cfg(keep_rate)
    bundle = synthetic_dataset(num_users=48, num_items=64, graph_num=2,
                               test_size=10, seed=2)
    one = Trainer(cfg, bundle, ckpt_root=str(tmp_path / "a"), device=dev)
    tr = Trainer(cfg, bundle, ckpt_root=str(tmp_path / "b"),
                 mesh=make_mesh(data=2, model=2, devices=[dev] * 4))
    batch = one.sampler.train_batch(one.sampler.epoch_user_ids(32)[:16])
    gen_state = one.dropout_gen.get_state()
    sc.reset_launches()
    totals, grads = tr._mesh_step.loss_and_grads(tr.mesh_state, batch,
                                                 tr.dropout_gen)
    torch.cuda.synchronize()
    hops = 2 * 1 * 2
    assert sc.LAUNCHES["segsum_f32"] == hops * 4
    assert sc.LAUNCHES["segsum_f32_bwd"] == hops * 4
    one.dropout_gen.set_state(gen_state)
    params = one.state["params"]
    pre, ssl, _ = one.model.train_losses(params, one.graphs, batch.to(dev),
                                         one.dropout_gen)
    loss = pre + cfg.train.reg * reg_loss(params) + cfg.train.ssl_reg * ssl
    keys = list(params)
    want = dict(zip(keys, torch.autograd.grad(loss,
                                              [params[k] for k in keys])))
    torch.testing.assert_close(totals["loss"], loss.detach(), rtol=1e-5,
                               atol=0.0)
    torch.testing.assert_close(totals["preLoss"], pre.detach(), rtol=1e-5,
                               atol=0.0)
    scale = max(float(g.abs().max()) for g in want.values())
    specs = tr.mesh_state.specs
    for k, g in want.items():
        got = gather(grads[k], specs[k], dev)
        torch.testing.assert_close(got, g, rtol=0.0, atol=1e-5 * scale,
                                   msg=k)


def test_two_processes_share_the_card_over_gloo(dev, tmp_path):
    """`parallel.multihost --mode train --procs 2 --device cuda`: two
    processes on cuda:0, gloo carrying the card's tensors through host
    buffers, against one process on a 2 x 1 mesh: the losses at rtol 1e-5,
    the metrics within one user's rank (the card's backward of the row
    gathers sums with atomics, so two runs' weights agree to rounding
    only and a near-tie can move one rank); then the ring over two
    processes passes its checksum."""
    import json
    import os
    import subprocess
    import sys

    from sagnn_tpu_torch.parallel.mesh import make_mesh
    from sagnn_tpu_torch.parallel.multihost import (load_bundle, parse_args,
                                                    train_config)
    from sagnn_tpu_torch.train.trainer import Trainer

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(*args):
        out = subprocess.run(
            [sys.executable, "-m", "sagnn_tpu_torch.parallel.multihost",
             "--device", "cuda", "--timeout", "150", *map(str, args)],
            capture_output=True, timeout=180, cwd=root)
        assert out.returncode == 0, out.stderr.decode()[-3000:]
        return json.loads([ln for ln in out.stdout.decode().splitlines()
                           if ln.startswith("{")][-1])

    res = run("--mode", "train", "--procs", 2, "--spmm_backend", "pallas")
    assert res["launches"]["segsum_f32"] > 0
    args = parse_args(["--mode", "train", "--spmm_backend", "pallas"])
    bundle = load_bundle(args)
    tr = Trainer(train_config(args), bundle, ckpt_root=str(tmp_path),
                 mesh=make_mesh(data=2, model=1, devices=[dev] * 2))
    ref = tr.train_epoch(verbose=False)
    mets = tr.test_epoch()
    fs = tr.test_epoch(full_sort=True)
    for key, want in (("Loss", ref["Loss"]), ("preLoss", ref["preLoss"])):
        np.testing.assert_allclose(res[key], want, rtol=1e-5, err_msg=key)
    one_user = (1.0 + 1e-4) / len(bundle.tst_usrs)
    for key, want in (("NDCG", mets["NDCG"]), ("fs_NDCG", fs["NDCG"])):
        np.testing.assert_allclose(res[key], want, rtol=0, atol=one_user,
                                   err_msg=key)
    ring = run("--mode", "ring", "--procs", 2, "--edges", 60000, "--users",
               4000, "--items", 3000, "--iters", 1)
    assert ring["checksum_ok"] is True
    assert ring["launches"]["ring_segsum_f32"] == 2


# -- the tensor-parallel K3 and K5 hops, ring attention (A6(d), A6(e)) ---------

def _tp_env(dev):
    """The 48 x 64 bundle's graphs on the card with the attention
    attachments (and 16-row source shards), cut over 3 model ranks, all
    on the card."""
    import dataclasses

    from sagnn_tpu_torch.data.graph import compile_interval_graphs
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.models.selfgnn import graphs_to_device
    from sagnn_tpu_torch.parallel import sharding as shd

    cfg = _mesh_cfg()
    b = synthetic_dataset(num_users=48, num_items=64, graph_num=2,
                          test_size=10, seed=2)
    mc = dataclasses.replace(cfg.model, edge_attention=True)
    gb = compile_interval_graphs(b.sub_mats)
    g = graphs_to_device(gb, dev, mc, b.sub_mats)
    g["plans_ss"] = graphs_to_device(gb, dev, dataclasses.replace(
        cfg.model, spmm_src_shard_rows=16))["plans_ss"]
    return g, shd.tp_graphs({dev: g}, [dev] * 3, 48, 64)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("folded", [False, True])
def test_tp_src_sharded_hop_on_card_matches_plain(dev, exact, folded):
    """K3 over the source-shard plans cut by each of 3 ranks' target rows,
    forward and backward, against the same hop's plain version on the
    CPU (segment-sum tolerance); one K3 launch per rank and shard each
    way."""
    from sagnn_tpu_torch.parallel import sharding as shd

    g, tp = _tp_env(dev)
    ss = g["plans_ss"]
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((64, 16), generator=gen)
    cot = torch.randn((48, 16), generator=gen)

    def run(device, xx, cc):
        gg = {k: {n: t.to(device) for n, t in v.items()}
              if isinstance(v, dict) else v.to(device) for k, v in g.items()}
        hop = shd.tp_graphs({device: gg}, [device] * 3, 48, 64).hop(
            "u", 0, exact, folded, shard_rows=16)
        xs = [xx[lo:hi].clone().requires_grad_() for lo, hi in tp.item_rows]
        out = shd.tp_spmm(xs, hop)
        dx = torch.autograd.grad(out, xs, [cc[lo:hi] for lo, hi in
                                           tp.user_rows])
        return torch.cat(out), torch.cat(dx)

    sc.reset_launches()
    out, dx = run(dev, x.to(dev), cot.to(dev))
    torch.cuda.synchronize()
    name = ("segsum_fold_acc" if folded else "segsum_acc") + (
        "_f32" if exact else "_bf16")
    assert sc.LAUNCHES[name] == 3 * 4 and sc.LAUNCHES[name + "_bwd"] == 3 * 3
    want, dwant = run(torch.device("cpu"), x, cot)
    torch.testing.assert_close(out.cpu(), want, **_tol(ss["u_ptr"][0][0],
                                                       x))
    torch.testing.assert_close(dx.cpu(), dwant, **_tol(ss["i_ptr"][0][0],
                                                       cot))


def test_tp_attention_hop_on_card_matches_plain(dev):
    """K5 -> edge softmax -> K2 on each of 3 ranks' own edges (their cuts
    start at e0 != 0), forward and the backward through both tables,
    against the same hop on the CPU's plain versions: K5 once per rank
    forward and once per rank backward (dw), K2 once per rank forward and
    three times per rank backward (dx through the weights, dx and dy
    through the scores)."""
    from sagnn_tpu_torch.parallel import sharding as shd

    g, _ = _tp_env(dev)
    gen = torch.Generator().manual_seed(4)
    x, y, cot = (torch.randn((n, 16), generator=gen) for n in (64, 48, 48))

    def run(device):
        gg = {k: v.to(device) for k, v in g.items()
              if isinstance(v, torch.Tensor)}
        tp = shd.tp_graphs({device: gg}, [device] * 3, 48, 64)
        hop = tp.weighted_hop("u", 0, True)
        assert all(e0 > 0 for e0, _ in hop.cuts[1:])
        xs = [x[lo:hi].to(device).requires_grad_() for lo, hi in
              tp.item_rows]
        ys = [y[lo:hi].to(device).requires_grad_() for lo, hi in
              tp.user_rows]
        out = shd.tp_attention_spmm(xs, ys, hop)
        grads = torch.autograd.grad(out, xs + ys, [
            cot[lo:hi].to(device) for lo, hi in tp.user_rows])
        return (torch.cat(out).cpu(), torch.cat(grads[:3]).cpu(),
                torch.cat(grads[3:]).cpu())

    sc.reset_launches()
    got = run(dev)
    torch.cuda.synchronize()
    assert sc.LAUNCHES["sddmm_f32"] == 3 and sc.LAUNCHES["sddmm_f32_bwd"] == 3
    assert sc.LAUNCHES["wsegsum_f32"] == 3
    assert sc.LAUNCHES["wsegsum_f32_bwd"] == 9
    want = run(torch.device("cpu"))
    for a, b, what in zip(got, want, ("out", "dx", "dy")):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=what)


@pytest.mark.parametrize("model_ranks", [1, 4])
def test_ring_attention_on_card_matches_dense(dev, model_ranks):
    """Ring attention over a one-card row of model ranks (every rank on
    cuda:0, the exchanges on side streams) against the dense masked MHSA
    on the card: values rtol/atol 2e-5, gradients 5e-5."""
    from sagnn_tpu_torch.ops.attention import multi_head_self_attention
    from sagnn_tpu_torch.parallel.mesh import make_mesh
    from sagnn_tpu_torch.parallel.ring_attention import \
        ring_multi_head_self_attention

    gen = torch.Generator().manual_seed(model_ranks)
    B, L, D, H = 8, 200, 64, 16
    params = {k: (0.2 * torch.randn((D, D) if k[0] == "w" else (D,),
                                    generator=gen)).to(dev)
              .requires_grad_() for k in ("wq", "bq", "wk", "bk", "wv",
                                          "bv")}
    x = torch.randn((B, L, D), generator=gen).to(dev).requires_grad_()
    mask = (torch.rand((B, L), generator=gen) > 0.4).float().to(dev)
    mask[:, -1] = 1.0
    cot = torch.randn((B, L, D), generator=gen).to(dev)
    mesh = make_mesh(data=1, model=model_ranks, devices=[dev] * model_ranks)
    got = ring_multi_head_self_attention(mesh, params, x, H, mask)
    want = multi_head_self_attention(params, x, H, stable=True, mask=mask)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    leaves = [x] + list(params.values())
    for a, b in zip(torch.autograd.grad(got, leaves, cot),
                    torch.autograd.grad(want, leaves, cot)):
        torch.testing.assert_close(a, b, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shards", [2, 4])
def test_ag_hop_on_card_matches_plain(dev, exact, shards):
    """The all-gather edge partition's hop (`ag_hop`, a tensor-parallel
    hop) on a one-card mesh of `shards` ranks, forward and backward, in
    both table modes, against the same hop on the CPU's plain versions
    (segment-sum tolerance of the whole CSR, and of its transpose): one
    K1 launch per rank each way."""
    from sagnn_tpu_torch.parallel import edge_partition as ep
    from sagnn_tpu_torch.parallel import sharding as shd
    from sagnn_tpu_torch.parallel.mesh import make_mesh

    n_tgt, n_src, e = 1000, 700, 20_000
    rng = np.random.default_rng(shards)
    tgt = np.sort(rng.integers(0, n_tgt, e)).astype(np.int32)
    tgt[: e // 4] = 3                               # one hot row
    tgt = np.sort(tgt)
    src = rng.integers(0, n_src, e).astype(np.int32)
    parts = ep.partition_edges_by_target(src, tgt, n_tgt, shards)
    xp = ep.pad_node_table(
        rng.standard_normal((n_src, 64)).astype(np.float32), shards)
    cot = torch.from_numpy(
        rng.standard_normal((shards * parts.rows_per_shard, 64))
        .astype(np.float32))
    rows = xp.shape[0] // shards

    def run(device):
        mesh = make_mesh(model=shards, devices=[device] * shards)
        hop = ep.ag_hop(parts, mesh, rows, exact)
        xs = [b.requires_grad_() for b in ep.shard(
            torch.from_numpy(xp).to(device), rows, mesh)]
        out = shd.tp_spmm(xs, hop)
        dx = torch.autograd.grad(out, xs, list(cot.to(device).split(
            parts.rows_per_shard)))
        return torch.cat(out).cpu(), torch.cat(dx).cpu()

    sc.reset_launches()
    out, dx = run(dev)
    torch.cuda.synchronize()
    name = "segsum_f32" if exact else "segsum_bf16"
    assert sc.LAUNCHES[name] == shards
    assert sc.LAUNCHES[name + "_bwd"] == shards
    want, dwant = run(torch.device("cpu"))
    ptr = torch.from_numpy(sc.csr_row_ptr(tgt, n_tgt))
    bptr = torch.from_numpy(sc.csr_row_ptr(np.sort(src), n_src))
    torch.testing.assert_close(out, want, **_tol(ptr, torch.from_numpy(xp)))
    torch.testing.assert_close(dx, dwant, **_tol(bptr, cot))


# -- the interval attention kernel pair -------------------------------------

def _mhsa_inputs(n, t, d, seed, overflow):
    """q, k, v and a cotangent [n, t, d] f32; with `overflow`, one node's
    logits overflow exp in f32 (60 x 60 x dk / sqrt(dk) past 88.7)."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, g = (torch.randn((n, t, d), generator=gen) for _ in range(4))
    if overflow:
        q[n // 2, t // 2] = 60.0
        k[n // 2, t - 1] = 60.0
    return q, k, v, g


def _check_mhsa(dev, q, k, v, g, heads, stable):
    """The kernel pair through `IntervalAttentionFunction` against the
    plain small-T path: NaN and inf exactly where the plain path on the
    card (f32) gives them; elsewhere ctx, dq, dk, dv against the plain path
    and its autograd in f64 on the CPU, within 4x the plain f32 path's own
    error plus 1e-5 of the largest |value| (the sums run in another order).
    One launch each way."""
    from sagnn_tpu_torch.ops import attention as att

    def run(fn, dtype, device):
        leaves = [x.to(device, dtype).requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, heads, stable)
        grads = torch.autograd.grad(out, leaves, g.to(device, dtype))
        return [t.detach() for t in (out, *grads)]

    att.reset_launches()
    got = run(att.IntervalAttentionFunction.apply, torch.float32, dev)
    torch.cuda.synchronize()
    assert att.LAUNCHES == {"interval_mhsa_f32": 1,
                            "interval_mhsa_f32_bwd": 1}
    plain = run(att.interval_attention_plain, torch.float32, dev)
    want = run(att.interval_attention_plain, torch.float64, "cpu")
    for name, a, p, w in zip(("ctx", "dq", "dk", "dv"), got, plain, want):
        assert torch.equal(a.isnan(), p.isnan()), name
        assert torch.equal(a.isinf(), p.isinf()), name
        keep = torch.isfinite(p).cpu()
        a, p = a.cpu().double()[keep], p.cpu().double()[keep]
        w = w[keep]
        plain_err = float((p - w).abs().max())
        err = float((a - w).abs().max())
        assert err <= 4 * plain_err + 1e-5 * float(w.abs().max()), \
            (name, err, plain_err)
    return got


@pytest.mark.parametrize("stable", [False, True], ids=["raw", "stable"])
@pytest.mark.parametrize("t", [1, 3, 12, 16])
def test_interval_attention_matches_plain(dev, t, stable):
    """1,031 nodes (no multiple of a block's nodes), 16 heads of 4, forward
    and all three gradients; with raw exp one node's logits overflow."""
    q, k, v, g = _mhsa_inputs(1031, t, 64, seed=t, overflow=not stable)
    got = _check_mhsa(dev, q, k, v, g, 16, stable)
    assert got[0].isnan().any() == (not stable)


@pytest.mark.parametrize("head_dim", [1, 2, 8, 16])
def test_interval_attention_other_head_sizes(dev, head_dim):
    for stable in (False, True):
        q, k, v, g = _mhsa_inputs(333, 5, 4 * head_dim, seed=head_dim,
                                  overflow=False)
        _check_mhsa(dev, q, k, v, g, 4, stable)


def test_interval_attention_under_checkpoint(dev):
    """`multi_head_self_attention` under `torch.utils.checkpoint`: the
    forward kernel runs again in the recompute (2 + 1 launches) and the
    gradients are the bits of the call without the checkpoint."""
    from torch.utils.checkpoint import checkpoint

    from sagnn_tpu_torch.ops import attention as att

    gen = torch.Generator().manual_seed(5)
    params = {n: (torch.randn(s, generator=gen) * 0.2).to(dev)
              .requires_grad_()
              for n, s in (("wq", (64, 64)), ("bq", (64,)), ("wk", (64, 64)),
                           ("bk", (64,)), ("wv", (64, 64)), ("bv", (64,)))}
    x = torch.randn((1031, 12, 64), generator=gen).to(dev).requires_grad_()
    cot = torch.randn((1031, 12, 64), generator=gen).to(dev)
    leaves = [x, *params.values()]

    def layer(x_):
        return att.multi_head_self_attention(params, x_, 16)

    att.reset_launches()
    want = torch.autograd.grad(layer(x), leaves, cot)
    assert att.LAUNCHES == {"interval_mhsa_f32": 1,
                            "interval_mhsa_f32_bwd": 1}
    att.reset_launches()
    got = torch.autograd.grad(
        checkpoint(layer, x, use_reentrant=False), leaves, cot)
    torch.cuda.synchronize()
    assert att.LAUNCHES == {"interval_mhsa_f32": 2,
                            "interval_mhsa_f32_bwd": 1}
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_interval_attention_rejects_what_it_does_not_take(dev):
    from sagnn_tpu_torch.ops import attention as att
    q = torch.zeros((8, 12, 64), device=dev)
    with pytest.raises(ValueError):
        att.interval_attention(q, q.transpose(0, 1).contiguous()
                               .transpose(0, 1), q, 16)
    with pytest.raises(ValueError):
        att.interval_attention(q[:, :, 1:], q[:, :, 1:], q[:, :, 1:], 21)
    assert att.interval_attention(q[:0], q[:0], q[:0], 16).shape == \
        (0, 12, 64)


@pytest.mark.parametrize("preset,launches", [("yelp", 4), ("gowalla", 3)])
def test_interval_attention_launches_on_the_main_path(dev, tmp_path, preset,
                                                      launches):
    """Per training step: the two fusion streams and att_layer pooled
    sequence layers, each one forward and one backward launch (yelp 4 + 4,
    gowalla 3 + 3); an encode 2 + 0; a request att_layer + 0."""
    import dataclasses

    from sagnn_tpu_torch.config import PRESETS
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.models.selfgnn import reg_loss
    from sagnn_tpu_torch.ops import attention as att
    from sagnn_tpu_torch.serve import Recommender
    from sagnn_tpu_torch.train.trainer import Trainer

    base = PRESETS[preset]
    cfg = base.replace(
        model=dataclasses.replace(base.model, spmm_backend="pallas"),
        train=dataclasses.replace(base.train, test_size=30, batch=32,
                                  trn_num=64, samp_num=8, ssl_num=6,
                                  seed=1))
    bundle = synthetic_dataset(num_users=70, num_items=90,
                               graph_num=base.model.graph_num, test_size=30,
                               seed=2)
    tr = Trainer(cfg, bundle, ckpt_root=str(tmp_path), device=dev)
    ids = tr.sampler.epoch_user_ids(cfg.train.trn_num)
    batch = tr.sampler.train_batch(ids[:cfg.train.batch]).to(dev)
    att.reset_launches()
    tr.train_step(batch)
    torch.cuda.synchronize()
    assert att.LAUNCHES == {"interval_mhsa_f32": launches,
                            "interval_mhsa_f32_bwd": launches}
    rec = Recommender(cfg, bundle, tr.state["params"], device=dev)
    att.reset_launches()
    rec.encode()
    assert att.LAUNCHES == {"interval_mhsa_f32": 2,
                            "interval_mhsa_f32_bwd": 0}
    att.reset_launches()
    rec.recommend(list(range(16)), k=10)
    torch.cuda.synchronize()
    assert att.LAUNCHES == {"interval_mhsa_f32": base.model.att_layer,
                            "interval_mhsa_f32_bwd": 0}
