"""The CUDA segment-sum kernel on the card, forward and backward, against
its plain version; the serving encode and a training step on the card
against the CPU.

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


def _tol(ptr):
    deg = int((ptr[1:] - ptr[:-1]).max()) if ptr.numel() > 1 else 0
    return dict(rtol=1e-5, atol=1e-5 * math.sqrt(max(1, deg)))


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
    torch.testing.assert_close(got.cpu().double(), want, **_tol(ptr))


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
    for a, b in zip(cpu.encode(), gpu.encode()):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-5)
    assert cpu.evaluate() == pytest.approx(gpu.evaluate(), abs=1e-6)


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
                               **_tol(g[f"{other}_ptr"]))


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
    assert launches == {"segsum_f32": 12, "segsum_bf16": 0,
                        "segsum_f32_bwd": 12, "segsum_bf16_bwd": 0}
    (pre_c, ssl_c, g_c), (pre_d, ssl_d, g_d) = results
    assert pre_d == pytest.approx(pre_c, rel=1e-5)
    assert ssl_d == pytest.approx(ssl_c, rel=1e-5)
    g_max = max(float(g.abs().max()) for g in g_c.values())
    for k in g_c:
        torch.testing.assert_close(g_d[k], g_c[k], rtol=1e-4,
                                   atol=1e-5 * g_max, msg=k)
