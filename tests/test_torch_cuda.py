"""The CUDA segment-sum kernel on the card, against its plain version.

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
    with pytest.raises(RuntimeError, match="forward-only"):
        sc.spmm_apply(x.requires_grad_(), src, ptr)


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
