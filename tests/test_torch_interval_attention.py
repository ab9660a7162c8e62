"""The interval attention kernel pair's CPU side (`ops/attention.py`):
the plain transcription of the backward kernel's arithmetic against
autograd of the small-T path, NaN for NaN where exp overflows; the routing
(CPU, f64, masked and T > 16 calls keep today's code, no launch); the
wrapper's checks; the source's bounds; and a training step through
`IntervalAttentionFunction` (its backward the transcription) against the
plain path. The kernels themselves run in tests/test_torch_cuda.py.
"""

import dataclasses
import math
import os
import re

import pytest
import torch

from sagnn_tpu_torch.ops import attention as tatt
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

HEADS, HEAD_DIM = 16, 4        # the presets' 16 heads of 4


def _qkvg(n, t, d, seed, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((n, t, d), generator=gen, dtype=dtype)
            for _ in range(4)]


def _autograd(q, k, v, g, heads, stable):
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = tatt.interval_attention_plain(*leaves, heads, stable)
    return out.detach(), torch.autograd.grad(out, leaves, g)


@pytest.mark.parametrize("stable", [False, True], ids=["raw", "stable"])
@pytest.mark.parametrize("t", [1, 3, 12, 16])
def test_backward_transcription_matches_autograd(t, stable):
    """The backward kernel's arithmetic (scores recomputed; dl = p (da - c)
    for both normalisations) against autograd of today's small-T path, in
    f64; the same through `IntervalAttentionFunction` on the CPU (its
    forward the plain path, its backward the transcription)."""
    q, k, v, g = _qkvg(23, t, HEADS * HEAD_DIM, seed=t)
    want_out, want = _autograd(q, k, v, g, HEADS, stable)
    got = tatt.interval_attention_backward_plain(q, k, v, g, HEADS, stable)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12, msg=name)

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tatt.IntervalAttentionFunction.apply(*leaves, HEADS, stable)
    torch.testing.assert_close(out.detach(), want_out, rtol=0, atol=0)
    for name, a, b in zip(("dq", "dk", "dv"),
                          torch.autograd.grad(out, leaves, g), want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12, msg=name)


@pytest.mark.parametrize("head_dim", [1, 2, 8, 16])
def test_backward_transcription_other_head_sizes(head_dim):
    q, k, v, g = _qkvg(9, 5, 4 * head_dim, seed=head_dim)
    for stable in (False, True):
        _, want = _autograd(q, k, v, g, 4, stable)
        got = tatt.interval_attention_backward_plain(q, k, v, g, 4, stable)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_overflow_gives_nan_where_autograd_does():
    """Raw exp (Q5) overflows f32 in one node's row: the forward gives NaN
    there as the plain path does, and the transcription's dq, dk, dv are
    NaN exactly where autograd's are, and equal elsewhere."""
    q, k, v, g = _qkvg(5, 12, HEADS * HEAD_DIM, seed=3, dtype=torch.float32)
    q[2, 4] = 60.0
    k[2, 7] = 60.0                   # logits of 60 x 60 x 4 / 2 overflow
    out, want = _autograd(q, k, v, g, HEADS, False)
    assert out.isnan().any() and not out[[0, 1, 3, 4]].isnan().any()
    got = tatt.interval_attention_backward_plain(q, k, v, g, HEADS, False)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(a.isnan(), b.isnan()), name
        assert b.isnan().any(), name
        keep = ~b.isnan()
        torch.testing.assert_close(a[keep], b[keep], rtol=1e-5,
                                   atol=1e-6 * float(b[keep].abs().max()),
                                   msg=name)


def _params(d, seed, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    return {name: (torch.randn(shape, generator=gen, dtype=dtype) * 0.3
                   ).requires_grad_()
            for name, shape in (("wq", (d, d)), ("bq", (d,)), ("wk", (d, d)),
                                ("bk", (d,)), ("wv", (d, d)), ("bv", (d,)))}


def _einsum_reference(params, x, heads, stable, mask):
    """The attention written out on the [B, H, T, S] layout."""
    B, T, D = x.shape
    dk = D // heads
    q, k, v = (
        (x.double() @ params[f"w{n}"].double() + params[f"b{n}"].double())
        .reshape(B, T, heads, dk).transpose(1, 2) for n in "qkv")
    logits = q @ k.transpose(-1, -2) / math.sqrt(dk)
    if mask is not None:
        logits = logits.masked_fill(mask[:, None, None, :] <= 0, -1e30)
    if stable:
        attn = torch.softmax(logits, dim=-1)
    else:
        e = torch.exp(logits)
        attn = e / (e.sum(-1, keepdim=True) + 1e-8)
    return (attn @ v).transpose(1, 2).reshape(B, T, D)


@pytest.mark.parametrize("case", ["cpu_f32", "f64", "masked", "t17"])
def test_other_calls_keep_todays_code(case, monkeypatch):
    """CPU inputs, f64, masked calls and T > 16 never reach the kernel
    path: the Function and the kernel wrapper would raise, the launch
    counter stays 0, and the values and gradients are today's."""
    def refuse(*_a, **_k):
        raise AssertionError("the kernel path was taken")

    monkeypatch.setattr(tatt.IntervalAttentionFunction, "apply", refuse)
    monkeypatch.setattr(tatt, "interval_attention", refuse)
    monkeypatch.setattr(tatt, "interval_attention_backward", refuse)
    tatt.reset_launches()
    t = 17 if case == "t17" else 12
    dtype = torch.float64 if case == "f64" else torch.float32
    params = _params(16, seed=1, dtype=dtype)
    x = torch.randn((6, t, 16), generator=torch.Generator().manual_seed(2),
                    dtype=dtype)
    mask = None
    if case == "masked":
        mask = (torch.arange(t) < 9).to(dtype)[None].repeat(6, 1)
    stable = case == "masked"
    assert not tatt._takes_kernel(x, 4, mask)
    out = tatt.multi_head_self_attention(params, x, 4, stable=stable,
                                         mask=mask)
    grads = torch.autograd.grad(out.sum(), list(params.values()))
    want = _einsum_reference(params, x, 4, stable, mask)
    want_grads = torch.autograd.grad(want.sum(), list(params.values()))
    tol = dict(rtol=1e-10, atol=1e-12) if dtype == torch.float64 else \
        dict(rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out.double(), want.detach(), **tol)
    for a, b in zip(grads, want_grads):
        torch.testing.assert_close(a.double(), b.double(), **tol)
    assert tatt.LAUNCHES == {"interval_mhsa_f32": 0,
                             "interval_mhsa_f32_bwd": 0}


@pytest.mark.parametrize("case", ["dtype", "shape", "strided", "heads",
                                  "long", "wide"])
def test_kernel_args_are_checked(case):
    """What the kernels do not take raises before any launch."""
    q = torch.zeros((8, 12, 64))
    k = v = q
    heads = HEADS
    if case == "dtype":
        k = q.double()
    elif case == "shape":
        k = torch.zeros((8, 11, 64))
    elif case == "strided":
        k = torch.zeros((8, 64, 12)).transpose(1, 2)
    elif case == "heads":
        heads = 21                     # a head size of 3
        q = k = v = torch.zeros((8, 12, 63))
    elif case == "long":
        q = k = v = torch.zeros((8, 17, 64))
    else:
        q = k = v = torch.zeros((2, 16, 512))   # T x D over the tile
    with pytest.raises((ValueError, TypeError)):
        tatt._check_kernel_args(heads, q=q, k=k, v=v)


def test_kernel_is_compiled_with_these_bounds():
    """The tile bound has one source: `_build` passes MAX_NODE_FLOATS as a
    -D define and the source takes it from there; the source's bound on T
    and its head sizes are the wrapper's."""
    from sagnn_tpu_torch.ops import _build

    flags = _build._flags()
    assert f"-DSAGNN_MHSA_MAX_NODE_FLOATS={tatt.MAX_NODE_FLOATS}" in flags
    with open(os.path.join(_build.CSRC_DIR, "interval_attention.cu")) as f:
        source = f.read()
    assert re.search(r"constexpr int kMaxNodeFloats = "
                     r"SAGNN_MHSA_MAX_NODE_FLOATS;", source)
    assert re.search(rf"constexpr int kMaxT = {tatt.KERNEL_MAX_T};", source)
    entry = source[source.index("int sagnn_interval_mhsa_f32("):]
    entry = entry[:entry.index("\n}\n")]
    cases = tuple(int(c) for c in re.findall(r"case (\d+):", entry))
    assert cases == tatt.KERNEL_HEAD_DIMS


@pytest.mark.parametrize("preset,chunk_rows", [("yelp", 0), ("gowalla", 0),
                                               ("gowalla", 48)])
def test_step_through_the_function_matches_plain(preset, chunk_rows, tmp_path,
                                                 monkeypatch):
    """A training step with every unmasked small-T attention routed through
    `IntervalAttentionFunction` (on the CPU: the plain forward and the
    backward's transcription), also in row blocks under `checkpoint`,
    against the plain path: the loss at rtol 1e-6, every gradient at rtol
    1e-4 and atol 1e-6 x the largest |g| (f32: the backward sums in
    another order)."""
    from sagnn_tpu_torch.config import PRESETS
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.models.selfgnn import reg_loss
    from sagnn_tpu_torch.train.trainer import Trainer

    base = PRESETS[preset]
    g = base.model.graph_num
    cfg = base.replace(
        model=dataclasses.replace(base.model, keep_rate=1.0,
                                  fusion_chunk_rows=chunk_rows),
        train=dataclasses.replace(base.train, test_size=10, batch=16,
                                  trn_num=32, samp_num=4, ssl_num=4, seed=1))
    bundle = synthetic_dataset(num_users=60, num_items=70, graph_num=g,
                               test_size=10, seed=2)
    tr = Trainer(cfg, bundle, device="cpu", ckpt_root=str(tmp_path))
    ids = tr.sampler.epoch_user_ids(cfg.train.trn_num)
    batch = tr.sampler.train_batch(ids[:cfg.train.batch]).to("cpu")
    params = {k: v.detach().requires_grad_()
              for k, v in tr.state["params"].items()}
    graphs = tr.graphs

    routed = []

    def takes(q, num_heads, mask):
        ok = mask is None and q.shape[1] <= tatt.KERNEL_MAX_T
        routed.append(ok)
        return ok

    def step():
        pre, ssl, _ = tr.model.train_losses(params, graphs, batch)
        loss = pre + cfg.train.reg * reg_loss(params) + \
            cfg.train.ssl_reg * ssl
        keys = sorted(params)
        return loss.item(), torch.autograd.grad(
            loss, [params[k] for k in keys])

    want_loss, want = step()
    monkeypatch.setattr(tatt, "_takes_kernel", takes)
    got_loss, got = step()
    # two fusion streams and att_layer pooled sequence layers, each once
    # forward (the row blocks: once a block, and once more in the
    # checkpoint's recompute)
    assert sum(routed) >= 2 + base.model.att_layer
    assert got_loss == pytest.approx(want_loss, rel=1e-6)
    g_max = max(float(b.abs().max()) for b in want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * g_max)
