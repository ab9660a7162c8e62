"""The port's per-token sequence branch (`per_token_seq_attention`) against
the benchmark's plain reference of it (`benchmark/reference/selfgnn_seq.py`)
on the CPU, at the movielens preset's widths and depth (graph_num 6,
att_layer 3, 16 heads of 4, latdim 64) and a short window (L 16 takes the
masked small-T path, L 24 the einsum path): the branch's output, the
losses, each leaf's gradient and a Trainer's step, on batches with padded
rows and fully masked rows; the pooled branch in the per-token one's place
fails the same tolerances. Also the span `sagnn.model.seq_attention`, the
einsum path's counter `SEQ_ATTENTION` (from shapes, no sync: it runs on
meta tensors) and `benchmark/harness/counts_seq.py` by hand.

Tolerances: the program and the reference compute the same f32 arithmetic
in another order (the layer norm's variance, the softmax's sums, the
einsums' contractions), so they part by rounding alone, a few f32 ulps
carried through three layers: observed 5.3e-7 of the largest value on the
branch, 1.8e-7 on a loss and 9.4e-7 on a leaf's gradient; the limits
leave about 20x room and lie far below what the pooled branch gives
(3.6 to 58).
"""

import math
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import cells, counts, counts_seq, logs, oracle, \
    train_seq
from benchmark.harness.weights import make_weights
from benchmark.reference import selfgnn as ref
from benchmark.reference.selfgnn_seq import SelfGNNSeq
from sagnn_tpu_torch.config import Config
from sagnn_tpu_torch.models import selfgnn
from sagnn_tpu_torch.ops import attention
from sagnn_tpu_torch.train.trainer import Trainer

from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

LOG = {"num_users": 96, "num_items": 80, "interactions": 1200,
       "per_user_min": 4, "time_range": 1000, "item_power": 2.0,
       "clusters": 4, "in_cluster": 0.6}
SEED = 11
# the batch: 30 users in 32 rows, so rows 30 and 31 are fully masked
USERS, ROWS = 30, 32
# the branch's output: max |prog - ref| over max |ref|
BRANCH_TOL = 1e-5
# the losses: relative gap
LOSS_TOL = 5e-6
# a leaf's gradient: |g_prog - g_ref| over max(|g_ref|, the median leaf's)
GRAD_TOL = 2e-5


def _cfg(L: int, per_token: bool = True) -> Config:
    import dataclasses
    cfg = Config.preset("movielens")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, pos_length=L, keep_rate=1.0,
                                  per_token_seq_attention=per_token,
                                  spmm_backend="pallas"),
        train=dataclasses.replace(cfg.train, batch=ROWS, trn_num=96,
                                  samp_num=4, ssl_num=6, seed=SEED))


def _model_dict(cfg: Config) -> dict:
    m = cfg.model
    return {"latdim": m.latdim, "graph_num": m.graph_num,
            "gnn_layer": m.gnn_layer, "att_layer": m.att_layer,
            "num_heads": m.num_heads, "ssldim": m.ssldim,
            "pos_length": m.pos_length, "leaky": m.leaky,
            "keep_rate": m.keep_rate}


@pytest.fixture(scope="module", params=[16, 24], ids=["L16", "L24"])
def setup(request, tmp_path_factory):
    """A Trainer of the movielens preset per token on a small log, the
    seed's weights, one sampled batch, the reference model."""
    L = request.param
    cfg = _cfg(L)
    log = logs.generate(LOG, SEED)
    bundle = logs.bundle(log, cfg.model.graph_num)
    m = _model_dict(cfg)
    weights = make_weights(m, log.num_users, log.num_items, SEED, "cpu")
    tr = Trainer(cfg, bundle, ckpt_root=str(tmp_path_factory.mktemp("ck")),
                 device="cpu")
    tr.load_imported_params({k: v.clone() for k, v in weights.items()})
    batch = tr.sampler.train_batch(np.arange(USERS), batch_cap=ROWS)
    mask = np.asarray(batch.seq_mask)
    assert (mask[USERS:] == 0).all()                      # masked rows
    assert ((mask[:USERS] == 0).any(1)).sum() >= USERS // 3  # padded rows
    graph = ref.Graph.from_edges(logs.interval_edges(log, m["graph_num"]),
                                 log.num_users, log.num_items, "cpu")
    return {"cfg": cfg, "m": m, "log": log, "trainer": tr,
            "batch": batch.to("cpu"), "graph": graph,
            "weights": weights}


def _params(weights, grad=False):
    p = {k: v.detach().clone() for k, v in weights.items()}
    for v in p.values():
        v.requires_grad_(grad)
    return p


def _branch_gap(s, model_class) -> float:
    gen = torch.Generator().manual_seed(3)
    fi = torch.randn(s["log"].num_items, 64, generator=gen)
    b = s["batch"]
    p = _params(s["weights"])
    got = selfgnn._sequence_branch(p, fi, b.seq, b.seq_mask,
                                   s["cfg"].model)
    want = model_class(s["m"], s["graph"]).sequence(p, fi, b.seq,
                                                    b.seq_mask)
    assert torch.all(got[USERS:] == 0) and torch.all(want[USERS:] == 0)
    return float((got - want).abs().max() / want.abs().max())


def _loss_gaps(s, model_class):
    """(relative gaps of preLoss, ssl and the loss; per leaf gradient
    gaps) of the program's step against `model_class`'s."""
    tc = s["cfg"].train
    p = _params(s["weights"], grad=True)
    pre, ssl, _ = s["trainer"].model.train_losses(p, s["trainer"].graphs,
                                                  s["batch"])
    loss = pre + tc.reg * selfgnn.reg_loss(p) + tc.ssl_reg * ssl
    keys = sorted(p)
    g_prog = torch.autograd.grad(loss, [p[k] for k in keys],
                                 allow_unused=True)
    q = _params(s["weights"], grad=True)
    batch = {f: getattr(s["batch"], f) for f in
             ("uids", "pos_iids", "neg_iids", "useq_row", "pair_mask", "seq",
              "seq_mask", "ssl_u_a", "ssl_i_a", "ssl_u_b", "ssl_i_b",
              "ssl_mask")}
    terms = model_class(s["m"], s["graph"]).loss(q, batch, tc.reg,
                                                 tc.ssl_reg)
    g_ref = torch.autograd.grad(terms["loss"], [q[k] for k in keys],
                                allow_unused=True)
    losses = {name: abs(a.item() - terms[key].item()) / abs(terms[key].item())
              for name, a, key in (("pre", pre, "preLoss"),
                                   ("ssl", ssl, "ssl"),
                                   ("loss", loss, "loss"))}
    zero = torch.zeros(())
    gp = {k: zero if g is None else g for k, g in zip(keys, g_prog)}
    gr = {k: zero if g is None else g for k, g in zip(keys, g_ref)}
    norms = {k: float(torch.linalg.vector_norm(gr[k])) for k in keys}
    med = float(np.median(list(norms.values())))
    grads = {k: float(torch.linalg.vector_norm(gp[k] - gr[k]))
             / max(norms[k], med) for k in keys}
    return losses, grads


def test_branch_matches_the_reference(setup):
    assert _branch_gap(setup, SelfGNNSeq) < BRANCH_TOL


def test_losses_and_gradients_match_the_reference(setup):
    losses, grads = _loss_gaps(setup, SelfGNNSeq)
    assert max(losses.values()) < LOSS_TOL, losses
    worst = max(grads, key=grads.get)
    assert grads[worst] < GRAD_TOL, (worst, grads[worst])
    # the sequence branch's own leaves get real gradients
    assert any(k.startswith("free/seq_mhsa/2/") for k in grads)


def test_pooled_branch_fails_the_tolerances(setup):
    """The released code's pooled branch (quirk Q3) in the per-token one's
    place."""
    assert _branch_gap(setup, ref.SelfGNN) > 100 * BRANCH_TOL
    losses, grads = _loss_gaps(setup, ref.SelfGNN)
    assert losses["pre"] > 10 * LOSS_TOL
    assert max(grads.values()) > 10 * GRAD_TOL


def _tiny_cell(L: int):
    cell = cells.load_cell("movielens_seq.train")
    cell.log = {**cell.log, **LOG}
    cell.config = {**cell.config,
                   "model": {**cell.config["model"], "pos_length": L},
                   "train": {**cell.config["train"], "batch": ROWS}}
    return cell


@pytest.mark.parametrize("L", [16, 24])
def test_trainer_step_matches_the_reference(L):
    """A Trainer of the cell's configuration (window cut to L) through
    `train_epoch` -> `train_step`, its step held to the reference's by
    the benchmark's own check and the cell's limits (batch cut to 32
    rows, so that the small log's epoch has the three checked steps)."""
    cell = _tiny_cell(L)
    prog = train_seq.Program(cell, SEED, torch.device("cpu"))
    assert len(prog.record["batches"]) == train_seq.train.CHECKED_STEPS
    numbers = train_seq.check(prog, torch.device("cpu"))
    verdict = oracle.judge(numbers, cell.limits)
    assert verdict["correct"], verdict["check"]


def _traced_branch(per_token: bool):
    cfg = _cfg(24, per_token)
    gen = torch.Generator().manual_seed(5)
    m = _model_dict(cfg)
    p = make_weights(m, 8, 40, SEED, "cpu")
    fi = torch.randn(40, 64, generator=gen)
    seq = torch.randint(1, 40, (4, 24), generator=gen)
    mask = (torch.arange(24) >= 10).float().expand(4, 24).clone()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        selfgnn._sequence_branch(p, fi, seq, mask, cfg.model)
    events = prof.profiler.kineto_results.events()
    return [(e.start_ns(), e.end_ns(), e.name()) for e in events
            if e.name().startswith("sagnn.")]


@pytest.mark.parametrize("per_token", [True, False],
                         ids=["per_token", "pooled"])
def test_seq_attention_span(per_token):
    spans = _traced_branch(per_token)
    names = Counter(n for _, _, n in spans)
    assert names["sagnn.model.sequence"] == 1
    assert names["sagnn.model.seq_attention"] == (3 if per_token else 0)
    (s0, e0, _), = [x for x in spans if x[2] == "sagnn.model.sequence"]
    for s, e, n in spans:
        if n == "sagnn.model.seq_attention":
            assert s0 <= s and e <= e0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_seq_attention_counter(device):
    """B, B·T and B·T² a masked call past T = 16, from shapes alone (on
    meta tensors, which hold no values, any fetch would raise); the
    masked small-T path and unmasked calls are not counted."""
    D, H = 64, 16
    p = {k: torch.zeros(D, D, device=device) for k in ("wq", "wk", "wv")}
    p.update({k: torch.zeros(D, device=device) for k in ("bq", "bk", "bv")})
    attention.reset_seq_attention()
    for B, T, masked in ((5, 24, True), (3, 40, True), (5, 16, True),
                         (5, 24, False)):
        x = torch.zeros(B, T, D, device=device)
        mask = torch.ones(B, T, device=device) if masked else None
        out = attention.multi_head_self_attention(p, x, H, stable=True,
                                                  mask=mask)
        assert out.shape == (B, T, D)
    assert attention.SEQ_ATTENTION == {
        "calls": 5 + 3, "slots": 5 * 24 + 3 * 40,
        "pairs": 5 * 24 ** 2 + 3 * 40 ** 2}
    attention.reset_seq_attention()
    assert not any(attention.SEQ_ATTENTION.values())


def test_counts_seq_by_hand():
    """A 3-user log: train sequences of 3, 10 and 30 items, L 8, pred_num
    5. The sampler's positive is the c-th last item before the last, c
    uniform over 1 .. max(min(6, p - 3), 1) for p = len - 1: user 0 (p 2)
    c = 1, w = 1; user 1 (p 9) c = 1..6, w = 8, 7, 6, 5, 4, 3; user 2
    (p 29) w = 8 whatever c."""
    lengths = [3 + 1, 10 + 1, 30 + 1]              # with the held-out item
    bounds = np.concatenate([[0], np.cumsum(lengths)])
    n = int(bounds[-1])
    log = logs.Log(3, 50, np.repeat(np.arange(3), lengths),
                   np.zeros(n, np.int64), np.arange(n), bounds,
                   np.ones(n, bool))
    tok, pair = counts_seq.window_fill(np.diff(log.bounds) - 1, 8, 5)
    assert tok == pytest.approx((1 + 33 / 6 + 8) / 3)
    assert pair == pytest.approx((1 + 199 / 6 + 64) / 3)

    D, B, L, A = 4, 2, 8, 3
    model = {"graph_num": 1, "latdim": D, "pos_length": L, "ssldim": 1,
             "gnn_layer": 1, "att_layer": A}
    train = {"batch": B, "samp_num": 1, "ssl_num": 1}
    T, P = B * tok, B * pair
    pooled = 2 * B * L * D * 2 + A * B * (6 * D * D + 4 * D)
    per_token = A * (T * 6 * D * D + P * 4 * D)
    want = counts.train_step_flops(model, train, 3, 50, [7]) \
        + 3 * (per_token - pooled)
    assert counts_seq.train_step_flops(model, train, 3, 50, [7], T, P) == \
        pytest.approx(want)

    fwd = counts.bound_s(4 * T * D * 4, 4 * D * P)
    bwd = counts.bound_s(7 * T * D * 4, 8 * D * P)
    assert counts_seq.seq_attention_bound_s(D, T, P) == \
        pytest.approx(fwd + bwd)
    assert math.isfinite(fwd) and bwd > fwd
