"""The port's serving entry points end to end on the CPU: `Recommender`
against the JAX package's eval on the same weights, and the CLI."""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagnn_tpu.data.sampler import Sampler
from sagnn_tpu.train.metrics import topk_metrics as j_topk_metrics
from sagnn_tpu_torch import config as tcfg
from sagnn_tpu_torch.serve import Recommender

from tests.torch_port_helpers import MCFG, setup, torch_cfg
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def env():
    return setup(num_users=48, num_items=64, seed=8, param_seed=3)


def _cfg(backend="pallas", batch=16):
    return tcfg.Config(
        model=dataclasses.replace(torch_cfg(MCFG), spmm_backend=backend),
        train=tcfg.TrainConfig(batch=batch, test_size=9))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_recommender_evaluate_matches_jax(env, backend):
    bundle, jm, jg, jp, _tm, _tg, tp = env
    rec = Recommender(_cfg(backend), bundle, tp, device="cpu")
    got = rec.evaluate()

    # the JAX package's candidate eval (Trainer.test_epoch's arithmetic)
    jm.cfg = dataclasses.replace(MCFG, spmm_backend=backend)
    fu, fi, _, _ = jm.encode(jp, jg, train=False)
    sampler = Sampler(bundle, batch=16, samp_num=4, ssl_num=2, pred_num=3,
                      pos_length=MCFG.pos_length, test_size=9,
                      backend="numpy")
    ids = np.asarray(bundle.tst_usrs)
    totals = {}
    for s in range(0, len(ids), 16):
        u, c, _p, seq, m, v = sampler.test_batch(ids[s:s + 16])
        scores = jm.score_with_encodings(jp, fu, fi, jnp.asarray(u),
                                         jnp.asarray(c), jnp.asarray(seq),
                                         jnp.asarray(m))
        for k, val in j_topk_metrics(scores, valid=jnp.asarray(v)).items():
            totals[k] = totals.get(k, 0.0) + float(val)
    want = {k: v / len(ids) for k, v in totals.items()}
    assert set(got) == set(want) | {"HR", "NDCG"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert got["HR"] == got["HR@10"] and got["NDCG"] == got["NDCG@10"]
    assert 0.0 <= got["NDCG@20"] <= got["HR@20"] <= 1.0


def test_recommender_recommend(env):
    bundle, *_, tp = env
    rec = Recommender(_cfg(), bundle, tp, device="cpu")
    users = [0, 5, 11, 47]
    scores, items = rec.recommend(users, k=6)
    assert scores.shape == items.shape == (4, 6)
    assert torch.all(scores[:, :-1] >= scores[:, 1:])
    for b, u in enumerate(users):
        seen = set(bundle.sequences[u][-MCFG.pos_length:])
        assert not seen & set(items[b].tolist())
    # with seen items allowed, the top score is the full-catalog maximum
    s_all, _ = rec.recommend(users, k=6, exclude_seen=False)
    assert torch.all(s_all[:, 0] >= scores[:, 0])


def test_recommender_random_params_are_seeded(env):
    bundle = env[0]
    cfg = _cfg().replace(train=tcfg.TrainConfig(batch=16, test_size=9,
                                                 seed=5))
    a = Recommender(cfg, bundle, device="cpu")
    b = Recommender(cfg, bundle, device="cpu")
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    other = Recommender(_cfg(), bundle, device="cpu")
    assert not torch.equal(a.params["reg/u_embed"],
                           other.params["reg/u_embed"])
    fa, _ = a.encode()
    fb, _ = b.encode()
    assert torch.equal(fa, fb) and torch.isfinite(fa).all()


def test_recommender_rejects_bad_params(env):
    bundle, *_, tp = env
    bad = dict(tp)
    bad.pop("reg/pos_embed")
    with pytest.raises(ValueError, match="pos_embed"):
        Recommender(_cfg(), bundle, bad, device="cpu")


def test_recommender_defaults_to_cuda_and_raises_without_it(env,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Recommender(_cfg(), env[0], env[-1])


def test_cli_prints_one_json_line_per_user(tmp_path):
    from sagnn_tpu_torch.convert import save_npz
    from sagnn_tpu_torch.data.synthetic import synthetic_dataset
    from sagnn_tpu_torch.models.selfgnn import init_params

    cfg = tcfg.PRESETS["gowalla"].model
    # weights for the preset's shapes at the CLI's synthetic size
    full = init_params(torch.Generator().manual_seed(1), cfg, 40, 60)
    path = str(tmp_path / "w.npz")
    save_npz(path, full)
    env_ = dict(os.environ, JAX_PLATFORMS="cpu")
    cmd = [sys.executable, "-m", "sagnn_tpu_torch.serve", "--device", "cpu",
           "--synth_users", "40", "--synth_items", "60", "--users", "0",
           "3", "7", "--k", "5", "--params", path]
    out = subprocess.run(cmd, cwd=ROOT, env=env_, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert [x["user"] for x in lines] == [0, 3, 7]
    bundle = synthetic_dataset(num_users=40, num_items=60, graph_num=3,
                               test_size=1000, seed=100)
    for x in lines:
        assert len(x["items"]) == len(x["scores"]) == 5
        assert x["scores"] == sorted(x["scores"], reverse=True)
        assert not set(bundle.sequences[x["user"]]) & set(x["items"])
