"""`Trainer(mesh=...)` over data x model meshes of CPU ranks; the
counterparts of tests/test_trainer_mesh.py: training and evaluation on
(4, 2) and (8, 1) on both backends, the ring on (2, 4), imported weights
landing in the shardings, checkpoints restored across mesh shapes and
onto a Trainer without a mesh, the options a tensor-parallel mesh takes
(ROADMAP A6(e)), and the CLI's mesh flags. The configuration and the
48 x 64 bundle are JAX's test's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sagnn_tpu_torch import config as tcfg
from sagnn_tpu_torch.data.synthetic import synthetic_dataset
from sagnn_tpu_torch.parallel.mesh import make_mesh
from sagnn_tpu_torch.train.trainer import Trainer

from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

CFG = tcfg.Config(
    model=tcfg.ModelConfig(graph_num=2, gnn_layer=1, att_layer=1, latdim=16,
                           num_heads=4, ssldim=8, pos_length=16,
                           keep_rate=1.0, spmm_backend="pallas"),
    train=tcfg.TrainConfig(batch=16, samp_num=4, ssl_num=2, trn_num=32,
                           test_size=10, lr=5e-3))


def bundle():
    return synthetic_dataset(num_users=48, num_items=64, graph_num=2,
                             test_size=10, seed=2)


def cpu_mesh(data, model):
    return make_mesh(data=data, model=model, devices=["cpu"] * (data * model))


def with_model(cfg, **kw):
    return cfg.replace(model=dataclasses.replace(cfg.model, **kw))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_mesh_trainer_trains_and_evals(tmp_path, shape, backend):
    tr = Trainer(with_model(CFG, spmm_backend=backend), bundle(),
                 ckpt_root=str(tmp_path), mesh=cpu_mesh(*shape))
    # the tables split over 'model' on every data rank's row
    st = tr.mesh_state
    assert st.specs["reg/u_embed"] == (None, "model", None)
    assert len(st.params) == shape[0]
    assert [s.shape[1] for s in st.params[0]["reg/u_embed"]] == \
        [48 // shape[1]] * shape[1]
    first = tr.train_epoch(verbose=False)
    for _ in range(3):
        last = tr.train_epoch(verbose=False)
    assert last["preLoss"] < first["preLoss"]
    assert tr.state["step"] == 4 * 2
    for full_sort in (False, True):
        mets = tr.test_epoch(full_sort=full_sort)
        assert 0.0 <= mets["HR"] <= 1.0 and 0.0 <= mets["NDCG"] <= 1.0


@pytest.mark.parametrize("edge_norm", [None, "mean"])
def test_mesh_trainer_ring_backend(tmp_path, edge_norm):
    """spmm_backend="ring" on a 2 x 4 mesh: one ring per data rank, each
    over its model row; the loss falls (lr 2e-2 with 'mean', as JAX's
    test)."""
    cfg = with_model(CFG, spmm_backend="ring", edge_norm=edge_norm)
    if edge_norm == "mean":
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, lr=2e-2))
    tr = Trainer(cfg, bundle(), ckpt_root=str(tmp_path),
                 mesh=cpu_mesh(2, 4))
    assert len(tr.mesh_state.params) == 2
    first = tr.train_epoch(verbose=False)
    for _ in range(3):
        last = tr.train_epoch(verbose=False)
    assert last["preLoss"] < first["preLoss"]
    assert 0.0 <= tr.test_epoch()["HR"] <= 1.0


def test_mesh_load_imported_params(tmp_path):
    """Imported weights, moments and step land in the shardings of a 4 x 2
    mesh, on every data rank, and the mesh step continues from them."""
    tr = Trainer(CFG, bundle(), ckpt_root=str(tmp_path),
                 mesh=cpu_mesh(4, 2))
    rng = np.random.default_rng(0)
    host = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape))
                                .astype(np.float32))
            for k, v in tr.state["params"].items()}
    mu = {k: 0.1 * v for k, v in host.items()}
    nu = {k: v.abs() + 0.5 for k, v in host.items()}
    tr.load_imported_params(host, mu=mu, nu=nu, step=11)
    st = tr.mesh_state
    assert st.count == 11 and st.step == 11
    for d in range(4):
        for m, (lo, hi) in enumerate([(0, 24), (24, 48)]):
            assert torch.equal(st.params[d]["reg/u_embed"][m],
                               host["reg/u_embed"][:, lo:hi])
            assert torch.equal(st.mu[d]["reg/u_embed"][m],
                               mu["reg/u_embed"][:, lo:hi])
        assert torch.equal(st.nu[d]["reg/meta2_w"][0], nu["reg/meta2_w"])
    tr.train_epoch(verbose=False)
    assert tr.state["step"] == 11 + CFG.train.trn_num // CFG.train.batch
    assert tr.state["opt_state"].count == tr.state["step"]


def test_checkpoint_cross_mesh_restore(tmp_path):
    """A state saved from a 4 x 2 mesh (gathered into the single-device
    format) restores onto an 8 x 1 mesh and onto a "pallas" Trainer
    without a mesh, and a single-device state back onto the 4 x 2 mesh,
    with the same params and the same evaluation; each keeps training."""
    b = bundle()
    tr_a = Trainer(CFG, b, ckpt_root=str(tmp_path), mesh=cpu_mesh(4, 2))
    tr_a.train_epoch(verbose=False)
    mets_a = tr_a.test_epoch()
    tr_a.ckpt.save(tr_a.state, tr_a.history, tr_a.cfg)
    blob = torch.load(str(tmp_path / "tem" / "state"), weights_only=True)
    assert blob["params"]["reg/u_embed"].shape == (2, 48, 16)

    want = tr_a.state["params"]
    for kw in ({"mesh": cpu_mesh(8, 1)}, {"device": "cpu"}):
        tr_b = Trainer(CFG, b, ckpt_root=str(tmp_path), **kw)
        state, _ = tr_b.ckpt.restore(tr_b.state)
        tr_b.state = state
        for k, v in want.items():
            assert torch.equal(tr_b.state["params"][k], v), k
        assert tr_b.state["step"] == tr_a.state["step"]
        assert tr_b.test_epoch()["NDCG"] == pytest.approx(mets_a["NDCG"],
                                                          rel=1e-5)
        assert np.isfinite(tr_b.train_epoch(verbose=False)["Loss"])
    # and back: the single-device Trainer's state onto the 4 x 2 mesh
    tr_c = Trainer(CFG, b, ckpt_root=str(tmp_path), mesh=cpu_mesh(4, 2))
    tr_c.state = tr_b.state
    for k, v in tr_b.state["params"].items():
        assert torch.equal(tr_c.state["params"][k], v), k
    assert tr_c.test_epoch()["NDCG"] == pytest.approx(
        tr_b.test_epoch()["NDCG"], rel=1e-5)


def test_mesh_epoch_matches_single_device(tmp_path):
    """A 2 x 2 mesh Trainer's epoch (sampling, the step, evaluation) at
    keepRate 0.5 against the single-device Trainer's on the same seeds:
    losses and metrics rtol 1e-5."""
    cfg = with_model(CFG, keep_rate=0.5)
    one = Trainer(cfg, bundle(), ckpt_root=str(tmp_path / "a"),
                  device="cpu")
    mesh = Trainer(cfg, bundle(), ckpt_root=str(tmp_path / "b"),
                   mesh=cpu_mesh(2, 2))
    for tr in (one, mesh):
        tr.out = tr.train_epoch(verbose=False)
        tr.mets = tr.test_epoch(full_sort=True)
    for k in ("Loss", "preLoss"):
        assert mesh.out[k] == pytest.approx(one.out[k], rel=1e-5)
    for k in ("HR", "NDCG"):
        assert mesh.mets[k] == pytest.approx(one.mets[k], rel=1e-5)


@pytest.mark.parametrize("option", [
    {"edge_attention": True}, {"spmm_src_shard_rows": 16},
    {"remat_propagation": True}, {"fusion_chunk_rows": 8},
    {"fusion_dtype": "bf16"}])
def test_mesh_refuses_options_not_ported(tmp_path, option):
    """The options a mesh of more than one model rank once refused (ROADMAP
    A6(e)) now train on it: on 1 x 2 and 2 x 2 (the tables split over the
    model ranks) an epoch at keepRate 0.5 gives the single-device
    Trainer's losses from the same seeds (rtol 1e-5; the bf16 stack rtol
    1e-2, tests/test_torch_bf16.py's, since each data rank rounds its own
    cotangents), and the evaluation runs; with one model rank the data
    ranks run the single-device encode."""
    cfg = with_model(CFG, keep_rate=0.5, **option)
    one = Trainer(cfg, bundle(), ckpt_root=str(tmp_path / "one"),
                  device="cpu")
    want = one.train_epoch(verbose=False)
    rtol = 1e-2 if "fusion_dtype" in option else 1e-5
    for shape in ((1, 2), (2, 2)):
        tr = Trainer(cfg, bundle(), ckpt_root=str(tmp_path / str(shape)),
                     mesh=cpu_mesh(*shape))
        assert not tr._mesh_step.whole
        got = tr.train_epoch(verbose=False)
        for k in ("Loss", "preLoss"):
            assert got[k] == pytest.approx(want[k], rel=rtol), (shape, k)
        assert 0.0 <= tr.test_epoch()["HR"] <= 1.0
    for shape in ((1, 1), (2, 1)):
        tr = Trainer(cfg, bundle(), ckpt_root=str(tmp_path),
                     mesh=cpu_mesh(*shape))
        assert tr._mesh_step.whole


def test_mesh_batch_must_split(tmp_path):
    with pytest.raises(ValueError, match="does not split"):
        Trainer(CFG, bundle(), ckpt_root=str(tmp_path), mesh=cpu_mesh(3, 1))


def test_cli_trains_on_a_mesh(tmp_path, capsys):
    """`main --mesh_data 2 --mesh_model 2 --spmm_backend pallas --device
    cpu` trains, evaluates and checkpoints on CPU ranks."""
    from sagnn_tpu_torch import main as cli
    cli.main(["--data", "synthetic", "--device", "cpu", "--spmm_backend",
              "pallas", "--mesh_data", "2", "--mesh_model", "2",
              "--synth_users", "48", "--synth_items", "64", "--graphNum",
              "2", "--epoch", "1", "--trnNum", "32", "--batch", "16",
              "--testSize", "10", "--sslNum", "2", "--sampNum", "4",
              "--latdim", "16", "--num_attention_heads", "4", "--tstEpoch",
              "1", "--ckpt_root", str(tmp_path)])
    out = capsys.readouterr().out
    assert "Mesh: data=2 model=2" in out and "max" in out
    assert (tmp_path / "tem" / "state").exists()
