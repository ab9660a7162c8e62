"""`Trainer(mesh=..., draws="jax")` against the JAX package's own mesh
`Trainer` (its GSPMD step on the 8-device CPU platform of
tests/conftest.py, "pallas" in interpret mode) on tests/test_trainer_mesh.py's
configuration at 48 users x 64 items with keep_rate 0.5 (both Trainers pad
the interval graphs' edges to their default multiple of 512, so both draw
the edge masks at the same [g, E]): the same seed gives the same initial
values bit for bit on every mesh, and the same training, step for step,
with the LSTM dropout and, on "xla" and "pallas", edge dropout at keep 0.8:
"xla" and "pallas" on 2 x 2 and 4 x 1 (the "xla" runs with
fusion_chunk_rows 32, so the 48 users' masks come from JAX's global fusion
blocks, a remainder block of 16 among them, while each model rank of 2 x 2
holds 24 rows), the ring on 1 x 2 and 2 x 2 (the LSTM dropout alone; edge
dropout is refused there, as JAX refuses it), seq_parallel (ring attention
over each data rank's model row) and the bf16 stack on 2 x 2. A draws="jax" checkpoint written on 2 x 2 resumes on
4 x 1 and on one device onto the uninterrupted run, and the CLI trains on a
mesh with `--draws jax`.

Tolerances are tests/test_torch_jax_draws.py's: the params the same bits;
four steps' loss terms rtol 1e-5 and the params after them rtol 1e-4 /
atol 1e-6, the leaves with no gradient in exact arithmetic held under one
lr step; the bf16 stack rtol 1e-2 on the first step's terms and the four
steps' means (tests/test_torch_bf16.py's Trainer tolerance). Each JAX
Trainer runs once per module (`_jax_run`'s cache): its set-up and step
compile take 12-17 s apiece on the CPU.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from sagnn_tpu.config import Config as JConfig
from sagnn_tpu.config import ModelConfig as JModelConfig
from sagnn_tpu.config import TrainConfig as JTrainConfig
from sagnn_tpu.data.synthetic import synthetic_dataset as j_synth
from sagnn_tpu.parallel.mesh import make_mesh as j_make_mesh
from sagnn_tpu.train.trainer import Trainer as JTrainer
from sagnn_tpu_torch import config as tcfg
from sagnn_tpu_torch.convert import flatten_tree
from sagnn_tpu_torch.data.synthetic import synthetic_dataset
from sagnn_tpu_torch.parallel.mesh import make_mesh
from sagnn_tpu_torch.train.trainer import Trainer

from tests.torch_port_helpers import no_gradient, numpy_tree, record_steps
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

BUNDLE = dict(num_users=48, num_items=64, graph_num=2, test_size=10, seed=2)
MODEL = dict(graph_num=2, gnn_layer=1, att_layer=1, latdim=16, num_heads=4,
             ssldim=8, pos_length=16, keep_rate=0.5)
# reg and ssl_reg as tests/test_torch_mesh_options.py and
# tests/test_torch_jax_draws.py set them: at the default reg 1e-5 the
# gradient of a table row outside the batch sits at the step's f32
# rounding floor (1e-7-1e-5 against a largest |g| of 1.8), and four Adam
# steps, which scale each gradient by its own history, move such an
# element by rounding alone: one u_embed element of the ring on 2 x 2 ended
# 1.0e-5 (2.4e-4 relative) from JAX's, where the port's own 1 x 2 and
# 2 x 2 runs, which sum the batch's gradient in another order, part by
# 7.2e-6. With reg 1e-2 the weight decay keeps every element's gradient
# well above that floor.
TRAIN = dict(batch=16, samp_num=4, ssl_num=2, trn_num=32, test_size=10,
             lr=5e-3, reg=1e-2, ssl_reg=1e-3)
EPOCHS = 2          # of 2 steps each
# each JAX run: its backend and options; the ring draws the LSTM dropout
# alone
RUNS = {
    "xla": dict(spmm_backend="xla", edge_dropout_keep=0.8,
                fusion_chunk_rows=32),
    "pallas": dict(spmm_backend="pallas", edge_dropout_keep=0.8),
    "ring": dict(spmm_backend="ring"),
    "seq_parallel": dict(spmm_backend="xla", per_token_seq_attention=True,
                         seq_parallel=True),
    "bf16": dict(spmm_backend="xla", fusion_dtype="bf16",
                 stable_softmax=True),
}
F32_CASES = [("xla", (2, 2)), ("xla", (4, 1)), ("pallas", (2, 2)),
             ("pallas", (4, 1)), ("ring", (1, 2)), ("ring", (2, 2))]


def _ids(cases):
    return [f"{run}-{d}x{m}" for run, (d, m) in cases]


def _configs(run):
    m, t = dict(MODEL, **RUNS[run]), dict(TRAIN)
    return (JConfig(model=JModelConfig(**m), train=JTrainConfig(**t)),
            tcfg.Config(model=tcfg.ModelConfig(**m),
                        train=tcfg.TrainConfig(**t)))


@functools.lru_cache(maxsize=None)
def _jax_run(run, shape):
    """JAX's mesh Trainer of `run` on a `shape` mesh of the CPU devices:
    (its initial params, each step's stats, its params after EPOCHS
    epochs, flattened to the port's keys, and its key after them)."""
    import tempfile
    jcfg, _ = _configs(run)
    mesh = j_make_mesh(data=shape[0], model=shape[1],
                       devices=jax.devices()[:shape[0] * shape[1]])
    with tempfile.TemporaryDirectory() as root:
        jtr = JTrainer(jcfg, j_synth(**BUNDLE), ckpt_root=root, mesh=mesh)
        init = flatten_tree(numpy_tree(jtr.state["params"]))
        steps = record_steps(jtr)
        for _ in range(EPOCHS):
            jtr.train_epoch(verbose=False)
        stats = [{k: float(v) for k, v in s.items()} for s in steps]
        return (init, stats, flatten_tree(numpy_tree(jtr.state["params"])),
                np.asarray(jtr.rng).tolist())


def cpu_mesh(data, model):
    return make_mesh(data=data, model=model, devices=["cpu"] * (data * model))


def _trainer(tmp, run, shape=None, **kw):
    _, cfg = _configs(run)
    return Trainer(cfg, synthetic_dataset(**BUNDLE), ckpt_root=str(tmp),
                   device="cpu", mesh=None if shape is None
                   else cpu_mesh(*shape), draws="jax", **kw)


def _train(tr, epochs=EPOCHS):
    stats = []
    for _ in range(epochs):
        tr.train_epoch(verbose=False)
        stats += tr.step_stats
    return stats


@pytest.mark.parametrize("run,shape", [
    ("xla", (2, 2)), ("xla", (4, 1)), ("pallas", (2, 2)), ("pallas", (4, 1))],
    ids=_ids([("xla", (2, 2)), ("xla", (4, 1)), ("pallas", (2, 2)),
              ("pallas", (4, 1))]))
def test_initial_values_are_the_jax_mesh_trainers(run, shape, tmp_path):
    """Every leaf, gathered from the mesh, is JAX's mesh Trainer's, bit for
    bit; the replicas of every data rank hold the same bits."""
    want = _jax_run(run, shape)[0]
    tr = _trainer(tmp_path, run, shape)
    got = tr.state["params"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].detach().numpy(), w,
                                      err_msg=k)
    st = tr.mesh_state
    for d in range(1, shape[0]):
        for k, shards in st.params[d].items():
            for a, b in zip(shards, st.params[0][k]):
                assert torch.equal(a, b), (d, k)


def _check_steps(got, jax_run, rtol, params=None, pooled_seq=True):
    """Each step's loss terms at rtol and, given the port's params after
    them, the params at rtol 1e-4 / atol 1e-6 (tests/test_torch_jax_draws
    .py's `_check_steps`); without params (the bf16 stack) the first
    step's terms and the steps' means at rtol. `pooled_seq`: as
    `no_gradient`'s."""
    init, want, want_params, _ = jax_run
    assert len(got) == len(want) == 2 * EPOCHS
    terms = ("loss", "preLoss", "regLoss")
    for i, (g, w) in enumerate(zip(got, want)):
        if params is None and i:
            break
        for k in terms:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol,
                                       err_msg=f"step {i} {k}")
    if params is None:
        for k in terms:
            np.testing.assert_allclose(np.mean([g[k] for g in got]),
                                       np.mean([w[k] for w in want]),
                                       rtol=rtol, err_msg=f"mean {k}")
        return
    for k, w in want_params.items():
        got_k = params[k].detach().numpy()
        if no_gradient(k, pooled_seq):
            # rounding noise that Adam scales up: held under one lr step
            for p in (got_k, w):
                assert np.abs(p - init[k]).max() < TRAIN["lr"], k
            continue
        np.testing.assert_allclose(got_k, w, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("run,shape", F32_CASES, ids=_ids(F32_CASES))
def test_steps_with_dropout_match_the_jax_mesh_trainer(run, shape,
                                                       tmp_path):
    tr = _trainer(tmp_path, run, shape)
    _check_steps(_train(tr), _jax_run(run, shape), 1e-5,
                 tr.state["params"])


def test_bf16_steps_with_dropout_match_the_jax_mesh_trainer(tmp_path):
    tr = _trainer(tmp_path, "bf16", (2, 2))
    _check_steps(_train(tr), _jax_run("bf16", (2, 2)), 1e-2)


@pytest.mark.parametrize("shape", [(4, 1), None], ids=["4x1", "one_device"])
def test_a_2x2_checkpoint_resumes_onto_the_unbroken_run(shape, tmp_path):
    """The checkpoint and rng.json ("jax_key") of a 2 x 2 run after its
    first epoch, restored on `shape`, train the second epoch to the 2 x 2
    run's losses (and JAX's) within rtol 1e-5."""
    a = _trainer(tmp_path, "xla", (2, 2))
    a.train_epoch(verbose=False)
    rs = a.capture_rng_state(1)
    assert rs["jax_key"] == a.rng.tolist() and "dropout_gen" not in rs
    a.ckpt.save(a.state, a.history, a.cfg, rng_state=rs)
    b = _trainer(tmp_path, "xla", shape)
    assert b.restore_checkpoint() == 1
    assert b.rng.tolist() == rs["jax_key"]
    for k, v in a.state["params"].items():
        assert torch.equal(b.state["params"][k], v), k
    want = _train(a, 1)
    got = _train(b, 1)
    jax_steps = _jax_run("xla", (2, 2))[1][len(want):]
    for g, w, j in zip(got, want, jax_steps):
        for k in ("loss", "preLoss", "regLoss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(g[k], j[k], rtol=1e-5, err_msg=k)


def test_cli_trains_a_mesh_with_jax_draws(tmp_path, capsys):
    """`main --draws jax --mesh_data 2 --mesh_model 2 --device cpu` trains
    an epoch with dropout on; its rng.json holds JAX's key."""
    from sagnn_tpu_torch import main as cli
    cli.main(["--data", "synthetic", "--device", "cpu", "--synth_users",
              "48", "--synth_items", "64", "--graphNum", "2", "--epoch", "1",
              "--trnNum", "32", "--batch", "16", "--testSize", "8",
              "--sslNum", "2", "--sampNum", "4", "--latdim", "16",
              "--num_attention_heads", "4", "--ssldim", "8", "--pos_length",
              "10", "--att_layer", "1", "--tstEpoch", "1", "--keepRate",
              "0.5", "--edge_dropout_keep", "0.8", "--spmm_backend", "xla",
              "--draws", "jax", "--mesh_data", "2", "--mesh_model", "2",
              "--ckpt_root", str(tmp_path), "--save_path", "jm"])
    out = capsys.readouterr().out
    assert "Mesh: data=2 model=2" in out
    assert "Epoch 0/1, Train: Loss = " in out and ", max: " in out
    with open(os.path.join(tmp_path, "jm", "rng.json")) as f:
        rs = json.load(f)
    assert len(rs["jax_key"]) == 2 and "dropout_gen" not in rs


def test_the_mesh_step_takes_the_masks_it_is_given(tmp_path):
    """Trainer.train_step on a mesh draws the step's masks from the key it
    splits off, as one device does: the same key's masks handed to the
    mesh step give the same losses, bit for bit."""
    from sagnn_tpu_torch.models.selfgnn import draw_jax_step_masks
    from sagnn_tpu_torch.utils import jax_random
    tr = _trainer(tmp_path, "pallas", (2, 2))
    ids = tr.sampler.epoch_user_ids(TRAIN["trn_num"])
    batch = tr.sampler.train_batch(ids[:TRAIN["batch"]])
    key = jax_random.split(tr.rng)[1]
    masks = draw_jax_step_masks(tr.cfg.model, tr._mesh_step.mask_graphs, 48,
                                64, key, tr.device)
    assert masks.edge_weights is not None and masks.keep is not None
    want, _ = tr._mesh_step.loss_and_grads(tr.mesh_state, batch,
                                           masks=masks)
    got = tr.train_step(batch)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_seq_parallel_steps_match_the_jax_mesh_trainer(tmp_path):
    """seq_parallel on 2 x 2 (ring attention over each data rank's model
    row) with draws="jax" against JAX's seq_parallel mesh Trainer: the
    sequence branch, its ring attention and the evaluation draw nothing,
    so the Trainer splits one key a step off its key and ends on JAX's."""
    tr = _trainer(tmp_path, "seq_parallel", (2, 2))
    jax_run = _jax_run("seq_parallel", (2, 2))
    _check_steps(_train(tr), jax_run, 1e-5, tr.state["params"],
                 pooled_seq=False)
    tr.test_epoch()
    assert tr.rng.tolist() == jax_run[3]
