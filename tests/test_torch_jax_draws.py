"""`Trainer(draws="jax")` against the JAX package's `Trainer` on one small
bundle (300 users × 256 items, g = 3, gnn_layer 2, latdim 16, keep_rate
0.5, SSL on): the same seed gives the same initial values bit for bit,
the same dropout masks (the LSTM's, unchunked and in fusion blocks with a
remainder; the edge dropout's on "xla" and, in the canonical order, on
"pallas"), and the same training, step for step.

Tolerances: the params and masks are the same bits. Four steps' loss
terms rtol 1e-5 and the params after them rtol 1e-4 / atol 1e-6, the
tolerances of tests/test_torch_import_tf1.py (JAX's step is one jitted
XLA program, the port's eager f32 ops, so sums round in another order);
the leaves with no gradient in exact arithmetic (`no_gradient`) move by
rounding noise alone and are held under one lr step. Under --bf16,
rtol 1e-2, tests/test_torch_bf16.py's Trainer tolerance, on the first
step's terms and the epoch's means: after the first update the two
packages' bf16 gradients round apart and single steps differ up to
1.0e-2.

JAX's masks for the mask tests come from jax.random along JAX's code
path (`_jax_draws`); the Trainer tests train through JAX's own draws and
so hold the whole chain. Each JAX Trainer run is a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sagnn_tpu.config import Config as JConfig
from sagnn_tpu.config import ModelConfig as JModelConfig
from sagnn_tpu.config import TrainConfig as JTrainConfig
from sagnn_tpu.data.graph import edge_weights_canonical
from sagnn_tpu.data.synthetic import synthetic_dataset as j_synth
from sagnn_tpu.train.trainer import Trainer as JTrainer
from sagnn_tpu_torch import config as tcfg
from sagnn_tpu_torch.convert import flatten_tree
from sagnn_tpu_torch.data.graph import direction_permutation
from sagnn_tpu_torch.data.synthetic import synthetic_dataset
from sagnn_tpu_torch.models.selfgnn import draw_jax_step_masks
from sagnn_tpu_torch.parallel.mesh import make_mesh
from sagnn_tpu_torch.train.trainer import Trainer

from tests.torch_port_helpers import no_gradient, numpy_tree, record_steps
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

BUNDLE = dict(num_users=300, num_items=256, graph_num=3, test_size=8,
              seed=3)
MODEL = dict(graph_num=3, gnn_layer=2, att_layer=1, latdim=16, num_heads=4,
             ssldim=8, pos_length=10, keep_rate=0.5, spmm_backend="xla")
TRAIN = dict(batch=64, trn_num=256, samp_num=4, ssl_num=3, test_size=8,
             lr=2e-3, reg=1e-2, ssl_reg=1e-3, seed=7)
STEPS = 4


def _configs(**model):
    m, t = dict(MODEL, **model), dict(TRAIN)
    return (JConfig(model=JModelConfig(**m), train=JTrainConfig(**t)),
            tcfg.Config(model=tcfg.ModelConfig(**m),
                        train=tcfg.TrainConfig(**t)))


def _jax_run(tmp, **model):
    jcfg, _ = _configs(**model)
    jtr = JTrainer(jcfg, j_synth(**BUNDLE), ckpt_root=str(tmp))
    init = flatten_tree(numpy_tree(jtr.state["params"]))
    steps = record_steps(jtr)
    jtr.train_epoch(verbose=False)
    stats = [{k: float(v) for k, v in s.items()} for s in steps]
    return init, stats, flatten_tree(numpy_tree(jtr.state["params"]))


# every draw in one compiled JAX step: the LSTM dropout in 128-row fusion
# blocks (300 users: two blocks and a remainder of 44) and edge dropout
F32 = dict(fusion_chunk_rows=128, edge_dropout_keep=0.8)


@pytest.fixture(scope="module")
def jax_f32(tmp_path_factory):
    return _jax_run(tmp_path_factory.mktemp("j32"), **F32)


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    return _jax_run(tmp_path_factory.mktemp("j16"), fusion_dtype="bf16",
                    stable_softmax=True)


def _trainer(tmp, mesh=None, **model):
    _, cfg = _configs(**model)
    return Trainer(cfg, synthetic_dataset(**BUNDLE), ckpt_root=str(tmp),
                   device="cpu", mesh=mesh, draws="jax")


def test_initial_params_are_jax_bits(jax_f32, tmp_path):
    want = jax_f32[0]
    got = _trainer(tmp_path).state["params"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].detach().numpy(), w,
                                      err_msg=k)


def _check_steps(tr, jax_run, rtol, atol_params):
    """Each step's loss terms at rtol (atol_params None: the first step's,
    then the epoch's means) and, given atol_params, the params after the
    epoch at rtol 1e-4."""
    tr.train_epoch(verbose=False)
    init, want, want_params = jax_run
    got = tr.step_stats
    assert len(got) == len(want) == STEPS
    terms = ("loss", "preLoss", "regLoss")
    for i, (g, w) in enumerate(zip(got, want)):
        if atol_params is None and i:
            break
        for k in terms:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol,
                                       err_msg=f"step {i} {k}")
    if atol_params is None:
        for k in terms:
            np.testing.assert_allclose(np.mean([g[k] for g in got]),
                                       np.mean([w[k] for w in want]),
                                       rtol=rtol, err_msg=f"mean {k}")
        return
    for k, w in want_params.items():
        got_k = tr.state["params"][k].detach().numpy()
        if no_gradient(k):
            # rounding noise that Adam scales up: held under one lr step
            for p in (got_k, w):
                assert np.abs(p - init[k]).max() < TRAIN["lr"], k
            continue
        np.testing.assert_allclose(got_k, w, rtol=1e-4, atol=atol_params,
                                   err_msg=k)


def test_steps_with_dropout_match_jax(jax_f32, tmp_path):
    _check_steps(_trainer(tmp_path, **F32), jax_f32, 1e-5, 1e-6)


def test_bf16_steps_with_dropout_match_jax(jax_bf16, tmp_path):
    _check_steps(_trainer(tmp_path, fusion_dtype="bf16",
                          stable_softmax=True), jax_bf16, 1e-2, None)


def _jax_draws(jcfg, key, shape, perm):
    """JAX's draws for one step key, each where JAX's code makes it: the
    edge dropout's key split off first (selfgnn.py:841-845) and split per
    direction (:555-559; "pallas" :524-529, over the canonical order), its
    weights w * m / keep (:268-271); the LSTM dropout's ku, ki (:599-601),
    whole or per fusion block with the block index folded in (:626-650,
    lstm.py:75-77). Returns (w_u, w_i in the i-direction's order, keep_u,
    keep_i)."""
    edge_w = None
    if jcfg.edge_dropout_keep < 1.0:
        key, drop = jax.random.split(key)
        ku, ki = jax.random.split(drop)
        keep = jcfg.edge_dropout_keep
        ones = jnp.ones((2, *shape), jnp.float32)
        if jcfg.spmm_backend == "pallas":
            ones = jnp.asarray(edge_weights_canonical(np.asarray(ones), perm))
        w_u, w_i = (ones[d] * jax.random.bernoulli(k, keep, shape)
                    .astype(jnp.float32) / keep for d, k in enumerate((ku, ki)))
        if jcfg.spmm_backend == "pallas":
            w_i = jnp.take_along_axis(w_i, jnp.asarray(perm), 1)
        edge_w = (np.asarray(w_u), np.asarray(w_i))
    ku, ki = jax.random.split(key)
    rows, tail = jcfg.fusion_chunk_rows, (jcfg.graph_num, jcfg.latdim)

    def mask(k, n):
        if rows <= 0 or n <= rows:
            return np.asarray(jax.random.bernoulli(k, jcfg.keep_rate,
                                                   (n, *tail)))
        return np.concatenate([
            np.asarray(jax.random.bernoulli(
                jax.random.fold_in(k, i), jcfg.keep_rate,
                (min(rows, n - lo), *tail)))
            for i, lo in enumerate(range(0, n, rows))])

    return edge_w, (mask(ku, 300), mask(ki, 256))


@pytest.mark.parametrize("model", [
    dict(),
    dict(fusion_chunk_rows=128),
    dict(edge_dropout_keep=0.8),
    dict(edge_dropout_keep=0.8, spmm_backend="pallas"),
], ids=["unchunked", "chunked", "edge_dropout", "edge_dropout_pallas"])
def test_step_masks_are_jax_masks(model, tmp_path):
    """One step's StepMasks against jax.random's draws from the step key
    JAX's Trainer splits off its seed's key (trainer.py:274, 289, 497).
    300 users in 128-row blocks leave a remainder block of 44; "pallas"
    draws the item-target edge mask in the user-target order."""
    jcfg, _ = _configs(**model)
    tr = _trainer(tmp_path, **model)
    rng = jax.random.split(jax.random.PRNGKey(TRAIN["seed"]))[0]
    key = jax.random.split(rng)[1]
    gb = tr.graph_blocks
    perm = direction_permutation(gb, tr.bundle.sub_mats)
    want_w, want_keep = _jax_draws(jcfg.model, key, gb.u_src.shape, perm)
    got = draw_jax_step_masks(tr.cfg.model, tr.graphs, 300, 256,
                              torch.from_numpy(np.asarray(key, np.int64)),
                              torch.device("cpu"))
    assert (got.edge_weights is None) == (want_w is None)
    for g, w in zip(got.edge_weights or (), want_w or ()):
        np.testing.assert_array_equal(g.numpy(), w)
    for g, w in zip(got.keep, want_keep):
        np.testing.assert_array_equal(g.numpy(), w)


def test_resume_replays_the_unbroken_run(tmp_path):
    """A Trainer restored from the checkpoint and rng.json written after
    its first epoch trains the second epoch bit for bit as the run that
    went on."""
    a = _trainer(tmp_path)
    a.train_epoch(verbose=False)
    rs = a.capture_rng_state(1)
    assert rs["jax_key"] == a.rng.tolist() and "dropout_gen" not in rs
    a._checkpoint(rs)
    b = _trainer(tmp_path)
    assert b.restore_checkpoint() == 1
    assert b.rng.tolist() == rs["jax_key"]
    a.train_epoch(verbose=False)
    b.train_epoch(verbose=False)
    assert a.step_stats == b.step_stats
    for k, v in a.state["params"].items():
        assert torch.equal(v, b.state["params"][k]), k
    with pytest.raises(ValueError, match="dropout_gen"):
        Trainer(_configs()[1], synthetic_dataset(**BUNDLE),
                ckpt_root=str(tmp_path), device="cpu").restore_rng_state(rs)


def test_the_ring_refuses_jax_draws_with_edge_dropout(tmp_path):
    """A mesh takes draws="jax" (tests/test_torch_jax_draws_mesh.py), but
    the ring refuses edge dropout for JAX's reason (its weights are
    bucketed on the host; sagnn_tpu/train/trainer.py:157-161)."""
    with pytest.raises(ValueError, match="needs the xla or pallas backend"):
        _trainer(tmp_path, mesh=make_mesh(model=2, devices=["cpu"] * 2),
                 spmm_backend="ring", edge_dropout_keep=0.8)


def test_chip_smoke_known_answers_are_jax(monkeypatch):
    """chip_smoke.py phase 27's known answers are jax.random's for the 131k
    recipe (seed 0): split(PRNGKey(0), 64), step 0's first LSTM dropout
    block, and every initial leaf that does not grow with the node counts
    (the user and item tables are drawn the same way from the split's
    first two keys; the card holds its u_embed draw to the CPU's)."""
    import chip_smoke
    import main as jmain
    from sagnn_tpu.models.selfgnn import init_params
    from sagnn_tpu_torch.utils.convergence import M131K_ARGV

    monkeypatch.setattr("sys.argv", ["main.py"] + M131K_ARGV)
    mc = jmain.build_config(jmain.parse_args()).model
    known = chip_smoke.JAX_KNOWN

    def answers():
        rng, init_key = jax.random.split(jax.random.PRNGKey(0))
        ku = jax.random.split(jax.random.split(rng)[1])[0]
        mask = jax.random.bernoulli(
            jax.random.fold_in(ku, 0), mc.keep_rate,
            (mc.fusion_chunk_rows, mc.graph_num, mc.latdim))
        return (jax.random.split(jax.random.PRNGKey(0), 64), mask,
                init_params(init_key, mc, 1, 1))

    split64, mask, params = jax.tree_util.tree_map(np.asarray,
                                                   jax.jit(answers)())
    digest = chip_smoke.digest
    assert digest(split64.astype("<u4")) == known["split64"]
    assert (digest(np.packbits(mask.ravel())), int(mask.sum())) \
        == known["mask_block0"]
    flat = flatten_tree(params)
    for key, v in flat.items():
        if key in ("reg/u_embed", "reg/i_embed"):
            continue
        if key not in known["init"]:
            assert np.all(v == (1.0 if key.endswith("/scale") else 0.0)), key
            continue
        f = v.reshape(-1)
        sha, total, entries = known["init"][key]
        assert digest(v.astype("<f4")) == sha, key
        assert (float(f[0]), float(f[f.size // 2]), float(f[-1])) == entries
        assert np.isclose(v.astype(np.float64).sum(), total, rtol=1e-12,
                          atol=0), key
