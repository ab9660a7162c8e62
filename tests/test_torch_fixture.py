"""The port's serving path against the EXECUTED TF1 reference.

tests/fixtures/tf_reference_tiny.npz holds the reference's weights and its
test-batch candidate scores and HR/NDCG sums (see tests/test_tf_fixture.py).
The weights go through the JAX package's TF1 name mapping, then
`convert.params_from_numpy` into the port; the port's candidate scores and
metrics must reproduce the reference's at test_tf_fixture.py's tolerances
(scores rtol 1e-4, atol 1e-5; HR exact, NDCG rtol 1e-6).
"""

import json
import os

import numpy as np
import pytest
import torch

from sagnn_tpu.config import ModelConfig
from sagnn_tpu.data.synthetic import synthetic_dataset
from sagnn_tpu.train.import_tf1 import map_reference_params, npz_getter
from sagnn_tpu_torch import config as tcfg
from sagnn_tpu_torch.convert import params_from_numpy
from sagnn_tpu_torch.data.graph import compile_interval_graphs
from sagnn_tpu_torch.models.selfgnn import SelfGNN, graphs_to_device
from sagnn_tpu_torch.train.metrics import topk_metrics

from tests.torch_port_helpers import numpy_tree
from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "tf_reference_tiny.npz")


def build_model_cfg(cfg) -> ModelConfig:
    """The fixture's reference flags as the JAX ModelConfig (as in
    tests/test_tf_fixture.py)."""
    return ModelConfig(
        graph_num=int(cfg["graphNum"]), gnn_layer=int(cfg["gnn_layer"]),
        att_layer=int(cfg["att_layer"]), latdim=int(cfg["latdim"]),
        num_heads=int(cfg["num_attention_heads"]),
        ssldim=int(cfg["ssldim"]), pos_length=int(cfg["pos_length"]),
        leaky=float(cfg["leaky"]), keep_rate=1.0)


@pytest.fixture(scope="module")
def fx():
    z = np.load(FIXTURE)
    cfg = json.loads(bytes(z["cfg/json"]).decode())
    jcfg = build_model_cfg(cfg)
    params = params_from_numpy(numpy_tree(
        map_reference_params(npz_getter(z), jcfg)))
    bundle = synthetic_dataset(num_users=cfg["num_users"],
                               num_items=cfg["num_items"],
                               graph_num=jcfg.graph_num, test_size=8,
                               seed=cfg["bundle_seed"])
    graphs = graphs_to_device(
        compile_interval_graphs(bundle.sub_mats, pad_multiple=8), "cpu")
    return z, jcfg, params, bundle, graphs


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_candidate_scores_and_metrics_match_reference(fx, backend):
    z, jcfg, params, bundle, graphs = fx
    mcfg = tcfg.ModelConfig(**{**jcfg.__dict__, "spmm_backend": backend})
    model = SelfGNN(mcfg, bundle.num_users, bundle.num_items)
    fu, fi, _, _ = model.encode(params, graphs)

    def t(name):
        return torch.from_numpy(z[name])

    scores = model.score_with_encodings(params, fu, fi, t("tst/user_ids"),
                                        t("tst/cands"), t("tst/sequence"),
                                        t("tst/mask"))
    np.testing.assert_allclose(scores.numpy(), z["tst/preds"], rtol=1e-4,
                               atol=1e-5)
    assert np.array_equal(z["tst/cands"][:, -1], z["tst/pos"])
    m = topk_metrics(scores, ks=(5, 10, 20))
    hit, ndcg, hit5, ndcg5, hit20, ndcg20 = z["tst/metrics"]
    np.testing.assert_allclose(float(m["HR@10"]), hit, atol=1e-9)
    np.testing.assert_allclose(float(m["NDCG@10"]), ndcg, rtol=1e-6)
    np.testing.assert_allclose(float(m["HR@5"]), hit5, atol=1e-9)
    np.testing.assert_allclose(float(m["NDCG@5"]), ndcg5, rtol=1e-6)
    np.testing.assert_allclose(float(m["HR@20"]), hit20, atol=1e-9)
    np.testing.assert_allclose(float(m["NDCG@20"]), ndcg20, rtol=1e-6)


def test_interval_lstm_and_norm_match_reference(fx):
    """The captured dynamic_rnn and interval layer-norm outputs match the
    port's propagation + lstm_scan + layer_norm."""
    from sagnn_tpu_torch.models.selfgnn import _interval_propagation, sub
    from sagnn_tpu_torch.ops.attention import layer_norm
    from sagnn_tpu_torch.ops.lstm import lstm_scan

    z, jcfg, params, bundle, graphs = fx
    mcfg = tcfg.ModelConfig(**jcfg.__dict__)
    uv, iv = _interval_propagation(params, graphs, mcfg, bundle.num_users,
                                   bundle.num_items)
    lstm = sub(params, "free/lstm")
    for vec, rec, ln, ln_key in ((uv, "rec/dynamic_rnn_0", "free/ln_user",
                                  "rec/LayerNorm"),
                                 (iv, "rec/dynamic_rnn_1", "free/ln_item",
                                  "rec/LayerNorm_1")):
        out = lstm_scan(lstm, vec.transpose(0, 1))
        np.testing.assert_allclose(out.numpy(), z[rec], rtol=1e-4,
                                   atol=1e-5)
        p = sub(params, ln)
        normed = layer_norm(out, p["scale"], p["shift"])
        np.testing.assert_allclose(normed.numpy(), z[ln_key], rtol=1e-4,
                                   atol=1e-5)
