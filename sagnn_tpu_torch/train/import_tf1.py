"""Import the reference's tf.train.Saver checkpoints into the port; the
port of `sagnn_tpu/train/import_tf1.py`.

The reference persists trained models with a TF1 Saver (ref
model.py:512-520, ``saveHistory`` -> ``Models/<save_path>``). Users
migrating from it bring those weights, and optionally the Adam moments and
the global step, into the port without retraining:
``import_tf1_checkpoint`` reads the V1 checkpoint (through TF2's compat
reader) and returns the port's flat parameter dict (`convert.py`'s
layout: "reg/u_embed", "free/seq_mhsa/0/wq", ...);
``Trainer.load_imported_params`` installs it.

Variable names in the TF1.14 reference graph, in creation order:

  - ``NNLayers.defineParam`` (tf.get_variable at root scope,
    Utils/NNLayers.py:43-61): ``uEmbed`` [g,U,D], ``iEmbed`` [g,I,D],
    ``posEmbed``, ``timeEmbed`` (model.py:108-117), then one unnamed FC
    kernel per messagePropagate call -> ``defaultParamName1`` ..
    ``defaultParamName{2*g*gnn_layer}`` (model.py:81, quirk Q6; the
    counter in NNLayers.py:12-15 starts at 1), then the meta network
    ``meta2``/``meta2Bias``/``meta3``/``meta3Bias`` (model.py:180-182;
    Bias appends the literal suffix, NNLayers.py:117-124).
  - The shared LSTM (model.py:135-146, quirk Q4):
    ``tf.nn.dynamic_rnn(MultiRNNCell([DropoutWrapper(BasicLSTMCell)]))``
    under ``tf.name_scope("rnn")`` -> variables
    ``rnn/multi_rnn_cell/cell_0/basic_lstm_cell/{kernel,bias}``; the second
    dynamic_rnn call reuses the same cell objects, so there is exactly one
    kernel/bias pair.
  - ``tf.layers.dense`` inside MultiHeadSelfAttention (attention.py:66-72):
    ``dense``, ``dense_1``, ... globally in creation order: 0-2 the user
    interval-MHSA Q/K/V, 3-5 the item interval-MHSA, then 3 per sequence
    attention layer (6+3i .. 8+3i) (model.py:150-166).
  - ``tf.contrib.layers.layer_norm``: ``LayerNorm``, ``LayerNorm_1``, ...:
    0 user intervals, 1 item intervals, 2 pooled-seq item, 3 pooled-seq
    positional, then 4+i per sequence layer (model.py:152-165).
  - Adam slots (tf.train.AdamOptimizer, model.py:246-250): ``<name>/Adam``
    (first moment) and ``<name>/Adam_1`` (second moment), plus
    ``beta1_power``/``beta2_power``; the LR-schedule global step is the
    unnamed ``tf.Variable(0)`` saved as ``Variable``.

`tensorflow` is needed only to read a checkpoint, and is imported there;
`npz_getter` reads the captured fixture (tests/fixtures/
tf_reference_tiny.npz) without it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from sagnn_tpu_torch.config import ModelConfig

Getter = Callable[[str], np.ndarray]
Params = Dict[str, torch.Tensor]

# canonical alias for the single shared LSTM cell; the getters resolve it
# to whatever the producing graph called it (genuine TF1: the
# rnn/multi_rnn_cell/... path; the fixture's capture shim:
# shim_basic_lstm_cell_0)
LSTM_KERNEL = "lstm/kernel"
LSTM_BIAS = "lstm/bias"
_TF1_LSTM_SUFFIX = "basic_lstm_cell"


def _dense(i: int) -> str:
    return "dense" if i == 0 else f"dense_{i}"


def _layer_norm(i: int) -> str:
    return "LayerNorm" if i == 0 else f"LayerNorm_{i}"


def map_reference_params(get: Getter, cfg: ModelConfig) -> Params:
    """The port's flat f32 parameter dict from reference variables.

    `get` maps a canonical reference variable name (e.g. "uEmbed",
    "dense_3/kernel", "LayerNorm_1/gamma", LSTM_KERNEL) to its array."""
    n_prop = cfg.graph_num * cfg.gnn_layer * 2

    def arr(name: str) -> torch.Tensor:
        return torch.from_numpy(np.array(get(name), dtype=np.float32))

    out = {
        "reg/u_embed": arr("uEmbed"),
        "reg/i_embed": arr("iEmbed"),
        "reg/pos_embed": arr("posEmbed"),
        "reg/time_embed": arr("timeEmbed"),
        "reg/time_fc": torch.stack([arr(f"defaultParamName{i + 1}")
                                    for i in range(n_prop)]),
        "reg/meta2_w": arr("meta2"),
        "reg/meta3_w": arr("meta3"),
        "free/lstm/kernel": arr(LSTM_KERNEL),
        "free/lstm/bias": arr(LSTM_BIAS),
    }

    def mhsa(prefix: str, i0: int) -> None:
        for j, (w, b) in enumerate((("wq", "bq"), ("wk", "bk"),
                                    ("wv", "bv"))):
            out[f"{prefix}/{w}"] = arr(f"{_dense(i0 + j)}/kernel")
            out[f"{prefix}/{b}"] = arr(f"{_dense(i0 + j)}/bias")

    def ln(prefix: str, i: int) -> None:
        out[f"{prefix}/scale"] = arr(f"{_layer_norm(i)}/gamma")
        out[f"{prefix}/shift"] = arr(f"{_layer_norm(i)}/beta")

    mhsa("free/mhsa_user", 0)
    mhsa("free/mhsa_item", 3)
    ln("free/ln_user", 0)
    ln("free/ln_item", 1)
    ln("free/seq_ln_item", 2)
    ln("free/seq_ln_pos", 3)
    for i in range(cfg.att_layer):
        mhsa(f"free/seq_mhsa/{i}", 6 + 3 * i)
        ln(f"free/seq_ln/{i}", 4 + i)
    out["free/meta2_b"] = arr("meta2Bias")
    out["free/meta3_b"] = arr("meta3Bias")
    return out


def npz_getter(z) -> Getter:
    """Getter over the captured-fixture npz (scripts/capture_tf_fixture.py):
    tf.layers/contrib variables live under 'var/<name>:0', defineParam
    variables under 'nns/<name>', and the shim names the LSTM cell
    itself."""

    def get(name: str) -> np.ndarray:
        if name == LSTM_KERNEL:
            return z["var/shim_basic_lstm_cell_0/kernel:0"]
        if name == LSTM_BIAS:
            return z["var/shim_basic_lstm_cell_0/bias:0"]
        if name.startswith(("dense", "LayerNorm")):
            return z[f"var/{name}:0"]
        return z[f"nns/{name}"]

    return get


def _checkpoint_getter(reader, names, slot: Optional[str] = None) -> Getter:
    """Getter over a tf.train.load_checkpoint reader of a TF1 Saver
    checkpoint. `slot` appends an Adam slot suffix to the resolved
    variable name ('Adam' = first moment, 'Adam_1' = second)."""
    lstm = {}
    for n in sorted(names):
        for part, canon in ((f"{_TF1_LSTM_SUFFIX}/kernel", LSTM_KERNEL),
                            (f"{_TF1_LSTM_SUFFIX}/bias", LSTM_BIAS)):
            if n.endswith(part):  # slot names end with /Adam{,_1}: excluded
                lstm.setdefault(canon, n)

    def resolve(name: str) -> str:
        if name in (LSTM_KERNEL, LSTM_BIAS):
            if name not in lstm:
                raise KeyError(
                    f"no '*/{_TF1_LSTM_SUFFIX}/...' variable in checkpoint "
                    f"(have e.g. {sorted(names)[:5]}...)")
            return lstm[name]
        if name not in names:
            raise KeyError(f"variable '{name}' not in checkpoint")
        return name

    def get(name: str) -> np.ndarray:
        real = resolve(name)
        if slot is not None:
            real = f"{real}/{slot}"
            if real not in names:
                raise KeyError(f"Adam slot '{real}' not in checkpoint")
        return reader.get_tensor(real)

    return get


def import_tf1_checkpoint(path: str, cfg: ModelConfig,
                          with_optimizer: bool = False) -> Dict:
    """Read a reference Saver checkpoint (the `Models/<save_path>` prefix,
    ref model.py:516-517) and map it onto the port's parameters.

    Returns {"params": flat dict} and, with with_optimizer=True, also
    {"mu": flat dict, "nu": flat dict, "step": int}: the Adam first and
    second moments and the saved global step, with which
    `Trainer.load_imported_params` continues training where the reference
    run stopped."""
    try:
        import tensorflow as tf  # CPU wheel; only needed for migration
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "importing TF1 checkpoints requires tensorflow (reader only); "
            "install the CPU wheel or convert on a machine that has it"
        ) from e

    reader = tf.train.load_checkpoint(path)
    names = set(reader.get_variable_to_shape_map())
    out = {"params": map_reference_params(
        _checkpoint_getter(reader, names), cfg)}
    if with_optimizer:
        out["mu"] = map_reference_params(
            _checkpoint_getter(reader, names, slot="Adam"), cfg)
        out["nu"] = map_reference_params(
            _checkpoint_getter(reader, names, slot="Adam_1"), cfg)
        # the LR-schedule global step: the unnamed tf.Variable(0) at
        # model.py:246, saved under the default name 'Variable'
        out["step"] = (int(reader.get_tensor("Variable"))
                       if "Variable" in names else 0)
    return out
