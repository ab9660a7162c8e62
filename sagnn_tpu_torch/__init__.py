"""sagnn_tpu_torch: SelfGNN on PyTorch and CUDA (NVIDIA Hopper), the port of
the JAX package `sagnn_tpu`.

This slice serves a trained (or randomly initialised) model: graph
encoding (interval propagation through the hand-written CUDA segment-sum,
shared LSTM, interval attention), candidate scoring, full-catalog top-k and
HR/NDCG evaluation. Entry points: `serve.Recommender` and
`python -m sagnn_tpu_torch.serve`. Training is not ported yet.
"""

__version__ = "0.1.0"
