"""sagnn_tpu_torch: SelfGNN on PyTorch and CUDA (NVIDIA Hopper), the port of
the JAX package `sagnn_tpu`.

It serves and trains SelfGNN on one device: graph encoding (interval
propagation through hand-written CUDA kernels, shared LSTM, interval
attention), candidate scoring, full-catalog top-k, HR/NDCG evaluation, the
BPR and SSL losses, TF1 Adam, checkpoints and resume. Propagation runs
unweighted (the reference's parity path) or in the opt-in edge variants:
degree-normalised weights, edge dropout and edge attention. Entry points:
`serve.Recommender` / `python -m sagnn_tpu_torch.serve` and
`train.trainer.Trainer` / `python -m sagnn_tpu_torch.main`.
"""

__version__ = "0.1.0"
