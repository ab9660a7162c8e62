"""Operators; the port of `sagnn_tpu/ops/` (segment-sum propagation and its
CUDA kernel, attention, LSTM, catalog chunking)."""
