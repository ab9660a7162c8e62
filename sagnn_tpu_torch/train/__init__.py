"""Evaluation; the port of the metrics in `sagnn_tpu/train/` (training is
not ported yet)."""
