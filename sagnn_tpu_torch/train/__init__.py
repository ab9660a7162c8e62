"""Training and evaluation; the port of `sagnn_tpu/train/` (metrics, TF1
Adam, checkpoints, the single-device trainer)."""
