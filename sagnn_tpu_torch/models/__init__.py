"""Model code; the port of `sagnn_tpu/models/` (SelfGNN inference and its
layers)."""
