"""Host data layer; the port of `sagnn_tpu/data/` (graph blocks, pickle
loading, the synthetic bundle, train and eval batches)."""
