"""Device ms a step of the temporal fusion (the LSTM, the interval MHSA
and the mean over every node), forward and backward: the kernels and
copies charged to the program's `sagnn.model.fusion` span
(`_temporal_fusion`) and to spans inside it (`harness/spans.py`), over
the traced window's steps."""

from benchmark.harness import spans


def read(ctx):
    return spans.reading(ctx, "train", "sagnn.model.fusion", True)
