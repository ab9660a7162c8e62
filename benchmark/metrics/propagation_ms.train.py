"""Device ms a step of the interval propagation, forward and backward: the
kernels and copies charged to the program's `sagnn.model.propagation`
span (`_interval_propagation`) and to spans inside it, a backward kernel
through its autograd node's forward op (`harness/spans.py`), over the
traced window's steps."""

from benchmark.harness import spans


def read(ctx):
    return spans.reading(ctx, "train", "sagnn.model.propagation", True)
