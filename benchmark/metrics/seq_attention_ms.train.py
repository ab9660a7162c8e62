"""Device ms a step of the per-token sequence attention, forward and
backward: the kernels and copies charged to the program's
`sagnn.model.seq_attention` spans (each of the sequence branch's
att_layer masked attention calls, inside `sagnn.model.sequence`) and to
spans inside them, a backward kernel through its autograd node's forward
op (`harness/spans.py`), over the traced window's steps. None where the
program has no such span (the pooled branch)."""

from benchmark.harness import spans


def read(ctx):
    return spans.reading(ctx, "train", "sagnn.model.seq_attention", True)
