"""Device ms a request of scoring: the kernels and copies charged to the
program's `sagnn.serve.score` span (`SelfGNN.recommend_top_k`, from the
queries through the seen mask, the sequence branch inside it) and to
spans inside it (`harness/spans.py`), over the traced window's
requests."""

from benchmark.harness import spans


def read(ctx):
    return spans.reading(ctx, "refresh", "sagnn.serve.score", True)
