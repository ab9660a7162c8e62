"""Device ms a request of the top-k selection: the kernels charged to the
program's `sagnn.serve.topk` span (`SelfGNN.recommend_top_k`, around
`topk_descending`) (`harness/spans.py`), over the traced window's
requests."""

from benchmark.harness import spans


def read(ctx):
    return spans.reading(ctx, "refresh", "sagnn.serve.topk", True)
