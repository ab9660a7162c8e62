"""Host ms a request of sequence assembly: the wall time of the program's
`sagnn.serve.sequences` spans on the main thread (around
`user_sequences` in `Recommender.recommend`), over the traced window's
requests."""

from benchmark.harness import spans


def read(ctx):
    return spans.reading(ctx, "refresh", "sagnn.serve.sequences", False)
