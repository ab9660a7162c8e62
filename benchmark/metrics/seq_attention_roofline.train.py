"""The per-token sequence attention's share of its roofline in training:
the least time of the window's rows of per-token attention (the
program's `ops.attention.SEQ_ATTENTION` count over the window, times a
row's bound from `harness.counts_seq.seq_attention_bound_s`: the valid
tokens' q, k, v and output bytes and 4·D FLOPs a valid pair forward, q,
k, v, the cotangent, dq, dk and dv and 8·D FLOPs a pair backward) over
the device time charged to `sagnn.model.seq_attention`. None where the
program counts no such rows or has no such span."""

from benchmark.harness import spans


def read(ctx):
    if not ctx.get("seq_rows"):
        return None
    ms = spans.reading(ctx, "train", "sagnn.model.seq_attention", True)
    if not ms:
        return None
    bound_ms = 1e3 * ctx["seq_rows"] * ctx["seq_bound_s_per_row"]
    return 100.0 * bound_ms / (ms * ctx["steps"])
