"""The whole training step's share of the card's f32 peak: model FLOPs of
one step (`harness.counts.train_step_flops`, from shapes and the log's edge
counts) times the traced window's steps, over the window's seconds times
67 TFLOP/s."""

from benchmark.harness.counts import F32_FLOPS


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "train" or tr is None or not ctx.get("steps"):
        return None
    return 100.0 * ctx["flops_per_step"] * ctx["steps"] / (
        tr.window_s * F32_FLOPS)
