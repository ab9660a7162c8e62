"""Summed device time of every kernel and copy in the traced training
window, per step."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "train" or tr is None or not ctx.get("steps"):
        return None
    if tr.kernel_s <= 0:
        return None
    return 1e3 * tr.kernel_s / ctx["steps"]
