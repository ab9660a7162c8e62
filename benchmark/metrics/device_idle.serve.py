"""The share of the traced serving window in which no kernel or copy ran
on the device (the union of their intervals in the profiler's trace)."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "refresh" or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - tr.busy_s / tr.window_s)
