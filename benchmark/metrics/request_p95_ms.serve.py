"""The 95th percentile of the traced refresh window's request times (host
clock, from the call until scores and ids are on the host; a pass's first
request waits for its encode). The device idles for most of a refresh
window, so the tail is the host's pace: a per-layer reading, not an
end-to-end one."""


def read(ctx):
    if ctx["kind"] != "refresh" or not ctx.get("requests"):
        return None
    return ctx.get("request_p95_ms")
