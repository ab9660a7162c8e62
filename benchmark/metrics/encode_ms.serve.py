"""Host clock around each `Recommender.encode()` of the traced window,
ended by a synchronise, averaged over the window's passes."""


def read(ctx):
    if ctx["kind"] != "refresh":
        return None
    return ctx.get("encode_ms")
