"""Host sampling per batch in the window: the Trainer's own
`sample_timer` (the sampler's worker thread, batch sampled and copied to
the device), its total over the window's batches divided by their count."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return ctx.get("sample_ms")
