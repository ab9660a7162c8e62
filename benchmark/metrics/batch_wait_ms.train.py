"""Host ms a step that the training loop waits for its next batch: the
wall time of the program's `sagnn.train.wait_batch` spans on the main
thread (around `nxt.result()` in `Trainer.train_epoch`; the sampler's
worker thread samples and copies the batch meanwhile), over the traced
window's steps."""

from benchmark.harness import spans


def read(ctx):
    return spans.reading(ctx, "train", "sagnn.train.wait_batch", False)
