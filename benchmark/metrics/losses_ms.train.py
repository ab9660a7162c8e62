"""Device ms a step of the loss head, forward and backward: the kernels
and copies charged to the program's `sagnn.model.losses` spans
(`SelfGNN.batch_losses`, with the sequence branch inside it, and the L2
term in `Trainer.train_step`) and to spans inside them
(`harness/spans.py`), over the traced window's steps."""

from benchmark.harness import spans


def read(ctx):
    return spans.reading(ctx, "train", "sagnn.model.losses", True)
