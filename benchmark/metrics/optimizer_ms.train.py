"""Device ms a step of the TF1 Adam update: the kernels charged to the
program's `sagnn.train.optimizer` span (`Trainer.train_step`, around
`optimizer.step`) (`harness/spans.py`), over the traced window's
steps."""

from benchmark.harness import spans


def read(ctx):
    return spans.reading(ctx, "train", "sagnn.train.optimizer", True)
