"""Training's device ms a step of the loss (``segmentation_loss``): the
program's device span ``segtpu.train.loss`` (``engine/trainer.py``),
mean of the steps of ``benchmark/spans.py``."""

from benchmark.spans import read as read_spans


def read(run):
    return read_spans(run, "train", "loss")
