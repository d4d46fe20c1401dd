"""Training's device ms a step of every train BatchNorm of the forward:
the program's device spans ``segtpu.train.bn`` (``core/layers.py``
``bn_train``), summed over the step, mean of the steps of
``benchmark/spans.py``."""

from benchmark.spans import read as read_spans


def read(run):
    return read_spans(run, "train", "bn")
