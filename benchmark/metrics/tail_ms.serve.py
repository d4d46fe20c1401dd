"""The tail's device ms a served call, inside the replayed program: the
program's device span ``segtpu.engine.tail`` (``engine.Segmenter._run``,
event nodes of the shape's CUDA graph) around the tail kernel
(``kernels/upsample_argmax.py``), mean of the calls of
``benchmark/spans.py``."""

from benchmark.spans import read as read_spans


def read(run):
    return read_spans(run, "served", "tail")
