"""The front's device ms a served call, inside the replayed program: the
program's device span ``segtpu.engine.front``
(``engine.Segmenter._run``, event nodes of the shape's CUDA graph)
around the front kernel (``kernels/front.py``), mean of the calls of
``benchmark/spans.py``."""

from benchmark.spans import read as read_spans


def read(run):
    return read_spans(run, "served", "front")
