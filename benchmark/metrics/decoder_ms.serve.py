"""The decoder's device ms a served call, inside the replayed program: the
program's device span ``segtpu.engine.decoder``
(``engine.Segmenter._run``, event nodes of the shape's CUDA graph)
around the folded decoder (``models/fast_decoder.py``), mean of the
calls of ``benchmark/spans.py``."""

from benchmark.spans import read as read_spans


def read(run):
    return read_spans(run, "served", "decoder")
