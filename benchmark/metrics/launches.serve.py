"""Kernel launches a served call: the engine's ``launches`` counter
(``engine.Segmenter``; a replay adds the launches its CUDA graph holds,
each cell node and each collect one), its change over the calls of
``benchmark/spans.py`` over their number."""

from benchmark.spans import read as read_spans


def read(run):
    return read_spans(run, "served", "launches")
