"""The host's ms in a served call, by the program's own clock: the host
span ``segtpu.engine.predict`` (``engine.Segmenter.predict_batch``: the
static-input copy, the replay and the output's clone), each call issued
to an idle card, mean of the calls of ``benchmark/spans.py``."""

from benchmark.spans import read as read_spans


def read(run):
    return read_spans(run, "served", "predict_host")
