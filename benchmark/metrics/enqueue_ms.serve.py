"""The host's cost of one served call: ms from the start of
``engine.Segmenter.predict_batch`` (its program replay, ``utils/aot.py``)
to its return, each call issued to an idle card."""

from benchmark.layers import enqueue_ms


def read(run):
    return enqueue_ms(run)
