"""Training's device ms a step of ``utils/solvers.py`` ``polyak_update``:
the program's device span ``segtpu.train.polyak``
(``engine/trainer.py``), mean of the steps of ``benchmark/spans.py``."""

from benchmark.spans import read as read_spans


def read(run):
    return read_spans(run, "train", "polyak")
