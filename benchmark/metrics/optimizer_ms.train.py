"""Training's device ms a step of ``utils/solvers.py`` ``GroupSGD.update``:
the program's device span ``segtpu.train.optimizer``
(``engine/trainer.py``), mean of the steps of ``benchmark/spans.py``."""

from benchmark.spans import read as read_spans


def read(run):
    return read_spans(run, "train", "optimizer")
