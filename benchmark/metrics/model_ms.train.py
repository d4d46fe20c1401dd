"""Training's device ms a step of the model with its aux heads
(``make_train_step``'s forward): the program's device span
``segtpu.train.forward`` (``engine/trainer.py``), mean of the steps of
``benchmark/spans.py``."""

from benchmark.spans import read as read_spans


def read(run):
    return read_spans(run, "train", "forward")
