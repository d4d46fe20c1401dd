"""The host's ms in a train step, by the program's own clock: the host span
``segtpu.train.step`` (``engine/trainer.py`` ``make_train_step``), steps
back to back as in the window, mean of the steps of
``benchmark/spans.py``."""

from benchmark.spans import read as read_spans


def read(run):
    return read_spans(run, "train", "step_host")
