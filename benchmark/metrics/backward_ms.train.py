"""Training's device ms a step of the gradients (``torch.autograd.grad`` in
``_apply_update``): the program's device span ``segtpu.train.backward``
(``engine/trainer.py``), mean of the steps of ``benchmark/spans.py``."""

from benchmark.spans import read as read_spans


def read(run):
    return read_spans(run, "train", "backward")
