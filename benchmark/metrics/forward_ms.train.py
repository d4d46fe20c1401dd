"""Training's forward: device ms a step (CUDA events) of
``engine/trainer.py`` ``make_train_step``'s ``step.parts.terms`` (the
forward with aux heads and the loss's terms) and their combination into
the loss."""

from benchmark.layers import train_parts_ms


def read(run):
    parts = train_parts_ms(run)
    return None if parts is None else parts["forward"]
