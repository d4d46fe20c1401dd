"""Training's update: device ms a step (CUDA events) of
``step.parts.update``: the backward, ``utils/solvers.GroupSGD`` and the
Polyak average."""

from benchmark.layers import train_parts_ms


def read(run):
    parts = train_parts_ms(run)
    return None if parts is None else parts["update"]
