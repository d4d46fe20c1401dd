"""The four stride-16 blocks' share of their roofline in the DeepLab-v3
cell: their least time (``counts/dlv3.py``) over their device time by
CUDA events around replays of a CUDA graph of the benchmark's call into
the engine's folded blocks (``models/fast_encoder.py``) on their input."""

from benchmark.dlv3_layers import roofline_pct


def read(run):
    return roofline_pct(run, "atrous")
