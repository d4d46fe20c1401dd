"""The ASPP head's share of its roofline in the DeepLab-v3 cell: its least
time (``counts/dlv3.py``: FLOPs at 989 TFLOP/s, bytes at 3.35 TB/s) over
its device time by CUDA events around replays of a CUDA graph of the
benchmark's call into the engine's folded head
(``models/aspp_decoder.py``) at the cell's batch shape."""

from benchmark.dlv3_layers import roofline_pct


def read(run):
    return roofline_pct(run, "head")
