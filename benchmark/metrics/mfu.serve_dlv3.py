"""The whole served step's share of the card's bf16 peak in the DeepLab-v3
cell: the forward's FLOPs a frame (``counts/dlv3.py``) times the frames
completed in the window, over the window's seconds times 989 TFLOP/s."""

from benchmark.dlv3_layers import mfu


def read(run):
    return mfu(run)
