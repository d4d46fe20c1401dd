"""The whole served step's share of the card's bf16 peak: the forward's
FLOPs a frame (benchmark counts) times the frames completed in the
window, over the window's seconds times 989 TFLOP/s."""

from benchmark.layers import serve_mfu


def read(run):
    return serve_mfu(run)
