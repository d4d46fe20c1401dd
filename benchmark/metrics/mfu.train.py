"""The whole training step's share of the card's bf16 peak: three times
the forward's FLOPs with the aux heads (benchmark counts) times the
images of the window's steps, over the window's seconds times 989
TFLOP/s."""

from benchmark.counts.work import train_flop
from benchmark.peaks import BF16_FLOP_PER_S


def read(run):
    t = run.traffic
    flop = train_flop(run.cfg, int(t["height"]), int(t["width"]))
    return 100.0 * flop * run.window_images / (run.window_s * BF16_FLOP_PER_S)
