"""The encoder's share of its roofline in a served call: its least time
(benchmark counts at the bf16 peak and the HBM rate) over its device time
by CUDA events around the benchmark's calls into its entry point,
the engine's folded encoder, ``models/fast_encoder.py``, at the cell's batch shape."""

from benchmark.layers import roofline_pct


def read(run):
    return roofline_pct(run, "encoder")
