"""The share of the traced serving window in which no kernel, copy or
set ran on the card (profiler)."""

from benchmark.layers import idle_pct


def read(run):
    return idle_pct(run)
