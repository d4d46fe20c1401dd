"""The four stride-16 blocks' device ms a served call of the DeepLab-v3
cell, inside the replayed program: the program's device span
``segtpu.engine.encoder.atrous`` (``models/fast_encoder.py``, event nodes
of the shape's CUDA graph) around the blocks that run at stride 16 in
place of 32 (the first 160-channel block at rate 1, three at rate 2),
mean of the calls of ``benchmark/dlv3_layers.py``."""

from benchmark.dlv3_layers import span_ms


def read(run):
    return span_ms(run, "atrous")
