"""The ASPP head's device ms a served call of the DeepLab-v3 cell, inside
the replayed program: the program's device span
``segtpu.engine.decoder.aspp`` (``models/aspp_decoder.py``) around the
head's branches, pooled vector, projection and classifier, mean of the
calls of ``benchmark/dlv3_layers.py``."""

from benchmark.dlv3_layers import span_ms


def read(run):
    return span_ms(run, "aspp")
