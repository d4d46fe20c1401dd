"""Launches of the head's tensor-core kernel in a served call of the
DeepLab-v3 cell: the program's counter ``kernels.aspp.aspp_chw.launches``
over one eager call (``benchmark/dlv3_layers.py``)."""

from benchmark.dlv3_layers import aspp_launches


def read(run):
    return aspp_launches(run)
