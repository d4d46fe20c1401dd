"""The NAS op vocabulary (counterpart: segtpu/ops/layer_factory.py).

11 channel-preserving, stride-1 ops in ``OP_NAMES`` order — genotypes
store op indices, so the order is parity-critical. Each op is an
``nn.Module`` whose parameter tree mirrors the JAX op's pytree:
conv ops and GAP hold ``conv``; separable convs hold ``reps``, a list of
``{dw, pw}`` pairs; skip and none hold nothing.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from segtpu_torch.core.layers import ConvBN

OP_NAMES = (
    "conv1x1",            # 0
    "conv3x3",            # 1
    "sep_conv_3x3",       # 2
    "sep_conv_5x5",       # 3
    "global_average_pool",  # 4  GAP -> conv1x1 -> broadcast-upsample
    "conv3x3_dil3",       # 5
    "conv3x3_dil12",      # 6
    "sep_conv_3x3_dil3",  # 7
    "sep_conv_5x5_dil6",  # 8
    "skip_connect",       # 9
    "none",               # 10 zero op
)
NUM_OPS = len(OP_NAMES)

# decoder ops use plain ReLU after their conv-bn blocks
_ACT = "relu"

# (kernel, dilation, separable) for the conv-flavoured ops
_CONV_SPECS = {
    "conv1x1": (1, 1, False),
    "conv3x3": (3, 1, False),
    "sep_conv_3x3": (3, 1, True),
    "sep_conv_5x5": (5, 1, True),
    "conv3x3_dil3": (3, 3, False),
    "conv3x3_dil12": (3, 12, False),
    "sep_conv_3x3_dil3": (3, 3, True),
    "sep_conv_5x5_dil6": (5, 6, True),
}


class Op(nn.Module):
    """One NAS op at channel width ``c``; x: [N, C, H, W] -> same shape."""

    def __init__(self, name: str, c: int, *, repeats: int = 1,
                 generator: torch.Generator):
        super().__init__()
        self.name = name
        if name in ("skip_connect", "none"):
            return
        if name == "global_average_pool":
            self.conv = ConvBN(c, c, 1, act=_ACT, generator=generator)
            return
        k, dil, sep = _CONV_SPECS[name]
        if sep:
            self.reps = nn.ModuleList(
                nn.ModuleDict({
                    "dw": ConvBN(c, c, k, dilation=dil, groups=c, act=_ACT,
                                 generator=generator),
                    "pw": ConvBN(c, c, 1, act=_ACT, generator=generator)})
                for _ in range(repeats))
        else:
            self.conv = ConvBN(c, c, k, dilation=dil, act=_ACT,
                               generator=generator)

    def forward(self, x):
        if self.name == "none":
            return torch.zeros_like(x)
        if self.name == "skip_connect":
            return x
        if self.name == "global_average_pool":
            # GAP in f32 -> 1x1 conv-bn-relu -> broadcast back to H x W
            # (bilinear upsample of a 1x1 map is exactly a broadcast)
            pooled = x.float().mean((-2, -1), keepdim=True).to(x.dtype)
            return self.conv(pooled).expand(-1, -1, x.shape[-2], x.shape[-1])
        if hasattr(self, "reps"):
            for rep in self.reps:
                x = rep["pw"](rep["dw"](x))
            return x
        return self.conv(x)
