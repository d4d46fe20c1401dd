"""MobileNet-v2 encoder with multi-scale taps
(counterpart: segtpu/models/encoders.py).

Four taps at output strides 4/8/16/32 (24/32/96/320 channels). Two
input formats: ``"nhwc3"`` — the normalized image as [N, 3, H, W] and a
3x3 stride-2 stem — and ``"s2d12"`` — its 2x2 space-to-depth form
[N, 12, H/2, W/2] with the stem folded into an equivalent 2x2 stride-1
conv (``stem_s2d_kernel``), exact to rounding. The format name is the
JAX package's; inside the port both are channel-first.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from segtpu_torch.core import bands
from segtpu_torch.core.layers import ConvBN, relu6

# (expansion t, out channels c, repeats n, first-stride s)
_MBV2_CFG = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),   # tap 0: stride 4,  24ch
    (6, 32, 3, 2),   # tap 1: stride 8,  32ch
    (6, 64, 4, 2),
    (6, 96, 3, 1),   # tap 2: stride 16, 96ch
    (6, 160, 3, 2),
    (6, 320, 1, 1),  # tap 3: stride 32, 320ch
)
_TAP_STAGES = (1, 2, 4, 6)
MBV2_TAP_CHANNELS = (24, 32, 96, 320)


class InvRes(nn.Module):
    """Inverted residual: [expand 1x1] -> dw 3x3 -> project 1x1."""

    def __init__(self, cin: int, cout: int, t: int, stride: int, *,
                 generator: torch.Generator):
        super().__init__()
        mid = cin * t
        if t != 1:
            self.expand = ConvBN(cin, mid, 1, act="relu6",
                                 generator=generator)
        self.dw = ConvBN(mid, mid, 3, stride=stride, groups=mid,
                         act="relu6", generator=generator)
        self.project = ConvBN(mid, cout, 1, act="none", generator=generator)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        y = self.expand(x) if hasattr(self, "expand") else x
        y = self.project(self.dw(y))
        return y + x if self.residual else y


def space_to_depth(x):
    """[N, C, H, W] -> [N, 4C, H/2, W/2]; channel order (dy, dx, c)
    row-major, as the JAX package's NHWC ``space_to_depth``."""
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // 2, 2, w // 2, 2)
    y = y.permute(0, 3, 5, 1, 2, 4)                # n, dy, dx, c, i, j
    return y.reshape(n, 4 * c, h // 2, w // 2)


def stem_s2d_kernel(w3):
    """Fold the 3x3/stride-2 stem kernel (OIHW [Cout, Cin, 3, 3]) into
    the equivalent 2x2/stride-1 kernel [Cout, 4*Cin, 2, 2] over the
    space-to-depth input, padded (1, 0) on top and left. Patch tap a at
    intra-patch offset dy reads 3x3 tap u = 2a + dy - 2; taps with
    2a + dy == 0 fall on the zero padding."""
    cout, cin, kh, kw = w3.shape
    assert (kh, kw) == (3, 3)
    w2 = w3.new_zeros((cout, 4 * cin, 2, 2))
    for a in range(2):
        for b in range(2):
            for dy in range(2):
                for dx in range(2):
                    u, v = 2 * a + dy - 2, 2 * b + dx - 2
                    if -1 <= u <= 1 and -1 <= v <= 1:
                        idx = (dy * 2 + dx) * cin
                        w2[:, idx:idx + cin, a, b] = w3[:, :, u + 1, v + 1]
    return w2


class MobileNetV2(nn.Module):
    """Feature extractor; ``forward`` returns the list of 4 taps."""

    def __init__(self, *, in_channels: int = 3, generator: torch.Generator):
        super().__init__()
        self.stem = ConvBN(in_channels, 32, 3, stride=2, act="relu6",
                           generator=generator)
        blocks = []
        cin = 32
        for t, c, n, s in _MBV2_CFG:
            for i in range(n):
                blocks.append(InvRes(cin, c, t, s if i == 0 else 1,
                                     generator=generator))
                cin = c
        self.blocks = nn.ModuleList(blocks)
        self.eval()

    def forward(self, x, input_format: str = "nhwc3"):
        if input_format == "s2d12":
            # the top row of padding is the image's, not each band's
            w2 = stem_s2d_kernel(self.stem.w).to(x.dtype)
            y = bands.conv2d(x, w2, padding=(1, 0, 1, 0))
            y = relu6(self.stem.bn(y))
        elif input_format == "nhwc3":
            y = self.stem(x)
        else:
            raise ValueError(f"unknown input_format {input_format!r}")
        taps = []
        bi = 0
        for stage, (_, _, n, _) in enumerate(_MBV2_CFG):
            for _ in range(n):
                y = self.blocks[bi](y)
                bi += 1
            if stage in _TAP_STAGES:
                taps.append(y)
        return taps
