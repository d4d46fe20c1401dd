"""The plain f32 reference of DeepLab-v3 with ASPP on MobileNet-v2 at
output stride 16, served on uint8 frames.

A frozen, plain-PyTorch statement of the model's math, written from the
published descriptions and independent of the program under test (it
imports torch alone: no kernel, module or helper of the port, no JAX):

* MobileNet-v2 1.0 (arXiv:1801.04381): a 3x3 stride-2 stem to 32
  channels, then the (t, c, n, s) table below, every convolution
  followed by BatchNorm and ReLU6 (the projection by none), a residual
  where the stride is 1 and the width is kept.
* Output stride 16 by slim's ``output_stride`` rule (tensorflow/models
  research/slim nets/mobilenet, as DeepLab runs it, arXiv:1706.05587
  section 3.1): once the running stride reaches 16, a block's stride
  becomes 1 and its depthwise conv runs at the running rate, which is
  then multiplied by the stride the block would have had. So the first
  160-channel block runs at stride 1 and rate 1, the other two and the
  320-channel block at rate 2, zero padding 2. No 1280-channel conv.
* ASPP (arXiv:1706.05587 section 3.3; arXiv:1801.04381 section 6.3,
  Table 7's "MNV2*" head with ASPP) on the 320-channel map f, every
  branch a conv, BatchNorm and ReLU to ``aspp_channels``: a 1x1; a 3x3
  at dilation r with padding r for each r of ``aspp_rates``; the image
  pooling branch, a 1x1 on the global average of f, bilinearly
  broadcast over the map. Then a 1x1 conv-BN-ReLU of their
  concatenation back to ``aspp_channels`` and a 1x1 classifier with
  bias. No dropout (inference).
* Served: (x / 255 - mean) / std, zero-padded to a multiple of 32, the
  model, the logits bilinearly upsampled (align_corners, as DeepLab's
  resize) to the padded size, cropped.

Departures, named: every padding is torch-style symmetric (a stride-2
3x3 pads one pixel each side, as the repo's ``MobileNetV2``, where TF's
SAME pads 0 before and 1 after on even sizes); frames are padded to a
multiple of 32 as the served engine pads them (DeepLab pads to its crop
size); BatchNorm's eps is 1e-5 (TF's slim uses 1e-3): the weights are
random, so only the program's agreement with this statement matters.

BatchNorm is never folded: eval mode normalizes by the running
statistics. Everything computes in f32; ``exact_f32()`` turns TF32 off
for the duration. Parameters are read by name through ``P(name, shape,
kind, fan_in)``; the names are the served model's state-dict names.
``quant``, where given, is applied to every convolution's input and
weight: the lower-precision control (``fp8_round``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

# (expansion t, out channels c, repeats n, first stride s)
MBV2 = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
PAD = 32            # frames are zero-padded to multiples of this
BN_EPS = 1e-5
IMG_MEAN = (0.485, 0.456, 0.406)
IMG_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def exact_f32():
    """f32 products without TF32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_round(t):
    """``t`` through float8 e4m3 and back, scaled per tensor so that its
    largest magnitude maps to e4m3's largest (448): the precision one
    step below bf16."""
    amax = t.detach().abs().amax().float().clamp_min(1e-12)
    s = 448.0 / amax
    return ((t.float() * s).to(torch.float8_e4m3fn).float() / s).to(t.dtype)


def schedule(output_stride: int) -> List[Tuple[int, int]]:
    """[(stride, rate)] of the 17 blocks under the output_stride rule."""
    out, current, rate = [], 2, 1
    for _, _, n, s in MBV2:
        for i in range(n):
            stride = s if i == 0 else 1
            if current == output_stride:
                out.append((1, rate))
                rate *= stride
            else:
                out.append((stride, 1))
                current *= stride
    return out


class Net:
    """One forward of the model whose parameters ``P`` gives."""

    def __init__(self, P: Callable, cfg: dict, *,
                 quant: Optional[Callable] = None):
        self.P, self.cfg = P, cfg
        self.q = quant or (lambda t: t)
        self.ac = bool(cfg.get("align_corners", True))

    def bn(self, name, y):
        c = y.shape[1]
        scale = self.P(f"{name}.scale", (c,), "bn_scale")
        bias = self.P(f"{name}.bias", (c,), "bn_bias")
        mean = self.P(f"{name}.mean", (c,), "bn_mean")
        var = self.P(f"{name}.var", (c,), "bn_var")
        return ((y - mean[:, None, None])
                / torch.sqrt(var[:, None, None] + BN_EPS)
                * scale[:, None, None] + bias[:, None, None])

    def conv(self, name, x, cout, k, *, stride=1, dil=1, groups=1,
             bias=False):
        cin = x.shape[1]
        fan_in = cin // groups * k * k
        w = self.P(f"{name}.w", (cout, cin // groups, k, k), "conv", fan_in)
        y = F.conv2d(self.q(x), self.q(w), stride=stride,
                     padding=dil * (k - 1) // 2, dilation=dil, groups=groups)
        if bias:
            y = y + self.P(f"{name}.b", (cout,), "clf_bias")[:, None, None]
        return y

    def conv_bn(self, name, x, cout, k, *, act, stride=1, dil=1, groups=1):
        y = self.bn(name, self.conv(name, x, cout, k, stride=stride,
                                    dil=dil, groups=groups))
        if act == "relu":
            return torch.clamp_min(y, 0)
        if act == "relu6":
            return torch.clamp(y, 0, 6)
        return y

    def encoder(self, x):
        """The 320-channel map at ``output_stride``."""
        y = self.conv_bn("encoder.stem", x, 32, 3, stride=2, act="relu6")
        sched = iter(schedule(int(self.cfg["output_stride"])))
        bi, cin = 0, 32
        for t, c, n, _ in MBV2:
            for _ in range(n):
                stride, rate = next(sched)
                name = f"encoder.blocks.{bi}"
                z = y
                if t != 1:
                    z = self.conv_bn(f"{name}.expand", z, cin * t, 1,
                                     act="relu6")
                z = self.conv_bn(f"{name}.dw", z, cin * t, 3, stride=stride,
                                 dil=rate, groups=cin * t, act="relu6")
                z = self.conv_bn(f"{name}.project", z, c, 1, act="none")
                y = z + y if stride == 1 and cin == c else z
                cin, bi = c, bi + 1
        return y

    def head(self, f):
        ch = int(self.cfg["aspp_channels"])
        outs = [self.conv_bn("decoder.branches.0", f, ch, 1, act="relu")]
        for i, r in enumerate(self.cfg["aspp_rates"]):
            outs.append(self.conv_bn(f"decoder.branches.{i + 1}", f, ch, 3,
                                     dil=int(r), act="relu"))
        pooled = f.mean((2, 3), keepdim=True)
        p = self.conv_bn("decoder.pool", pooled, ch, 1, act="relu")
        outs.append(F.interpolate(p, size=tuple(f.shape[-2:]),
                                  mode="bilinear", align_corners=self.ac))
        y = self.conv_bn("decoder.project", torch.cat(outs, 1), ch, 1,
                         act="relu")
        return self.conv("decoder.clf", y, int(self.cfg["num_classes"]), 1,
                         bias=True)

    def __call__(self, x):
        """Normalized images [N, 3, H, W] (multiples of the output stride)
        -> logits [N, K, H / os, W / os]."""
        return self.head(self.encoder(x))


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """[(name, shape, kind, fan_in)] of every parameter and BatchNorm
    statistic, in the order the forward reads them (a forward at the
    smallest size, on ones)."""
    spec: Dict[str, Tuple] = {}

    def P(name, shape, kind, fan_in=0):
        spec.setdefault(name, (name, tuple(shape), kind, fan_in))
        return torch.ones(shape)

    with torch.no_grad():
        Net(P, cfg)(torch.ones((1, 3, PAD, PAD)))
    return list(spec.values())


def from_dict(weights: Dict[str, torch.Tensor]) -> Callable:
    """A ``P`` that reads ``weights`` and checks each shape."""
    def P(name, shape, kind, fan_in=0):
        t = weights[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {tuple(t.shape)} != {tuple(shape)}")
        return t
    return P


def normalize(imgs_u8):
    """uint8 [N, H, W, 3] -> f32 [N, 3, H, W], (x / 255 - mean) / std."""
    x = imgs_u8.permute(0, 3, 1, 2).float() / 255.0
    mean = x.new_tensor(IMG_MEAN)[:, None, None]
    std = x.new_tensor(IMG_STD)[:, None, None]
    return (x - mean) / std


def served_logits(weights, cfg, imgs_u8, *, quant=None):
    """uint8 frames [N, H, W, 3] -> f32 logits [N, K, H, W]: normalized,
    zero-padded to multiples of 32, the model, bilinear (the config's
    align_corners) back to the padded size, cropped."""
    n, h, w, _ = imgs_u8.shape
    hp, wp = -(-h // PAD) * PAD, -(-w // PAD) * PAD
    x = F.pad(normalize(imgs_u8), (0, wp - w, 0, hp - h))
    net = Net(from_dict(weights), cfg, quant=quant)
    up = F.interpolate(net(x), size=(hp, wp), mode="bilinear",
                       align_corners=net.ac)
    return up[:, :, :h, :w]
