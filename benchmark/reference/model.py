"""The plain f32 reference of the served and trained models.

A frozen, plain-PyTorch statement of the model math, written from the
published descriptions and independent of the program under test:

* MobileNet-v2, width 1.0 (arXiv:1801.04381): a 3x3 stride-2 stem to 32
  channels, then the (t, c, n, s) table below, every convolution followed
  by BatchNorm and ReLU6 (the projection by none), a residual where the
  stride is 1 and the width is kept. Taps at output strides 4, 8, 16, 32.
* The micro decoder (CVPR'19, arXiv:1810.10804): each tap adapted by a
  1x1 conv-BN-ReLU to ``agg_size``; each block merges two pool entries
  (1x1 conv-BN-ReLU on each, the smaller upsampled to the larger, added)
  and runs the contextual cell; the entries no block reads are upsampled
  to the largest, concatenated and classified by a 1x1 with bias.
* The template decoder (WACV'20, arXiv:1904.02365): each block reads two
  pool entries, aggregates them by ``psum`` (a 1x1 conv-BN-ReLU on each,
  both upsampled, added) or ``cat`` (both upsampled, concatenated, a 1x1
  conv-BN-ReLU back to ``agg_size``) and appends one op of the result.

BatchNorm is never folded: eval mode normalizes by the running
statistics, train mode by the batch's (biased, two-pass variance).
Bilinear resizes are ``F.interpolate`` with the configuration's
``align_corners``. Everything computes in f32; ``exact_f32()`` turns
TF32 off for the duration.

Parameters are read by name through a ``P(name, shape, kind, fan_in)``
callable; the names are the state-dict names of the served model, so one
dict of tensors, made by the benchmark from the seed, feeds both sides.
``param_spec`` lists them by running the forward once at a small size.

``quant``, where given, is applied to every convolution's input and
weight: the lower-precision control (``fp8_round``).

Imports torch alone.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

# (expansion t, out channels c, repeats n, first stride s)
MBV2 = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
TAP_STAGES = (1, 2, 4, 6)
TAP_CHANNELS = (24, 32, 96, 320)
STRIDE = 32

# the op vocabulary by index: (kind, kernel, dilation)
OPS = (("conv", 1, 1), ("conv", 3, 1), ("sep", 3, 1), ("sep", 5, 1),
       ("gap", 1, 1), ("conv", 3, 3), ("conv", 3, 12), ("sep", 3, 3),
       ("sep", 5, 6), ("skip", 0, 0), ("none", 0, 0))
AGG_OPS = ("psum", "cat")

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
    largest magnitude maps to e4m3's largest (448), as fp8 inference
    scales: the precision one step below bf16."""
    amax = t.detach().abs().amax().float().clamp_min(1e-12)
    s = 448.0 / amax
    return ((t.float() * s).to(torch.float8_e4m3fn).float() / s).to(t.dtype)


class Net:
    """One forward of the model whose parameters ``P`` gives.

    ``train``: BatchNorm on batch statistics; ``quant``: the rounding
    applied to each convolution's input and weight."""

    def __init__(self, P: Callable, cfg: dict, *, train: bool = False,
                 quant: Optional[Callable] = None):
        self.P, self.cfg, self.train = P, cfg, train
        self.q = quant or (lambda t: t)
        self.ac = bool(cfg.get("align_corners", True))

    # -- blocks --------------------------------------------------------
    def bn(self, name, y):
        c = y.shape[1]
        scale = self.P(f"{name}.scale", (c,), "bn_scale")
        bias = self.P(f"{name}.bias", (c,), "bn_bias")
        mean = self.P(f"{name}.mean", (c,), "bn_mean")
        var = self.P(f"{name}.var", (c,), "bn_var")
        if self.train:
            mean = y.mean((0, 2, 3))
            var = (y - mean[:, None, None]).square().mean((0, 2, 3))
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

    def resize(self, x, hw):
        if tuple(x.shape[-2:]) == tuple(hw):
            return x
        return F.interpolate(x, size=tuple(hw), mode="bilinear",
                             align_corners=self.ac)

    # -- encoder -------------------------------------------------------
    def encoder(self, x) -> List[torch.Tensor]:
        y = self.conv_bn("encoder.stem", x, 32, 3, stride=2, act="relu6")
        taps, bi, cin = [], 0, 32
        for stage, (t, c, n, s) in enumerate(MBV2):
            for i in range(n):
                stride = s if i == 0 else 1
                name = f"encoder.blocks.{bi}"
                z = y
                if t != 1:
                    z = self.conv_bn(f"{name}.expand", z, cin * t, 1,
                                     act="relu6")
                z = self.conv_bn(f"{name}.dw", z, cin * t, 3, stride=stride,
                                 groups=cin * t, act="relu6")
                z = self.conv_bn(f"{name}.project", z, c, 1, act="none")
                y = z + y if stride == 1 and cin == c else z
                cin, bi = c, bi + 1
            if stage in TAP_STAGES:
                taps.append(y)
        return taps

    # -- the op vocabulary ---------------------------------------------
    def op(self, name, index, x):
        kind, k, dil = OPS[index]
        c = x.shape[1]
        if kind == "none":
            return torch.zeros_like(x)
        if kind == "skip":
            return x
        if kind == "gap":
            pooled = x.mean((2, 3), keepdim=True)
            y = self.conv_bn(f"{name}.conv", pooled, c, 1, act="relu")
            return y.expand(-1, -1, x.shape[-2], x.shape[-1])
        if kind == "sep":
            for r in range(int(self.cfg.get("repeats", 1))):
                x = self.conv_bn(f"{name}.reps.{r}.dw", x, c, k, dil=dil,
                                 groups=c, act="relu")
                x = self.conv_bn(f"{name}.reps.{r}.pw", x, c, 1, act="relu")
            return x
        return self.conv_bn(f"{name}.conv", x, c, k, dil=dil, act="relu")

    def cell(self, name, cell_config, x):
        outs = [x, self.op(f"{name}.node0", cell_config[0], x)]
        used = {0}
        for k, (p1, p2, o1, o2) in enumerate(cell_config[1:]):
            outs.append(self.op(f"{name}.nodes.{k}.a", o1, outs[p1])
                        + self.op(f"{name}.nodes.{k}.b", o2, outs[p2]))
            used.update((p1, p2))
        out = None
        for i in range(len(outs)):
            if i not in used:
                out = outs[i] if out is None else out + outs[i]
        return out

    # -- decoders ------------------------------------------------------
    def head(self, pool, used):
        collect = [i for i in range(len(pool)) if i not in used]
        h = max(pool[i].shape[-2] for i in collect)
        w = max(pool[i].shape[-1] for i in collect)
        feats = torch.cat([self.resize(pool[i], (h, w)) for i in collect], 1)
        return self.conv("decoder.clf", feats,
                         int(self.cfg["num_classes"]), 1, bias=True)

    def micro(self, taps, with_aux):
        cfg = self.cfg
        agg, K = int(cfg["agg_size"]), int(cfg["num_classes"])
        cell_config, conns = cfg["genotype"]
        pool = [self.conv_bn(f"decoder.adapt.{i}", t, agg, 1, act="relu")
                for i, t in enumerate(taps)]
        aux, used = [], set()
        for b, (i, j) in enumerate(conns):
            name = f"decoder.blocks.{b}"
            y1 = self.conv_bn(f"{name}.agg.branch1", pool[i], agg, 1,
                              act="relu")
            y2 = self.conv_bn(f"{name}.agg.branch2", pool[j], agg, 1,
                              act="relu")
            hw = (max(y1.shape[-2], y2.shape[-2]),
                  max(y1.shape[-1], y2.shape[-1]))
            y = self.resize(y1, hw) + self.resize(y2, hw)
            y = self.cell(f"{name}.cell", cell_config, y)
            pool.append(y)
            used.update((i, j))
            if with_aux:
                aux.append(self.conv(f"{name}.aux.clf", y, K, 1, bias=True))
        return self.head(pool, used), aux

    def template(self, taps, with_aux):
        cfg = self.cfg
        agg, K = int(cfg["agg_size"]), int(cfg["num_classes"])
        pool = [self.conv_bn(f"decoder.adapt.{i}", t, agg, 1, act="relu")
                for i, t in enumerate(taps)]
        aux, used = [], set()
        for b, (i, j, agg_op, op) in enumerate(cfg["genotype"]):
            name = f"decoder.blocks.{b}"
            x1, x2 = pool[i], pool[j]
            hw = (max(x1.shape[-2], x2.shape[-2]),
                  max(x1.shape[-1], x2.shape[-1]))
            if AGG_OPS[agg_op] == "psum":
                y = (self.resize(self.conv_bn(f"{name}.b1", x1, agg, 1,
                                              act="relu"), hw)
                     + self.resize(self.conv_bn(f"{name}.b2", x2, agg, 1,
                                                act="relu"), hw))
            else:
                y = self.conv_bn(f"{name}.reduce", torch.cat(
                    [self.resize(x1, hw), self.resize(x2, hw)], 1), agg, 1,
                    act="relu")
            y = self.op(f"{name}.op", op, y)
            pool.append(y)
            used.update((i, j))
            if with_aux:
                aux.append(self.conv(f"{name}.aux_clf", y, K, 1, bias=True))
        return self.head(pool, used), aux

    def __call__(self, x, *, with_aux: bool = False):
        """Normalized images [N, 3, H, W] (stride multiples) -> logits at
        1/4 [N, K, H/4, W/4], and the aux heads' logits with
        ``with_aux``."""
        taps = self.encoder(x)
        family = self.cfg["family"]
        if family == "micro":
            logits, aux = self.micro(taps, with_aux)
        elif family == "template":
            logits, aux = self.template(taps, with_aux)
        else:
            raise ValueError(f"unknown decoder family {family!r}")
        return (logits, aux) if with_aux else logits


def param_spec(cfg: dict, *, aux: bool = False
               ) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """[(name, shape, kind, fan_in)] of every parameter and BatchNorm
    statistic of the model, in the order the forward reads them (a
    forward at the smallest size, on ones)."""
    spec: Dict[str, Tuple] = {}

    def P(name, shape, kind, fan_in=0):
        spec.setdefault(name, (name, tuple(shape), kind, fan_in))
        return torch.ones(shape)

    x = torch.ones((2, 3, STRIDE, STRIDE))
    with torch.no_grad():
        Net(P, cfg, train=aux)(x, with_aux=aux)
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
    """The served function's logits: uint8 frames [N, H, W, 3] ->
    normalized, zero-padded to stride multiples, the model, bilinear back
    to the padded size, cropped: f32 [N, K, H, W]. Eval-mode BatchNorm."""
    n, h, w, _ = imgs_u8.shape
    hp, wp = -(-h // STRIDE) * STRIDE, -(-w // STRIDE) * STRIDE
    x = F.pad(normalize(imgs_u8), (0, wp - w, 0, hp - h))
    net = Net(from_dict(weights), cfg, quant=quant)
    up = net.resize(net(x), (hp, wp))
    return up[:, :, :h, :w]
