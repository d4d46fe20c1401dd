"""NCHW conv/BN/activation blocks (counterpart: segtpu/core/layers.py).

Parameter names and shapes follow the JAX pytrees leaf for leaf, so
``segtpu_torch.convert.from_jax`` maps one onto the other by name:
a conv holds ``w`` (OIHW here, HWIO in JAX), a BatchNorm ``scale`` and
``bias`` (parameters) and ``mean`` and ``var`` (buffers).

Eval-mode only: this slice serves. BatchNorm follows ``bn_apply`` in
eval mode: upcast to f32, ``rsqrt(var + eps) * scale``, round back to
the compute dtype. Padding is torch-style symmetric, as ``conv_apply``
builds it explicitly.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


def relu(x):
    return torch.clamp_min(x, 0)


def relu6(x):
    return torch.clamp(x, 0, 6.0)


def identity(x):
    return x


ACTIVATIONS = {"relu": relu, "relu6": relu6, "none": identity}


def kaiming_uniform(shape, fan_in: int, generator: torch.Generator):
    """PyTorch nn.Conv2d's default init, the JAX ``conv_init`` rule."""
    bound = math.sqrt(1.0 / fan_in) * math.sqrt(3.0)
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def bn_eval(y, scale, bias, mean, var):
    """Eval BatchNorm over dim 1, in f32, rounded back to y's dtype."""
    inv = torch.rsqrt(var + BN_EPS) * scale
    shift = bias - mean * inv
    yf = y.float() * inv[:, None, None] + shift[:, None, None]
    return yf.to(y.dtype)


class Conv(nn.Module):
    """Bias-free conv weight ``w`` [Cout, Cin/groups, k, k] (+ optional
    classifier bias ``b``, added after the conv in the compute dtype as
    the JAX heads do)."""

    def __init__(self, cin: int, cout: int, k: int, *, groups: int = 1,
                 bias: bool = False, generator: torch.Generator):
        super().__init__()
        self.groups = groups
        self.w = nn.Parameter(kaiming_uniform(
            (cout, cin // groups, k, k), (cin // groups) * k * k, generator))
        if bias:
            self.b = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        y = F.conv2d(x, self.w.to(x.dtype), groups=self.groups)
        if hasattr(self, "b"):
            y = y + self.b.to(y.dtype)[:, None, None]
        return y


class ConvBN(nn.Module):
    """conv -> BN -> activation (JAX ``conv_bn_init``/``conv_bn_apply``)."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1,
                 dilation: int = 1, groups: int = 1, act: str = "relu",
                 generator: torch.Generator):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = dilation * (k - 1) // 2
        self.act = act
        self.w = nn.Parameter(kaiming_uniform(
            (cout, cin // groups, k, k), (cin // groups) * k * k, generator))
        self.scale = nn.Parameter(torch.ones(cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.register_buffer("mean", torch.zeros(cout))
        self.register_buffer("var", torch.ones(cout))

    def bn(self, y):
        return bn_eval(y, self.scale, self.bias, self.mean, self.var)

    def forward(self, x):
        y = F.conv2d(x, self.w.to(x.dtype), stride=self.stride,
                     padding=self.padding, dilation=self.dilation,
                     groups=self.groups)
        return ACTIVATIONS[self.act](self.bn(y))
