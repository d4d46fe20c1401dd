"""NCHW conv/BN/activation blocks (counterpart: segtpu/core/layers.py).

Parameter names and shapes follow the JAX pytrees leaf for leaf, so
``segtpu_torch.convert.from_jax`` maps one onto the other by name:
a conv holds ``w`` (OIHW here, HWIO in JAX), a BatchNorm ``scale`` and
``bias`` (parameters) and ``mean`` and ``var`` (buffers).

BatchNorm follows ``bn_apply``: ``ConvBN`` normalizes with its running
stats in eval mode (``bn_eval``: upcast to f32, ``rsqrt(var + eps) *
scale``, round back to the compute dtype) and with the batch's in train
mode (``bn_train``), chosen by ``module.training``. The port's modules
start in eval mode, as the JAX apply functions default to
``train=False``: training asks for batch statistics with ``.train()``.
Padding is torch-style symmetric, as ``conv_apply`` builds it explicitly.

Inside ``core.bands.shard_context`` (the sharded train step,
``parallel.mesh.make_sharded_train_step``) ``bn_train`` normalizes with
the moments of the whole batch, every shard's partial sums combined, as
XLA's reductions over a sharded batch give the JAX package's; on a mesh
with ``space`` > 1 the convolutions are ``core.bands.conv2d``'s, each
shard computing its band of rows.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from segtpu_torch.core import bands

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


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


def _batch_moments(yf):
    """(mean, biased variance, n) over N, H, W of the batch, or of the
    whole sharded batch inside ``shard_context``: the mean from every
    shard's sum, the variance from every shard's sum of squares about
    that mean (the same two passes), n the whole batch's N*H*W (a
    ``bands.replicated`` tensor counted once a row)."""
    member = bands.mesh_member()
    if member is None:
        batch_mean = yf.mean((0, 2, 3))
        batch_var = (yf - batch_mean[:, None, None]).square().mean(
            (0, 2, 3))
        return batch_mean, batch_var, yf.numel() // yf.shape[1]
    group, rank = member
    # a copy that the row's first shard also holds counts once
    replica = bands.is_replica()

    def part(t):
        return torch.zeros_like(t) if replica else t

    total, n = group.all_sum(rank, part(yf.sum((0, 2, 3))),
                             0 if replica else yf.numel() // yf.shape[1])
    batch_mean = total / n
    batch_var = group.all_sum(rank, part((yf - batch_mean[:, None, None])
                                         .square().sum((0, 2, 3)))) / n
    return batch_mean, batch_var, n


def bn_train(y, scale, bias, mean, var):
    """Train BatchNorm over N, H, W, in f32, rounded back to y's dtype.

    The batch mean and the two-pass biased variance ``mean((y -
    mean)^2)`` normalize (E[y^2] - E[y]^2 loses most of its bits where
    mean^2 >> var); the running buffers ``mean`` and ``var`` move in
    place, ``(1 - 0.1) * running + 0.1 * batch``, the variance unbiased
    by n / (n - 1) with n = N*H*W. Written out rather than
    ``F.batch_norm``, whose sum order and variance form differ from the
    JAX package's ``bn_apply``. Inside ``shard_context`` the moments and
    n are the whole sharded batch's, and the buffers move once, in rank
    0's thread."""
    yf = y.float()
    batch_mean, batch_var, n = _batch_moments(yf)
    member = bands.mesh_member()
    if member is None or member[1] == 0:
        with torch.no_grad():
            unbiased = batch_var * (n / max(n - 1, 1))
            mean.copy_((1 - BN_MOMENTUM) * mean + BN_MOMENTUM * batch_mean)
            var.copy_((1 - BN_MOMENTUM) * var + BN_MOMENTUM * unbiased)
    inv = torch.rsqrt(batch_var + BN_EPS) * scale
    shift = bias - batch_mean * inv
    return (yf * inv[:, None, None] + shift[:, None, None]).to(y.dtype)


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
        y = bands.conv2d(x, self.w.to(x.dtype), groups=self.groups)
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
        self.eval()

    def bn(self, y):
        norm = bn_train if self.training else bn_eval
        return norm(y, self.scale, self.bias, self.mean, self.var)

    def forward(self, x):
        y = bands.conv2d(x, self.w.to(x.dtype), stride=self.stride,
                         padding=self.padding, dilation=self.dilation,
                         groups=self.groups)
        return ACTIVATIONS[self.act](self.bn(y))
