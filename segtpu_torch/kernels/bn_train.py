"""Train-mode BatchNorm and the activation that follows it, as one
``torch.autograd.Function`` whose forward and backward are two CUDA
kernels each (csrc/bn_train.cu).

``bn_act_train(y, scale, bias, mean, var, act)`` is
``ACTIVATIONS[act](core.layers.bn_train(y, scale, bias, mean, var))``:
the batch's mean and two-pass-stable biased variance normalize ``y``
over N, H, W in f32, the running buffers ``mean`` and ``var`` move in
place, and the output is in ``y``'s dtype. Which of two paths runs is
``bn_route(y)``, read from the input alone:

* ``"kernel"``: ``y`` is a CUDA tensor, not a ``torch.func`` transform's
  wrapper, outside ``core.bands.shard_context``. ``_BnActTrain`` runs
  the kernels ``stats`` and ``normalize`` forward and ``grad_stats`` and
  ``grad_input`` backward (4 launches a call, ``bn_act_train.launches``),
  and saves ``y``, the batch mean and invstd (and the two [C] parameters
  the backward reads), no other full-size tensor. f32 or bf16,
  NCHW-contiguous; anything else raises.
* ``"plain"``: on the CPU; under the population search's
  ``torch.func.vmap`` (a ctypes kernel has no batching rule); inside
  ``shard_context``, where the moments meet every shard's between the
  two passes. It is the composition above, ``layers.bn_train`` looked up
  at call time.

``core.layers.BN_TRAIN_ROUTES`` counts the calls of each route. The
forward is one ``segtpu.train.bn`` span on either route: on the kernel
route it covers the activation too, on the plain route it is
``bn_train``'s own.

``bn_act_backward_plain`` is the backward written in PyTorch, the twin of
``grad_stats`` + ``grad_input``; ``batch_stats_plain`` the mean and
invstd the forward saves. Only the order of the sums differs between the
kernels and their twins.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from segtpu_torch.core import bands, layers
from segtpu_torch.kernels.chw_ops import _launch
from segtpu_torch.utils.profiling import span

THREADS = 256                 # csrc/bn_train.cu kThreads
UNROLL = 4                    # kUnroll: vectors a thread loads at once
RESIDENT_BLOCKS = 132 * 8     # 256-thread blocks the H100's 132 SMs hold
WAVES = 4                     # of them a launch aims at
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODE = {"none": 0, "relu": 1, "relu6": 2}
_COUNT = threading.Lock()     # the routes and launches, from any thread


class BnPlan(NamedTuple):
    vec: int      # elements a load takes: 16 bytes' worth, or 1
    blocks: int   # P: blocks a channel (the grid is C x P)
    chunk: int    # vectors a block sweeps


def bn_plan(shape, itemsize: int, aligned: bool) -> BnPlan:
    """The kernels' plan for an [N, C, H, W] tensor of ``itemsize``-byte
    elements: 16-byte vectors where H*W holds whole ones and every
    pointer is 16-byte aligned, and P blocks a channel so that the C x P
    grid fills the card ``WAVES`` times over, each block at least one
    sweep of ``THREADS * UNROLL`` vectors; no block is empty."""
    n, c, h, w = shape
    vec = 16 // itemsize
    if not aligned or (h * w) % vec:
        vec = 1
    total = n * h * w // vec
    blocks = min(math.ceil(WAVES * RESIDENT_BLOCKS / c),
                 math.ceil(total / (THREADS * UNROLL)), 65535)
    chunk = math.ceil(total / max(blocks, 1))
    return BnPlan(vec, math.ceil(total / chunk), chunk)


def _on_card(y) -> bool:
    return y.device.type == "cuda"


def bn_route(y) -> str:
    """``"kernel"`` for a CUDA tensor that no ``torch.func`` transform
    wraps, outside ``shard_context``; ``"plain"`` otherwise."""
    if (_on_card(y)
            and not torch._C._functorch.is_functorch_wrapped_tensor(y)
            and bands.mesh_member() is None):
        return "kernel"
    return "plain"


def bn_act_train_plain(y, scale, bias, mean, var, act: str):
    """Today's composition: ``layers.bn_train`` then the activation."""
    return layers.ACTIVATIONS[act](layers.bn_train(y, scale, bias, mean, var))


def batch_stats_plain(y):
    """(batch mean, invstd) as ``bn_train`` computes them, in f32 (f64 for
    an f64 ``y``): what the kernel route's forward saves."""
    yf = y.to(torch.promote_types(y.dtype, torch.float32))
    batch_mean = yf.mean((0, 2, 3))
    batch_var = (yf - batch_mean[:, None, None]).square().mean((0, 2, 3))
    return batch_mean, torch.rsqrt(batch_var + layers.BN_EPS)


def _passes(z, act: str):
    """Where ``torch.clamp``'s backward passes the gradient (the bounds
    included)."""
    if act == "relu":
        return z >= 0
    if act == "relu6":
        return (z >= 0) & (z <= 6)
    return torch.ones_like(z, dtype=torch.bool)


def bn_act_backward_plain(dy, y, batch_mean, invstd, scale, bias, act: str):
    """The kernels' backward in PyTorch: (dx in y's dtype, dscale,
    dbias). z = y * inv + shift is recomputed as the forward computes it
    and rounded to y's dtype for the activation's mask; g = dy where it
    passes; x_hat = (y - mean) * invstd; ``dscale = sum(g x_hat)``,
    ``dbias = sum(g)``, ``dx = scale * invstd * (g - sum(g) / n - x_hat
    sum(g x_hat) / n)`` with n = N*H*W."""
    acc = torch.promote_types(y.dtype, torch.float32)
    yf, dyf = y.to(acc), dy.to(acc)
    inv = invstd * scale
    shift = bias - batch_mean * inv
    z = (yf * inv[:, None, None] + shift[:, None, None]).to(y.dtype)
    g = torch.where(_passes(z, act), dyf, torch.zeros((), dtype=acc))
    xhat = (yf - batch_mean[:, None, None]) * invstd[:, None, None]
    n = y.numel() // y.shape[1]
    sum_g = g.sum((0, 2, 3))
    sum_gx = (g * xhat).sum((0, 2, 3))
    dx = inv[:, None, None] * (g - (sum_g / n)[:, None, None]
                               - xhat * (sum_gx / n)[:, None, None])
    return dx.to(y.dtype), sum_gx, sum_g


@functools.lru_cache(maxsize=None)
def _entry(name: str, n_ptrs: int, n_ints: int, n_floats: int):
    """The C entry ``segtpu_bn_<name>``: ``n_ptrs`` pointers, ``n_ints``
    ints, ``n_floats`` floats, the stream."""
    from segtpu_torch.kernels._build import load
    fn = getattr(load("bn_train"), f"segtpu_bn_{name}")
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _call(name, ptrs, ints, floats, t):
    """Launch ``segtpu_bn_<name>`` on ``t``'s device and current stream;
    raise on a CUDA error."""
    fn = _entry(name, len(ptrs), len(ints), len(floats))
    rc = _launch(fn, t, *[p.data_ptr() for p in ptrs], *ints, *floats)
    if rc != 0:
        raise RuntimeError(f"bn_train {name} kernel launch failed: CUDA "
                           f"error {rc}")
    with _COUNT:
        _COUNTED.launches += 1


def _checked(y, scale, bias, mean, var):
    """(N, C, H*W) of a kernel-route call, after checking its operands
    (raises on what the kernels do not take)."""
    if y.ndim != 4:
        raise ValueError(f"bn_act_train takes y [N, C, H, W], got "
                         f"{tuple(y.shape)}")
    if y.dtype not in _DTYPE_CODE:
        raise ValueError(f"bn_act_train's kernels take f32 or bf16, not "
                         f"{y.dtype}")
    if not y.is_contiguous():
        raise ValueError("bn_act_train's kernels take an NCHW-contiguous y")
    n, c, h, w = y.shape
    for name, t in (("scale", scale), ("bias", bias), ("mean", mean),
                    ("var", var)):
        if (t.device != y.device or t.dtype != torch.float32
                or tuple(t.shape) != (c,) or not t.is_contiguous()):
            raise ValueError(f"bn_act_train's {name} must be f32 [{c}] on "
                             f"{y.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if n * h * w >= 2 ** 31:
        raise ValueError(f"bn_act_train's kernels take fewer than 2**31 "
                         f"values a channel, got {n * h * w}")
    return n, c, h * w


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


class _BnActTrain(torch.autograd.Function):
    """The kernel route (module doc): grads for y, scale and bias."""

    @staticmethod
    def forward(ctx, y, scale, bias, mean, var, act):
        n, c, hw = _checked(y, scale, bias, mean, var)
        out = torch.empty_like(y)
        plan = bn_plan(y.shape, y.element_size(), _aligned(y, out))
        part = torch.empty((3, c, plan.blocks), dtype=torch.float32,
                           device=y.device)
        batch_mean = torch.empty(c, dtype=torch.float32, device=y.device)
        invstd = torch.empty_like(batch_mean)
        ints = (n, c, hw, _DTYPE_CODE[y.dtype], int(plan.vec > 1),
                plan.blocks, plan.chunk)
        count = n * hw
        _call("stats", (y, part), ints, (), y)
        _call("normalize", (y, out, part, scale, bias, mean, var, batch_mean,
                            invstd), ints + (_ACT_CODE[act],),
              (float(count), layers.BN_EPS, layers.BN_MOMENTUM,
               count / max(count - 1, 1)), y)
        ctx.save_for_backward(y, batch_mean, invstd, scale, bias)
        ctx.act = act
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        y, batch_mean, invstd, scale, bias = ctx.saved_tensors
        dy = dout.contiguous()
        if dy.dtype != y.dtype:
            raise ValueError(f"bn_act_train's gradient is {dy.dtype}, its "
                             f"input {y.dtype}")
        n, c, h, w = y.shape
        dx = torch.empty_like(y)
        plan = bn_plan(y.shape, y.element_size(), _aligned(y, dy, dx))
        part = torch.empty((2, c, plan.blocks), dtype=torch.float32,
                           device=y.device)
        dscale = torch.empty_like(scale)
        dbias = torch.empty_like(bias)
        ints = (n, c, h * w, _DTYPE_CODE[y.dtype], int(plan.vec > 1),
                plan.blocks, plan.chunk, _ACT_CODE[ctx.act])
        _call("grad_stats", (dy, y, batch_mean, invstd, scale, bias, part),
              ints, (), y)
        _call("grad_input", (dy, y, part, batch_mean, invstd, scale, bias, dx,
                             dscale, dbias), ints, (float(n * h * w),), y)
        return dx, dscale, dbias, None, None, None


def bn_act_train(y, scale, bias, mean, var, act: str):
    """``ACTIVATIONS[act](bn_train(y, scale, bias, mean, var))`` on the
    route ``bn_route(y)`` gives (module doc), counted in
    ``core.layers.BN_TRAIN_ROUTES``."""
    route = bn_route(y)
    with _COUNT:
        layers.BN_TRAIN_ROUTES[route] += 1
    if route == "plain":
        return bn_act_train_plain(y, scale, bias, mean, var, act)
    with span("segtpu.train.bn", device=y.device):
        return _BnActTrain.apply(y, scale, bias, mean, var, act)


bn_act_train.launches = 0
# _call counts here even while a spy takes the name bn_act_train
_COUNTED = bn_act_train
