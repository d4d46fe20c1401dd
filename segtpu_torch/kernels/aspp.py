"""The dense convolutions of DeepLab-v3's ASPP head on the tensor cores
(``csrc/aspp.cu``), and their plain twin.

``aspp_chw(x, weights, biases, dilations, vec)`` runs up to four
branches over one input x [B, Cin, H, W], branch i a k x k convolution
(k 1 or 3, OIHW ``weights[i]`` with BatchNorm folded) at
``dilations[i]`` with zero padding ``dilations[i] * (k // 2)``, and
returns their outputs concatenated along channels [B, sum Cout_i, H, W]
in x's dtype:

    out[:, off_i + o] = round(relu(conv_i(x)[:, o] + biases[i][o]
                                   + vec[:, off_i + o]))

``vec`` [B, sum Cout_i] f32 is optional (the pooled branch's share of
the projection, constant over the map). Numerics: weights rounded to
x's dtype, products exact, sums in f32, then + bias, + vec and the ReLU
in f32, one rounding. The head (``models/aspp_decoder.py``)
calls it twice: the 1x1 branch and the three atrous branches in one
launch, then the projection (k = 1 over their concatenation, ``vec``
the pooled branch).

On a CUDA tensor the wrapper launches ``aspp_kernel`` (bf16 only;
``aspp_chw.launches``), with each weight packed by ``pack_weights``
(``packed=``, made once by the folded head) or packed for the call; the
kernel sums 16 exact products at a time in the tensor cores' f32 order,
so it matches the twin to a tolerance, not bit for bit. The twin
(``aspp_chw_plain``, same signature) sums over channels, then taps, in
ascending order in f32, as ``chw_ops.conv_chw_plain`` does.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from segtpu_torch.core.layers import relu
from segtpu_torch.kernels.chw_ops import (_check_packed, _dense_sum, _launch,
                                          _pads, _ptrs, _taps, _tc_operand,
                                          _use_plain)

MAX_BRANCHES = 4      # branches a launch takes (csrc/aspp.cu kMaxBranches)
_KC = 32              # input channels of a stage (kKC)
_TM = 128             # pixels of a tile (kTM)
_TN = 128             # output channels of a tile (kTN)
_XP = _KC + 8         # pitch of the staged input and weights (kXP)
_OP = _TM + 8         # pitch of the epilogue's output (kOP)


def aspp_halo(ks, dilations) -> int:
    """Columns staged each side of a tile: the widest branch's reach
    ``d * (k // 2)``, rounded up to 8 (16-byte runs of bf16)."""
    return max(-(-d * (k // 2) // 8) * 8 for k, d in zip(ks, dilations))


def aspp_smem(halo: int, kmax: int) -> int:
    """Shared bytes of an ``aspp_kernel`` block (csrc/aspp.cu
    ``smem_bytes``): two raw input rows [32][128 + 2 halo], their copy
    channel-innermost [128 + 2 halo][40], two buffers of a tap row's
    weights [kmax][128][40], all bf16; at least the epilogue's
    [128][136]."""
    nc = _TM + 2 * halo
    stages = 2 * _KC * nc + nc * _XP + 2 * kmax * _TN * _XP
    return 2 * max(stages, _TN * _OP)


def _geometry(x, weights, biases, dilations, vec):
    if x.ndim != 4:
        raise ValueError(f"aspp_chw takes x [B, C, H, W], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"aspp_chw computes in bf16 or f32, not {x.dtype}")
    n = len(weights)
    if not 1 <= n <= MAX_BRANCHES or len(biases) != n or \
            len(dilations) != n:
        raise ValueError(f"aspp_chw takes 1 to {MAX_BRANCHES} branches, each "
                         f"a weight, a bias and a dilation")
    b, c, h, w = x.shape
    ks = []
    for wt, bias, d in zip(weights, biases, dilations):
        cout, cin, kh, kw = wt.shape
        if cin != c or kh != kw or kh not in (1, 3) or int(d) < 1:
            raise ValueError(f"aspp_chw branch weight must be OIHW "
                             f"[Cout, {c}, k, k] with k 1 or 3 and a "
                             f"dilation >= 1, got {tuple(wt.shape)} at {d}")
        if tuple(bias.shape) != (cout,):
            raise ValueError(f"bias must be [{cout}], got "
                             f"{tuple(bias.shape)}")
        ks.append(kh)
    ctot = sum(wt.shape[0] for wt in weights)
    if vec is not None and tuple(vec.shape) != (b, ctot):
        raise ValueError(f"vec must be {(b, ctot)}, got {tuple(vec.shape)}")
    return b, c, h, w, ctot, ks


def aspp_chw_plain(x, weights, biases, dilations, vec=None, *,
                   packed=None):
    """Plain PyTorch version of ``aspp_chw`` (same signature and
    numerics; its f32 sums over channels, then taps, ascending)."""
    *_, h, w = x.shape
    _, _, _, _, _, ks = _geometry(x, weights, biases, dilations, vec)
    xf = x.float()
    outs, off = [], 0
    for wt, bias, d, k in zip(weights, biases, dilations, ks):
        lo, hi = _pads(k, int(d))
        taps = _taps(F.pad(xf, (lo, hi, lo, hi)), k, int(d), 1, (h, w))
        y = _dense_sum(taps, wt.to(x.dtype).float()) \
            + bias.float()[:, None, None]
        cout = wt.shape[0]
        if vec is not None:
            y = y + vec.float()[:, off:off + cout, None, None]
        outs.append(relu(y).to(x.dtype))
        off += cout
    return torch.cat(outs, 1)


@functools.lru_cache(maxsize=None)
def _aspp_entry():
    from segtpu_torch.kernels._build import load
    fn = load("aspp").segtpu_aspp
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _ints(vs):
    return (ctypes.c_int * len(vs))(*vs)


def _aspp_launch(x, weights, biases, dilations, vec, packed):
    """The kernel on checked CUDA operands: the 3x3 branches first (their
    blocks start first), each writing its own channels of the output."""
    b, c, h, w, ctot, ks = _geometry(x, weights, biases, dilations, vec)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"aspp_chw's kernel computes in bf16 (tensor "
                         f"cores), got {x.dtype}")
    if c % _KC:
        raise ValueError(f"aspp_chw's kernel takes input channels in "
                         f"multiples of {_KC}, got {c}")
    if any(wt.shape[0] % 8 for wt in weights):
        raise ValueError("aspp_chw's kernel takes output channels in "
                         "multiples of 8")
    if not x.is_contiguous():
        raise ValueError("aspp_chw kernel needs a contiguous x")
    dev = x.device
    packed = packed or [None] * len(weights)
    offs, at = [], 0
    for wt in weights:
        offs.append(at)
        at += wt.shape[0]
    order = sorted(range(len(weights)), key=lambda i: -ks[i])
    ops = [_tc_operand([weights[i]], packed[i], dev, "aspp_chw")
           for i in order]
    bs = [biases[i].to(device=dev, dtype=torch.float32).contiguous()
          for i in order]
    vk = None if vec is None else vec.to(dev, torch.float32).contiguous()
    halo = aspp_halo(ks, [int(d) for d in dilations])
    kmax = max(ks)
    out = torch.empty((b, ctot, h, w), dtype=x.dtype, device=dev)
    # the C arrays live until the call returns
    arrays = [_ptrs(ops), _ptrs(bs), _ints([ks[i] for i in order]),
              _ints([int(dilations[i]) for i in order]),
              _ints([weights[i].shape[0] for i in order]),
              _ints([offs[i] for i in order])]
    rc = _launch(_aspp_entry(), x, x.data_ptr(),
                 *[ctypes.addressof(a) for a in arrays], len(order),
                 None if vk is None else vk.data_ptr(), out.data_ptr(), b, c,
                 h, w, ctot, halo, kmax, aspp_smem(halo, kmax))
    if rc != 0:
        raise RuntimeError(f"aspp_chw kernel launch failed: CUDA error {rc}")
    return out


def aspp_chw(x, weights, biases, dilations, vec=None, *, packed=None,
             use_kernels: bool = True):
    """Branches of k x k convolutions (k 1 or 3) at their dilations over
    x [B, Cin, H, W], + bias (+ vec [B, sum Cout] f32), ReLU,
    concatenated: [B, sum Cout, H, W] in x's dtype (see the module doc). ``packed``: ``pack_weights`` of each weight, or None.
    On a CUDA tensor this launches the tensor-core kernel (bf16;
    ``aspp_chw.launches``)."""
    if packed is not None:
        for wt, pk in zip(weights, packed):
            _check_packed(pk, tuple(wt.shape), "aspp_chw")
    if _use_plain(x, use_kernels, "aspp_chw"):
        return aspp_chw_plain(x, weights, biases, dilations, vec)
    out = _aspp_launch(x, weights, biases, dilations, vec, packed)
    aspp_chw.launches += 1
    return out


aspp_chw.launches = 0

