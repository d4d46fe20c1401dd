"""Two variants of the normalize + space-to-depth front, from the front
experiments (counterpart: scripts/exp_front_kernel.py::_front_kernel and
scripts/ab_normalize.py::_s2d_kernel).

``front_single_round`` and ``normalize_s2d_nhwc`` launch the CUDA kernels
(csrc/front_ab.cu) on a CUDA tensor, counted in their ``.launches``, and
run their plain twins (``*_plain``) on a CPU tensor. Both take the uint8
[N, H, W, 3] image (H, W even) and give bf16, bit for bit as the TPU
kernels and their twins:

* ``front_single_round`` -> [N, 12, H/2, W/2]:
  ``bf16(u8 * bf16(IMG_SCALE / std) + f32(-mean / std))``, rounded once
  (the production front, ``kernels/front.py``, rounds the product to bf16
  and adds a bf16 bias);
* ``normalize_s2d_nhwc`` -> [N, H/2, W/2, 12]:
  ``bf16((u8 - mean * 255) * (1 / (std * 255)))`` with the A/B script's
  own f32 constants.

Channel ``dy*6 + dx*3 + rgb`` of output pixel (i, j) reads image pixel
(2i + dy, 2j + dx, rgb) in both.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from segtpu_torch.kernels.chw_ops import _launch, _on_cpu
from segtpu_torch.kernels.front import front_constants

# scripts/ab_normalize.py's constants: mean and std times 255 in f32, and
# the reciprocal of the std taken in f32
MEAN255 = np.array([0.485, 0.456, 0.406], np.float32) * np.float32(255.0)
STD255 = np.array([0.229, 0.224, 0.225], np.float32) * np.float32(255.0)
INV_STD255 = np.float32(1.0) / STD255


@functools.lru_cache(maxsize=None)
def ab_constants(nhwc: bool):
    """(a, b) float32 [12] per s2d channel: (bf16 scale, f32 bias) of the
    single-round front, or (mean * 255, 1 / (std * 255)) of the NHWC one."""
    if nhwc:
        return np.tile(MEAN255, 4), np.tile(INV_STD255, 4)
    scale_bf16, _, mean12, std12, _ = front_constants()
    return scale_bf16, (-mean12 / std12).astype(np.float32)


class _AbConsts(ctypes.Structure):
    _fields_ = [("a", ctypes.c_float * 12), ("b", ctypes.c_float * 12)]


def _geometry(img_u8):
    """(N, H, W) of a uint8 [N, H, W, 3] image of even H and W."""
    if img_u8.dtype != torch.uint8 or img_u8.ndim != 4 or img_u8.shape[-1] != 3:
        raise ValueError(f"front takes uint8 [N, H, W, 3], got "
                         f"{img_u8.dtype} {tuple(img_u8.shape)}")
    n, h, w, _ = img_u8.shape
    if h % 2 or w % 2:
        raise ValueError(f"front needs even H and W, got {(h, w)}")
    return n, h, w


def _patches(img_u8):
    """The image as f32 [N, 12, H/2, W/2] s2d planes (exact)."""
    n, h, w = _geometry(img_u8)
    x = img_u8.reshape(n, h // 2, 2, w // 2, 2, 3).permute(0, 2, 4, 5, 1, 3)
    return x.reshape(n, 12, h // 2, w // 2).float()


def _consts_on(nhwc: bool, dev):
    return (torch.as_tensor(c, device=dev)[:, None, None]
            for c in ab_constants(nhwc))


def front_single_round_plain(img_u8):
    """Plain PyTorch version of ``front_single_round`` (same bits)."""
    x = _patches(img_u8)
    scale, bias = _consts_on(False, img_u8.device)
    return (x * scale + bias).to(torch.bfloat16)


def normalize_s2d_nhwc_plain(img_u8):
    """Plain PyTorch version of ``normalize_s2d_nhwc`` (same bits)."""
    x = _patches(img_u8)
    mean, inv = _consts_on(True, img_u8.device)
    return ((x - mean) * inv).to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def _launch_ab(img_u8, nhwc: bool):
    n, h, w = _geometry(img_u8)
    if not img_u8.is_contiguous():
        raise ValueError("front kernel needs a contiguous image")
    shape = (n, h // 2, w // 2, 12) if nhwc else (n, 12, h // 2, w // 2)
    out = torch.empty(shape, dtype=torch.bfloat16, device=img_u8.device)
    a, b = ab_constants(nhwc)
    consts = _AbConsts((ctypes.c_float * 12)(*a), (ctypes.c_float * 12)(*b))
    from segtpu_torch.kernels._build import load
    fn = load("front_ab").segtpu_front_ab
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.POINTER(_AbConsts), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = _launch(fn, img_u8, img_u8.data_ptr(), out.data_ptr(), n, h // 2,
                 w // 2, int(nhwc), ctypes.byref(consts))
    if rc != 0:
        raise RuntimeError(f"front_ab kernel launch failed: CUDA error {rc}")
    return out


def front_single_round(img_u8):
    """uint8 [N, H, W, 3] -> bf16 [N, 12, H/2, W/2], rounded once (see the
    module doc). On a CUDA tensor this launches the kernel
    (``front_single_round.launches``)."""
    if _on_cpu(img_u8, "front_single_round"):
        return front_single_round_plain(img_u8)
    out = _launch_ab(img_u8, nhwc=False)
    front_single_round.launches += 1
    return out


def normalize_s2d_nhwc(img_u8):
    """uint8 [N, H, W, 3] -> bf16 [N, H/2, W/2, 12] (see the module doc).
    On a CUDA tensor this launches the kernel
    (``normalize_s2d_nhwc.launches``)."""
    if _on_cpu(img_u8, "normalize_s2d_nhwc"):
        return normalize_s2d_nhwc_plain(img_u8)
    out = _launch_ab(img_u8, nhwc=True)
    normalize_s2d_nhwc.launches += 1
    return out


front_single_round.launches = 0
normalize_s2d_nhwc.launches = 0
