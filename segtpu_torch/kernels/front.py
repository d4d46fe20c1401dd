"""Fused normalize + space-to-depth front
(counterpart: segtpu/kernels/front.py::normalize_s2d_front).

``normalize_s2d_front`` launches the CUDA kernel (csrc/front.cu) on a
CUDA tensor and runs ``normalize_s2d_front_plain`` on a CPU tensor, or
on a CUDA tensor when the caller passes ``use_kernels=False``. Both
compute the same function with the same rounding order:

    uint8 [N, H, W, 3] (H, W even) -> [N, 12, Hp/2, Wp/2]

Channel c = (dy, dx, rgb) row-major reads pixel (2i+dy, 2j+dx, rgb);
the margin beyond (H/2, W/2) is zero (the engine's pad-to-stride).
bf16 is bit-identical to the TPU kernel: the scale folded into a bf16
weight, one rounded product, then a bf16 bias add. f32 is
``(u8 * IMG_SCALE - mean) / std`` in f32.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from segtpu_torch.kernels._build import count_launch
from segtpu_torch.utils.helpers import IMG_MEAN, IMG_SCALE, IMG_STD


@functools.lru_cache(maxsize=None)
def front_constants():
    """Per-channel constants of the 12 s2d channels, as float32 numpy:
    (bf16 scale, bf16 bias, mean, std, IMG_SCALE). The bf16 values are
    rounded to nearest-even from the float32 values the JAX kernel
    folds (``IMG_SCALE / std`` and ``-mean / std`` in float32)."""
    mean12 = np.tile(IMG_MEAN, 4)
    std12 = np.tile(IMG_STD, 4)
    scale = np.float32(IMG_SCALE) / std12
    bias = -mean12 / std12

    def to_bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    return (to_bf16(scale), to_bf16(bias), mean12, std12,
            np.float32(IMG_SCALE))


class _FrontConsts(ctypes.Structure):
    _fields_ = [("scale", ctypes.c_float * 12), ("bias", ctypes.c_float * 12),
                ("mean", ctypes.c_float * 12), ("stdv", ctypes.c_float * 12),
                ("img_scale", ctypes.c_float)]


def _geometry(img_u8, padded_hw):
    if img_u8.dtype != torch.uint8 or img_u8.ndim != 4 or img_u8.shape[-1] != 3:
        raise ValueError(f"front takes uint8 [N, H, W, 3], got "
                         f"{img_u8.dtype} {tuple(img_u8.shape)}")
    n, h, w, _ = img_u8.shape
    hp, wp = (h, w) if padded_hw is None else (int(padded_hw[0]),
                                               int(padded_hw[1]))
    if h % 2 or w % 2 or hp % 2 or wp % 2 or hp < h or wp < w:
        raise ValueError(f"front needs even H, W and an even padded size "
                         f">= them, got {(h, w)} -> {(hp, wp)}")
    return n, h // 2, w // 2, hp // 2, wp // 2


def normalize_s2d_front_plain(img_u8, *, padded_hw=None,
                              out_dtype=torch.bfloat16):
    """Plain PyTorch version of the front (same signature, same bits)."""
    n, h2, w2, hp2, wp2 = _geometry(img_u8, padded_hw)
    x = img_u8.reshape(n, h2, 2, w2, 2, 3).permute(0, 2, 4, 5, 1, 3)
    x = x.reshape(n, 12, h2, w2).float()
    scale, bias, mean, std, img_scale = (
        torch.as_tensor(np.asarray(c), device=img_u8.device)[..., None, None]
        for c in front_constants())
    if out_dtype == torch.bfloat16:
        y = (x * scale).to(torch.bfloat16)
        y = (y.float() + bias).to(torch.bfloat16)
    elif out_dtype == torch.float32:
        y = (x * img_scale - mean) / std
    else:
        raise ValueError(f"front computes bf16 or f32, not {out_dtype}")
    return F.pad(y, (0, wp2 - w2, 0, hp2 - h2))


def normalize_s2d_front(img_u8, *, padded_hw=None, out_dtype=torch.bfloat16,
                        use_kernels: bool = True):
    """uint8 [N, H, W, 3] -> normalized s2d planes [N, 12, Hp/2, Wp/2].

    On a CUDA tensor this launches the CUDA kernel (counted in
    ``normalize_s2d_front.launches``); on a CPU tensor, or with
    ``use_kernels=False``, it runs the plain version."""
    if img_u8.device.type == "cpu" or (img_u8.device.type == "cuda"
                                       and not use_kernels):
        return normalize_s2d_front_plain(img_u8, padded_hw=padded_hw,
                                         out_dtype=out_dtype)
    if img_u8.device.type != "cuda":
        raise ValueError(f"front runs on cuda or cpu, not {img_u8.device}")
    n, h2, w2, hp2, wp2 = _geometry(img_u8, padded_hw)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"front computes bf16 or f32, not {out_dtype}")
    if not img_u8.is_contiguous():
        raise ValueError("front kernel needs a contiguous uint8 image")
    from segtpu_torch.kernels._build import load
    lib = load("front")
    fn = lib.segtpu_front
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
        ctypes.POINTER(_FrontConsts), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scale, bias, mean, std, img_scale = front_constants()
    consts = _FrontConsts((ctypes.c_float * 12)(*scale),
                          (ctypes.c_float * 12)(*bias),
                          (ctypes.c_float * 12)(*mean),
                          (ctypes.c_float * 12)(*std), float(img_scale))
    out = torch.empty((n, 12, hp2, wp2), dtype=out_dtype,
                      device=img_u8.device)
    with torch.cuda.device(img_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(img_u8.data_ptr(), out.data_ptr(), n, h2, w2, hp2, wp2,
                int(out_dtype == torch.bfloat16), ctypes.byref(consts), stream)
    count_launch()
    if rc != 0:
        raise RuntimeError(f"front kernel launch failed: CUDA error {rc}")
    normalize_s2d_front.launches += 1
    return out


normalize_s2d_front.launches = 0
