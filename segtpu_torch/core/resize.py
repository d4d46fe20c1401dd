"""Exact bilinear resize (counterpart: segtpu/core/resize.py).

The two separable 1-D interpolation matrices are built explicitly, in
float64 and stored as float32, exactly as the JAX package builds them,
and applied as two dense products (H first, then W). The upsample
kernel's tap tables are read from the same matrices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from segtpu_torch.core import bands


@functools.lru_cache(maxsize=None)
def _interp_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """[n_out, n_in] row-stochastic 2-tap bilinear interpolation matrix.

    align_corners=True :  src = o * (n_in-1)/(n_out-1)
    align_corners=False:  src = (o+0.5) * n_in/n_out - 0.5, clamped
    """
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float32)
    out = np.arange(n_out, dtype=np.float64)
    if align_corners:
        src = out * (n_in - 1) / max(n_out - 1, 1)
    else:
        src = np.clip((out + 0.5) * n_in / n_out - 0.5, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    lo = np.minimum(lo, n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = (src - lo).astype(np.float64)
    mat = np.zeros((n_out, n_in), dtype=np.float64)
    mat[np.arange(n_out), lo] += 1.0 - w_hi
    mat[np.arange(n_out), hi] += w_hi
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _interp_tensor(n_in: int, n_out: int, align_corners: bool, device,
                   dtype) -> torch.Tensor:
    """``_interp_matrix`` as a tensor on ``device``, copied there once: a
    resize then launches no host-to-device copy (which a CUDA graph's
    capture refuses). Read only; made outside inference mode, so that
    autograd may save it whichever mode the first resize ran in."""
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_matrix(
            n_in, n_out, align_corners)).to(device, dtype)


@functools.lru_cache(maxsize=None)
def _rows_read(n_in: int, n_out: int, align_corners: bool, lo: int,
               hi: int):
    """[first, last + 1) of the input rows that output rows [lo, hi) of
    ``_interp_matrix`` weigh (an empty band reads none)."""
    cols = np.flatnonzero(_interp_matrix(n_in, n_out, align_corners)
                          [lo:hi].any(0))
    return (int(cols[0]), int(cols[-1]) + 1) if cols.size else (0, 0)


def resize_bilinear(x, out_hw, *, align_corners: bool = True,
                    compute_dtype=torch.float32):
    """Bilinear-resize the two spatial dims of an [N, C, H, W] tensor,
    like ``F.interpolate(mode='bilinear')``; computed in
    ``compute_dtype`` and returned in x's dtype. On a band of rows
    (``core.bands``) ``out_hw`` is the global size: this shard's band of
    the output, from the global matrix's rows for it and the input rows
    they read, gathered from the row."""
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    view = bands.gather(x)
    h_in, w_in = x.shape[-2] if view is None else view.h, x.shape[-1]
    if (h_in, w_in) == (h_out, w_out):
        return x
    ah = _interp_tensor(h_in, h_out, align_corners, x.device, compute_dtype)
    aw = _interp_tensor(w_in, w_out, align_corners, x.device, compute_dtype)
    if view is not None:
        lo, hi = view.band(h_out)
        first, last = _rows_read(h_in, h_out, align_corners, lo, hi)
        ah, x = ah[lo:hi, first:last], view.rows(first, last)
    y = torch.matmul(ah, x.to(compute_dtype))      # [.., Ho, Wi]
    y = torch.matmul(y, aw.t())                    # [.., Ho, Wo]
    return y.to(x.dtype)
