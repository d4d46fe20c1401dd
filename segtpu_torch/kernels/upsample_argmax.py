"""Fused bilinear upsample + argmax mask decode
(counterpart: segtpu/kernels/upsample_argmax.py::upsample_argmax and
::upsample_argmax_flat).

``upsample_argmax`` launches the CUDA kernel (csrc/upsample_argmax.cu)
on a CUDA tensor and runs ``upsample_argmax_plain`` on a CPU tensor, or
on a CUDA tensor when the caller passes ``use_kernels=False``. Both
compute, bit for bit,

    argmax_k(bilinear(logits, out_hw)[:, k, :crop_h, :crop_w])

for channel-first logits [B, K, h, w], in the TPU kernel's order: the H
pass first (in bf16 mode with bf16 H weights and a bf16-rounded
result), then the f32 W pass, then a strict-greater running argmax from
-inf (ties to the lower class). The 2-tap weights are the float32
entries of ``_interp_matrix`` for the padded grid, cropped — equal to
upsampling to the grid and cropping after.

``upsample_argmax_flat`` takes the logits as [B, K, h*w] (the same
memory) and runs the W pass first, as the JAX package's flat tail does,
with its own kernel and plain twin.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from segtpu_torch.core.resize import _interp_matrix


@functools.lru_cache(maxsize=None)
def interp_taps(n_in: int, n_out: int, align_corners: bool, n_keep: int,
                bf16_weights: bool):
    """2-tap tables of the first ``n_keep`` rows of ``_interp_matrix``:
    (taps int32 [2, n_keep], weights float32 [2, n_keep]) — low tap,
    then high tap. A row with one (merged) entry gets weight 0 on its
    high tap. ``bf16_weights`` rounds the weights to bf16."""
    mat = _interp_matrix(n_in, n_out, align_corners)[:n_keep]
    taps = np.zeros((2, n_keep), np.int32)
    wts = np.zeros((2, n_keep), np.float32)
    for o, row in enumerate(mat):
        nz = np.flatnonzero(row)
        if not 1 <= nz.size <= 2:
            raise ValueError(f"interp row {o} has {nz.size} taps")
        taps[:, o] = nz[0], nz[-1]
        wts[0, o] = row[nz[0]]
        wts[1, o] = row[nz[-1]] if nz.size == 2 else 0.0
    if bf16_weights:
        wts = torch.from_numpy(wts).to(torch.bfloat16).float().numpy()
    return taps, wts


def _tables(logits, out_hw, crop_hw, align_corners):
    if logits.ndim != 4:
        raise ValueError(f"tail takes [B, K, h, w] logits, got "
                         f"{tuple(logits.shape)}")
    if logits.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"tail takes bf16 or f32 logits, not {logits.dtype}")
    _, k, h, w = logits.shape
    if not 1 <= k <= 256:
        raise ValueError(f"a uint8 mask holds at most 256 classes, got {k}")
    grid_h, grid_w = int(out_hw[0]), int(out_hw[1])
    ho, wo = (int(crop_hw[0]), int(crop_hw[1])) if crop_hw else (grid_h,
                                                                   grid_w)
    if not (0 < ho <= grid_h and 0 < wo <= grid_w):
        raise ValueError(f"crop {(ho, wo)} outside the grid {(grid_h, grid_w)}")
    bf16 = logits.dtype == torch.bfloat16
    rows, rw = interp_taps(h, grid_h, align_corners, ho, bf16)
    cols, cw = interp_taps(w, grid_w, align_corners, wo, False)
    return ho, wo, rows, rw, cols, cw


def upsample_argmax_plain(logits, out_hw, *, crop_hw=None,
                          align_corners: bool = True):
    """Plain PyTorch version of the tail (same signature, same bits)."""
    ho, wo, rows, rw, cols, cw = _tables(logits, out_hw, crop_hw,
                                         align_corners)
    dev = logits.device
    rows, cols = (torch.from_numpy(t).long().to(dev) for t in (rows, cols))
    rw, cw = (torch.from_numpy(t).to(dev) for t in (rw, cw))
    b, k = logits.shape[:2]
    x = logits.float()
    # H pass at every input column: [B, K, Ho, w]
    t = x[:, :, rows[0], :] * rw[0, :, None] + x[:, :, rows[1], :] * rw[1, :, None]
    if logits.dtype == torch.bfloat16:
        t = t.to(torch.bfloat16).float()
    best = torch.full((b, ho, wo), -float("inf"), device=dev)
    idx = torch.zeros((b, ho, wo), dtype=torch.uint8, device=dev)
    for kk in range(k):
        tk = t[:, kk]
        v = tk[:, :, cols[0]] * cw[0] + tk[:, :, cols[1]] * cw[1]
        upd = v > best
        best = torch.where(upd, v, best)
        idx.masked_fill_(upd, kk)
    return idx


@functools.lru_cache(maxsize=16)
def _device_tables(h: int, w: int, grid_h: int, grid_w: int, ho: int, wo: int,
                   align_corners: bool, bf16: bool, device: torch.device):
    """The tap tables of one call geometry, uploaded once per device."""
    rows, rw = interp_taps(h, grid_h, align_corners, ho, bf16)
    cols, cw = interp_taps(w, grid_w, align_corners, wo, False)
    return tuple(torch.from_numpy(t).to(device) for t in (rows, rw, cols, cw))


def upsample_argmax(logits, out_hw, *, crop_hw=None,
                    align_corners: bool = True, use_kernels: bool = True):
    """[B, K, h, w] logits -> uint8 mask [B, Ho, Wo] (see module doc).

    On a CUDA tensor this launches the CUDA kernel (counted in
    ``upsample_argmax.launches``); on a CPU tensor, or with
    ``use_kernels=False``, it runs the plain version."""
    if logits.device.type == "cpu" or (logits.device.type == "cuda"
                                       and not use_kernels):
        return upsample_argmax_plain(logits, out_hw, crop_hw=crop_hw,
                                     align_corners=align_corners)
    if logits.device.type != "cuda":
        raise ValueError(f"tail runs on cuda or cpu, not {logits.device}")
    ho, wo, *_ = _tables(logits, out_hw, crop_hw, align_corners)
    if not logits.is_contiguous():
        raise ValueError("tail kernel needs contiguous logits")
    b, k, h, w = logits.shape
    bf16 = logits.dtype == torch.bfloat16
    rows, rw, cols, cw = _device_tables(h, w, int(out_hw[0]), int(out_hw[1]),
                                        ho, wo, align_corners, bf16,
                                        logits.device)
    from segtpu_torch.kernels._build import load
    fn = load("upsample_argmax").segtpu_upsample_argmax
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 + [
        ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    out = torch.empty((b, ho, wo), dtype=torch.uint8, device=logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(logits.data_ptr(), out.data_ptr(), b, k, h, w, ho, wo,
                int(bf16), rows.data_ptr(), rw.data_ptr(), cols.data_ptr(),
                cw.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"upsample_argmax kernel launch failed: CUDA "
                           f"error {rc}")
    upsample_argmax.launches += 1
    return out


upsample_argmax.launches = 0


def flat_tail_profitable(dec_w: int) -> bool:
    """Where the JAX engine takes the W-first tail: decoder widths that
    are multiples of 128 and at most 128 (the engine mirrors its rule)."""
    return dec_w % 128 == 0 and dec_w <= 128


def _flat_geometry(logits_flat, in_hw, out_hw, crop_hw, align_corners):
    if logits_flat.ndim != 3:
        raise ValueError(f"flat tail takes [B, K, h*w] logits, got "
                         f"{tuple(logits_flat.shape)}")
    b, k, hw = logits_flat.shape
    h, w = int(in_hw[0]), int(in_hw[1])
    if h * w != hw:
        raise ValueError(f"in_hw {in_hw} does not match {hw} pixels")
    logits = logits_flat.view(b, k, h, w)
    ho, wo, *_ = _tables(logits, out_hw, crop_hw, align_corners)
    return logits, ho, wo, _flat_device_tables(
        h, w, int(out_hw[0]), int(out_hw[1]), ho, wo, align_corners,
        logits.dtype == torch.bfloat16, logits.device)


def upsample_argmax_flat_plain(logits_flat, in_hw, out_hw, *, crop_hw=None,
                               align_corners: bool = True):
    """Plain PyTorch version of ``upsample_argmax_flat`` (same bits)."""
    logits, ho, wo, (rows, rw, cols, cw) = _flat_geometry(
        logits_flat, in_hw, out_hw, crop_hw, align_corners)
    rows, cols = rows.long(), cols.long()
    dev = logits.device
    b, k = logits.shape[:2]
    x = logits.float()
    # W pass at every input row: [B, K, h, Wo], f32
    z = x[..., cols[0]] * cw[0] + x[..., cols[1]] * cw[1]
    best = torch.full((b, ho, wo), -float("inf"), device=dev)
    idx = torch.zeros((b, ho, wo), dtype=torch.uint8, device=dev)
    for kk in range(k):
        zk = z[:, kk]
        v = zk[:, rows[0], :] * rw[0, :, None] + zk[:, rows[1], :] * rw[1, :, None]
        upd = v > best
        best = torch.where(upd, v, best)
        idx.masked_fill_(upd, kk)
    return idx


def upsample_argmax_flat(logits_flat, in_hw, out_hw, *, crop_hw=None,
                         align_corners: bool = True,
                         use_kernels: bool = True):
    """[B, K, h*w] flat channel-first logits -> uint8 mask [B, Ho, Wo],
    in the W-first order of the JAX package's flat tail: the W pass
    first (bf16 W weights for bf16 logits, f32 result), then the f32 H
    pass, then the argmax (ties to the lower class). On a CUDA tensor
    this launches the CUDA kernel (``upsample_argmax_flat.launches``)."""
    if logits_flat.device.type == "cpu" or (
            logits_flat.device.type == "cuda" and not use_kernels):
        return upsample_argmax_flat_plain(logits_flat, in_hw, out_hw,
                                          crop_hw=crop_hw,
                                          align_corners=align_corners)
    if logits_flat.device.type != "cuda":
        raise ValueError(f"tail runs on cuda or cpu, not {logits_flat.device}")
    logits, ho, wo, (rows, rw, cols, cw) = _flat_geometry(
        logits_flat, in_hw, out_hw, crop_hw, align_corners)
    if not logits.is_contiguous():
        raise ValueError("tail kernel needs contiguous logits")
    b, k, h, w = logits.shape
    bf16 = logits.dtype == torch.bfloat16
    dev = logits.device
    from segtpu_torch.kernels._build import load
    fn = load("upsample_argmax").segtpu_upsample_argmax_flat
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 + [
        ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    out = torch.empty((b, ho, wo), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(logits.data_ptr(), out.data_ptr(), b, k, h, w, ho, wo,
                int(bf16), rows.data_ptr(), rw.data_ptr(), cols.data_ptr(),
                cw.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"upsample_argmax_flat kernel launch failed: CUDA "
                           f"error {rc}")
    upsample_argmax_flat.launches += 1
    return out


@functools.lru_cache(maxsize=16)
def _flat_device_tables(h: int, w: int, grid_h: int, grid_w: int, ho: int,
                        wo: int, align_corners: bool, bf16: bool,
                        device: torch.device):
    """The flat tail's tables on ``device``, built once: f32 H taps, W
    taps bf16-rounded for bf16 logits (the TPU kernel's bf16 W-pass
    operands)."""
    rows, rw = interp_taps(h, grid_h, align_corners, ho, False)
    cols, cw = interp_taps(w, grid_w, align_corners, wo, bf16)
    return tuple(torch.from_numpy(t).to(device) for t in (rows, rw, cols, cw))


upsample_argmax_flat.launches = 0
