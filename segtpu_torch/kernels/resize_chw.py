"""Bilinear upsample of a channel-first tensor with a fused add
(counterpart: segtpu/kernels/resize_chw.py::resize_chw_pallas).

``resize_chw`` launches the CUDA kernel (csrc/resize.cu) on a CUDA
tensor and runs ``resize_chw_plain`` on a CPU tensor, or on a CUDA
tensor when the caller passes ``use_kernels=False``. Both compute, bit
for bit, in f32 and rounded once to x's dtype:

    bilinear(x, out_hw) (+ acc) (+ pw_chain(raw, stages))

with the TPU kernel's order: the H pass at the two input columns an
output pixel reads, then the W pass, every product and sum rounded
separately, with the float32 2-tap entries of ``_interp_matrix``.
``acc_chain = (raw, stages)`` is the decoder's identity branch whose
1x1 adapt and aggregate stages run inside the kernel (``pw_chain_chw``
semantics: relu, every stage rounded to the dtype).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from segtpu_torch.core.resize import _interp_matrix
from segtpu_torch.kernels.chw_ops import (_check_x, _ints, _launch, _on,
                                          _ptrs, _use_plain,
                                          pw_chain_chw_plain)
from segtpu_torch.kernels.upsample_argmax import interp_taps, matrix_taps


@functools.lru_cache(maxsize=None)
def shard_interp_bands(h_in: int, h_out: int, n: int, align_corners: bool):
    """Per-shard rows of the H interpolation matrix for an H-sharded
    resize (counterpart: segtpu/models/fast_decoder.py::
    _shard_interp_bands). Returns (As [n, h_out/n, h_in/n + hu + hd]
    f32, hu, hd): shard s applies ``As[s]`` to its h_in/n local rows
    between ``hu`` rows of the shard above and ``hd`` of the shard below
    (``parallel.halo_exchange``). The columns of halo rows outside the
    image hold zeros, so no tap names them."""
    if h_in % n or h_out % n:
        raise ValueError(f"{h_in} -> {h_out} rows do not divide into {n} "
                         f"shards")
    A = _interp_matrix(h_in, h_out, align_corners)
    olr, ilr = h_out // n, h_in // n
    hu = hd = 0
    for s in range(n):
        nz = np.nonzero(A[s * olr:(s + 1) * olr])[1]
        hu = max(hu, s * ilr - int(nz.min()))
        hd = max(hd, int(nz.max()) - ((s + 1) * ilr - 1))
    Ap = np.zeros((h_out, h_in + hu + hd), np.float32)
    Ap[:, hu:hu + h_in] = A
    As = np.stack([Ap[s * olr:(s + 1) * olr, s * ilr:(s + 1) * ilr + hu + hd]
                   for s in range(n)])
    return As, hu, hd


@functools.lru_cache(maxsize=None)
def _row_taps(h: int, oh: int, align_corners: bool, shard):
    """(taps int32 [2, rows], weights f32 [2, rows], rows of x, rows of
    the output) of the H pass over a map of ``h`` rows: the whole
    matrix, or shard ``(s, n)``'s band of it, whose taps count from the
    first row of the shard's window."""
    if shard is None:
        return (*interp_taps(h, oh, align_corners, oh, False), h, oh)
    s, n = shard
    if not 0 <= s < n:
        raise ValueError(f"bad shard {shard}")
    bands, hu, hd = shard_interp_bands(h, oh, n, align_corners)
    return (*matrix_taps(bands[s]), h // n + hu + hd, oh // n)


def _geometry(x, out_hw, acc, acc_chain, align_corners, shard):
    """Checks of one call; returns (rows and width of the output, the H
    pass's taps and weights)."""
    _check_x(x, "resize_chw")
    b, c = x.shape[:2]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if oh < 1 or ow < 1:
        raise ValueError(f"resize_chw: bad output size {(oh, ow)}")
    if shard is None:
        rows, rw, _, _ = _row_taps(x.shape[2], oh, align_corners, None)
    else:
        s, n, h_in = shard
        rows, rw, h_win, oh = _row_taps(h_in, oh, align_corners, (s, n))
        if x.shape[2] != h_win:
            raise ValueError(f"resize_chw: shard {s}/{n} of a {h_in}-row map "
                             f"takes a window of {h_win} rows, got "
                             f"{x.shape[2]}")
    if acc is not None and acc_chain is not None:
        raise ValueError("resize_chw takes acc or acc_chain, not both")
    if acc is not None and tuple(acc.shape) != (b, c, oh, ow):
        raise ValueError(f"acc must be {(b, c, oh, ow)}, got "
                         f"{tuple(acc.shape)}")
    if acc_chain is not None:
        raw, stages = acc_chain
        if (raw.shape[0], *raw.shape[2:]) != (b, oh, ow) or not stages \
                or stages[-1][0].shape[0] != c:
            raise ValueError(f"acc_chain must map a [{b}, C0, {oh}, {ow}] "
                             f"tap to {c} channels")
    return oh, ow, rows, rw


def resize_chw_plain(x, out_hw, acc=None, acc_chain=None, *,
                     align_corners: bool = True, shard=None):
    """Plain PyTorch version of ``resize_chw`` (same signature, bits)."""
    oh, ow, rows, rw = _geometry(x, out_hw, acc, acc_chain, align_corners,
                                 shard)
    dev = x.device
    rows, rw = torch.from_numpy(rows).long().to(dev), torch.from_numpy(rw).to(dev)
    cols, cw = (torch.from_numpy(t).to(dev)
                for t in interp_taps(x.shape[-1], ow, align_corners, ow, False))
    cols = cols.long()
    xf = x.float()
    t = xf[:, :, rows[0], :] * rw[0, :, None] + xf[:, :, rows[1], :] * rw[1, :, None]
    v = t[..., cols[0]] * cw[0] + t[..., cols[1]] * cw[1]
    if acc is not None:
        v = v + acc.float()
    if acc_chain is not None:
        v = v + pw_chain_chw_plain(*acc_chain).float()
    return v.to(x.dtype)


@functools.lru_cache(maxsize=64)
def _device_tables(h: int, w: int, oh: int, ow: int, align_corners: bool,
                   shard, device: torch.device):
    """The tap tables of one geometry (``h``, ``oh`` of the whole map),
    uploaded once per device."""
    rows, rw, _, _ = _row_taps(h, oh, align_corners, shard)
    cols, cw = interp_taps(w, ow, align_corners, ow, False)
    return tuple(torch.from_numpy(t).to(device) for t in (rows, rw, cols, cw))


def resize_chw(x, out_hw, acc=None, acc_chain=None, *,
               align_corners: bool = True, use_kernels: bool = True,
               shard=None):
    """x [B, C, h, w] -> [B, C, OH, OW] bilinear (torch's
    ``F.interpolate`` semantics for either ``align_corners``), plus
    ``acc`` [B, C, OH, OW] or ``acc_chain = (raw [B, C0, OH, OW],
    [(w OIHW 1x1, f32 bias), ...])``. On a CUDA tensor this launches the
    kernel (``resize_chw.launches``).

    The row-window form, ``shard = (s, n, h)``: x is shard s's window of
    an H-sharded map of ``h`` rows, its h/n local rows between the
    ``hu``/``hd`` halo rows of ``shard_interp_bands(h, OH, n,
    align_corners)``; ``out_hw`` stays the whole target, and the result
    (and ``acc``, ``acc_chain``) holds the shard's OH/n rows, with the
    bits of those rows of the unsharded call: the same taps, read at
    their offset in the window, and the same weights."""
    if _use_plain(x, use_kernels, "resize_chw"):
        return resize_chw_plain(x, out_hw, acc, acc_chain,
                                align_corners=align_corners, shard=shard)
    oh, ow, _, _ = _geometry(x, out_hw, acc, acc_chain, align_corners, shard)
    b, c, h, w = x.shape
    dev, dt = x.device, x.dtype
    for t in (x, acc, None if acc_chain is None else acc_chain[0]):
        if t is not None and (t.dtype != dt or not t.is_contiguous()
                              or t.device != dev):
            raise ValueError(f"resize_chw kernel needs contiguous {dt} "
                             f"inputs on {dev}")
    rows, rw, cols, cw = _device_tables(
        h if shard is None else shard[2], w, int(out_hw[0]), ow,
        align_corners, None if shard is None else tuple(shard[:2]), dev)
    raw, stages = acc_chain if acc_chain is not None else (None, [])
    if len(stages) > 4:
        raise ValueError("resize_chw kernel chains at most 4 stages")
    ws = [_on(wt.reshape(wt.shape[0], -1), dt, dev) for wt, _ in stages]
    bs = [_on(bias, torch.float32, dev) for _, bias in stages]
    if ws and ws[0].shape[1] != raw.shape[1]:
        raise ValueError(f"acc_chain's first stage takes {ws[0].shape[1]} "
                         f"channels, raw has {raw.shape[1]}")
    arrays = (_ptrs(ws), _ptrs(bs), _ints([t.shape[1] for t in ws]),
              _ints([t.shape[0] for t in ws]), _ints([1] * len(ws)))
    out = torch.empty((b, c, oh, ow), dtype=dt, device=dev)
    from segtpu_torch.kernels._build import load
    fn = load("resize").segtpu_resize
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # the kernel reads rows through its tables alone, so a window with its
    # band of the tables is the whole call to it
    rc = _launch(fn, x, x.data_ptr(), out.data_ptr(), b, c, h, w, oh, ow,
                 rows.data_ptr(), rw.data_ptr(), cols.data_ptr(),
                 cw.data_ptr(), None if acc is None else acc.data_ptr(),
                 None if raw is None else raw.data_ptr(),
                 0 if raw is None else raw.shape[1],
                 *[ctypes.addressof(a) for a in arrays], len(ws),
                 int(dt == torch.bfloat16))
    if rc != 0:
        raise RuntimeError(f"resize_chw kernel launch failed: CUDA error {rc}")
    resize_chw.launches += 1
    return out


resize_chw.launches = 0
