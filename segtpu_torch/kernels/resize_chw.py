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

import torch

from segtpu_torch.kernels.chw_ops import (_check_x, _ints, _on, _ptrs,
                                          _stream_ptr, _use_plain,
                                          pw_chain_chw_plain)
from segtpu_torch.kernels.upsample_argmax import interp_taps


def _geometry(x, out_hw, acc, acc_chain):
    _check_x(x, "resize_chw")
    b, c = x.shape[:2]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if oh < 1 or ow < 1:
        raise ValueError(f"resize_chw: bad output size {(oh, ow)}")
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
    return oh, ow


def resize_chw_plain(x, out_hw, acc=None, acc_chain=None, *,
                     align_corners: bool = True):
    """Plain PyTorch version of ``resize_chw`` (same signature, bits)."""
    oh, ow = _geometry(x, out_hw, acc, acc_chain)
    h, w = x.shape[-2:]
    dev = x.device
    rows, rw = (torch.from_numpy(t).to(dev)
                for t in interp_taps(h, oh, align_corners, oh, False))
    cols, cw = (torch.from_numpy(t).to(dev)
                for t in interp_taps(w, ow, align_corners, ow, False))
    rows, cols = rows.long(), cols.long()
    xf = x.float()
    t = xf[:, :, rows[0], :] * rw[0, :, None] + xf[:, :, rows[1], :] * rw[1, :, None]
    v = t[..., cols[0]] * cw[0] + t[..., cols[1]] * cw[1]
    if acc is not None:
        v = v + acc.float()
    if acc_chain is not None:
        v = v + pw_chain_chw_plain(*acc_chain).float()
    return v.to(x.dtype)


@functools.lru_cache(maxsize=32)
def _device_tables(h: int, w: int, oh: int, ow: int, align_corners: bool,
                   device: torch.device):
    """The tap tables of one geometry, uploaded once per device."""
    rows, rw = interp_taps(h, oh, align_corners, oh, False)
    cols, cw = interp_taps(w, ow, align_corners, ow, False)
    return tuple(torch.from_numpy(t).to(device) for t in (rows, rw, cols, cw))


def resize_chw(x, out_hw, acc=None, acc_chain=None, *,
               align_corners: bool = True, use_kernels: bool = True):
    """x [B, C, h, w] -> [B, C, OH, OW] bilinear (torch's
    ``F.interpolate`` semantics for either ``align_corners``), plus
    ``acc`` [B, C, OH, OW] or ``acc_chain = (raw [B, C0, OH, OW],
    [(w OIHW 1x1, f32 bias), ...])``. On a CUDA tensor this launches the
    kernel (``resize_chw.launches``)."""
    if _use_plain(x, use_kernels, "resize_chw"):
        return resize_chw_plain(x, out_hw, acc, acc_chain,
                                align_corners=align_corners)
    oh, ow = _geometry(x, out_hw, acc, acc_chain)
    b, c, h, w = x.shape
    dev, dt = x.device, x.dtype
    for t in (x, acc, None if acc_chain is None else acc_chain[0]):
        if t is not None and (t.dtype != dt or not t.is_contiguous()
                              or t.device != dev):
            raise ValueError(f"resize_chw kernel needs contiguous {dt} "
                             f"inputs on {dev}")
    rows, rw, cols, cw = _device_tables(h, w, oh, ow, align_corners, dev)
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
    rc = fn(x.data_ptr(), out.data_ptr(), b, c, h, w, oh, ow,
            rows.data_ptr(), rw.data_ptr(), cols.data_ptr(), cw.data_ptr(),
            None if acc is None else acc.data_ptr(),
            None if raw is None else raw.data_ptr(),
            0 if raw is None else raw.shape[1],
            *[ctypes.addressof(a) for a in arrays], len(ws),
            int(dt == torch.bfloat16), _stream_ptr(x))
    if rc != 0:
        raise RuntimeError(f"resize_chw kernel launch failed: CUDA error {rc}")
    resize_chw.launches += 1
    return out


resize_chw.launches = 0
