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
from typing import NamedTuple

import numpy as np
import torch

from segtpu_torch.core.resize import _interp_matrix
from segtpu_torch.kernels.chw_ops import (_SMEM_LIMIT, _TWO_BLOCKS, _cdiv,
                                          _check_x, _ints, _launch, _on,
                                          _plan_ints, _ptrs, _use_plain,
                                          pw_chain_chw_plain, vector_ok)
from segtpu_torch.kernels.upsample_argmax import interp_taps, matrix_taps

# csrc/resize.cu: 256 threads, 4 channel groups x 64 pixel threads, each
# thread 12 channels x 4 pixels; a block's tile holds 256 output pixels
_TILE = 256
_PASS = 48
_RAW_CHUNK_BYTES = 32           # a raw chunk's bytes per pixel (KC * esize)
_RAW_STAGES = 3                 # raw chunk buffers


class ResizePlan(NamedTuple):
    rows: int        # R: whole output rows of a tile (1 for a segment)
    cols: int        # S: output columns of a tile, min(OW, 256)
    ncol: int        # input columns of a tile's H pass (a multiple of 8)
    cb: int          # channels of a block
    kc: int          # raw channels of a staged chunk (0: no chain)
    smem: int        # shared bytes


def resize_ncol(w: int, ow: int, align_corners: bool) -> int:
    """Input columns a tile's H pass holds: over the tiles' column spans
    (the whole row, or segments of 256 columns), the most from the first
    tap's column rounded down to a multiple of 8 to the last tap's rounded
    up (csrc/resize.cu: ``lo = cols[ox0] & ~7``)."""
    cols, _ = interp_taps(w, ow, align_corners, ow, False)
    s = min(ow, _TILE)
    return max(-(-(int(cols[1, min(x0 + s, ow) - 1]) + 1) // 8) * 8
               - (int(cols[0, x0]) & ~7) for x0 in range(0, ow, s))


def resize_smem(rows: int, ncol: int, cb: int, kc: int, cins, couts,
                esize: int) -> int:
    """Shared bytes of a resize block (csrc/resize.cu ``layout``): each
    stage's f32 weights [cin][cpad] (cpad: cout, or cb for the last stage,
    rounded up to 48), the H pass [rows][cb][ncol] f32 (to 16 bytes), one
    stage output [cmax][256] (two for three stages or more) and three raw
    chunks [kc][256], in ``esize``-byte elements."""
    nst = len(cins)
    off = sum(4 * ci * _cdiv(cb if i == nst - 1 else co, _PASS) * _PASS
              for i, (ci, co) in enumerate(zip(cins, couts)))
    off += -(-4 * rows * cb * ncol // 16) * 16
    cmax = max(couts[:-1], default=0)
    off += min(2, max(nst - 1, 0)) * esize * cmax * _TILE
    return off + (_RAW_STAGES * kc * _TILE * esize if nst else 0)


def resize_plan(c: int, w: int, ow: int, cins, couts, esize: int,
                align_corners: bool) -> ResizePlan:
    """The tile of a resize launch to ``ow`` columns from ``w`` with a
    chain of stages ``cins -> couts`` (empty: none): 256 output pixels, as
    whole rows where a row holds 256 or fewer, else segments of a row; every
    channel in one block. Where that does not leave room for two blocks per
    SM (512 threads), fewer rows a tile, then fewer channels a block (the
    chain's earlier stages then rerun for each), else one block per SM.
    The sum order does not depend on the plan."""
    s = min(ow, _TILE)
    r_max = _TILE // s if s == ow else 1
    ncol = resize_ncol(w, ow, align_corners)
    kc = min(cins[0], _RAW_CHUNK_BYTES // esize) if cins else 0
    cbs = [c] + list(range((c - 1) // _PASS * _PASS, 0, -_PASS))
    for limit in (_TWO_BLOCKS, _SMEM_LIMIT):
        for cb in cbs:
            for rows in range(r_max, 0, -1):
                smem = resize_smem(rows, ncol, cb, kc, cins, couts, esize)
                if smem <= limit:
                    return ResizePlan(rows, s, ncol, cb, kc, smem)
    raise ValueError(f"resize_chw: {c} channels at {ow} columns with "
                     f"stages {list(zip(cins, couts))} do not fit shared "
                     f"memory")


_resize_plan = functools.lru_cache(maxsize=None)(resize_plan)


def resize_args(c: int, w: int, ow: int, cins, couts, esize: int,
                align_corners: bool, ptrs) -> tuple:
    """The 7 ints the C entry takes: the plan's (R, S, ncol, CB, KC, smem)
    and the vector path (1 when ``ow`` and ``w`` are multiples of 8 and
    the pointers of x, out, acc and raw are 16-byte aligned)."""
    p = _resize_plan(c, w, ow, tuple(cins), tuple(couts), esize,
                     align_corners)
    return (p.rows, p.cols, p.ncol, p.cb, p.kc, p.smem,
            int(vector_ok(ptrs, ow, w)))


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


@functools.lru_cache(maxsize=None)
def _resize_entry():
    from segtpu_torch.kernels._build import load
    fn = load("resize").segtpu_resize
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def _resize_launch(x, out_hw, acc, acc_chain, align_corners, shard):
    """The kernel (csrc/resize.cu) with the plan of ``resize_args``."""
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
    cins, couts = [t.shape[1] for t in ws], [t.shape[0] for t in ws]
    arrays = (_ptrs(ws), _ptrs(bs), _ints(cins), _ints(couts),
              _ints([1] * len(ws)))
    out = torch.empty((b, c, oh, ow), dtype=dt, device=dev)
    plan = _plan_ints(resize_args(
        c, w, ow, cins, couts, x.element_size(), align_corners,
        [t.data_ptr() for t in (x, out, acc, raw) if t is not None]))
    fn = _resize_entry()
    # the kernel reads rows through its tables alone, so a window with its
    # band of the tables is the whole call to it
    rc = _launch(fn, x, x.data_ptr(), out.data_ptr(), b, c, h, w, oh, ow,
                 rows.data_ptr(), rw.data_ptr(), cols.data_ptr(),
                 cw.data_ptr(), None if acc is None else acc.data_ptr(),
                 None if raw is None else raw.data_ptr(),
                 0 if raw is None else raw.shape[1],
                 *[ctypes.addressof(a) for a in arrays], len(ws),
                 int(dt == torch.bfloat16), ctypes.addressof(plan))
    if rc != 0:
        raise RuntimeError(f"resize_chw kernel launch failed: CUDA error {rc}")
    return out


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
    out = _resize_launch(x, out_hw, acc, acc_chain, align_corners, shard)
    resize_chw.launches += 1
    return out


resize_chw.launches = 0
