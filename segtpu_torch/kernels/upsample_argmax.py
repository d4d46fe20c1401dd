"""Fused bilinear upsample + argmax mask decode
(counterpart: segtpu/kernels/upsample_argmax.py::upsample_argmax,
::upsample_argmax_flat and ::upsample_argmax_sharded).

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
with its own kernel (``upsample_argmax_flat_kernel``, planned by
``flat_plan``) and plain twin.

``upsample_argmax_sharded`` computes one shard's rows of the H-first
mask from that shard's logit rows and one halo row of each neighbour:
the H-first kernel on the shard's window with the shard's row tables
(``shard_window``, ``tail_plan(window=...)``), and its own plain twin,
bit for bit the unsharded rows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from segtpu_torch.core.resize import _interp_matrix
from segtpu_torch.kernels._build import count_launch
from segtpu_torch.kernels.chw_ops import _plan_ints


def matrix_taps(mat: np.ndarray):
    """2-tap tables of the rows of an interpolation matrix: (taps int32
    [2, rows], weights float32 [2, rows]) — low tap, then high tap. A
    row with one (merged) entry gets weight 0 on its high tap."""
    n_keep = len(mat)
    taps = np.zeros((2, n_keep), np.int32)
    wts = np.zeros((2, n_keep), np.float32)
    for o, row in enumerate(mat):
        nz = np.flatnonzero(row)
        if not 1 <= nz.size <= 2:
            raise ValueError(f"interp row {o} has {nz.size} taps")
        taps[:, o] = nz[0], nz[-1]
        wts[0, o] = row[nz[0]]
        wts[1, o] = row[nz[-1]] if nz.size == 2 else 0.0
    return taps, wts


@functools.lru_cache(maxsize=None)
def interp_taps(n_in: int, n_out: int, align_corners: bool, n_keep: int,
                bf16_weights: bool):
    """``matrix_taps`` of the first ``n_keep`` rows of ``_interp_matrix``;
    ``bf16_weights`` rounds the weights to bf16."""
    taps, wts = matrix_taps(_interp_matrix(n_in, n_out, align_corners)[:n_keep])
    if bf16_weights:
        wts = torch.from_numpy(wts).to(torch.bfloat16).float().numpy()
    return taps, wts


def _check_logits(logits):
    if logits.ndim != 4:
        raise ValueError(f"tail takes [B, K, h, w] logits, got "
                         f"{tuple(logits.shape)}")
    if logits.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"tail takes bf16 or f32 logits, not {logits.dtype}")
    _, k, h, w = logits.shape
    if not 1 <= k <= 256:
        raise ValueError(f"a uint8 mask holds at most 256 classes, got {k}")


def _tables(logits, out_hw, crop_hw, align_corners):
    _check_logits(logits)
    _, k, h, w = logits.shape
    grid_h, grid_w = int(out_hw[0]), int(out_hw[1])
    ho, wo = (int(crop_hw[0]), int(crop_hw[1])) if crop_hw else (grid_h,
                                                                   grid_w)
    if not (0 < ho <= grid_h and 0 < wo <= grid_w):
        raise ValueError(f"crop {(ho, wo)} outside the grid {(grid_h, grid_w)}")
    bf16 = logits.dtype == torch.bfloat16
    rows, rw = interp_taps(h, grid_h, align_corners, ho, bf16)
    cols, cw = interp_taps(w, grid_w, align_corners, wo, False)
    return ho, wo, rows, rw, cols, cw


def _plain_core(logits, rows, rw, cols, cw, ho: int, wo: int):
    """H pass, W pass and running argmax of the H-first tail on tables
    already on logits' device (rows/cols int64 [2, .], rw/cw f32)."""
    dev = logits.device
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


def upsample_argmax_plain(logits, out_hw, *, crop_hw=None,
                          align_corners: bool = True):
    """Plain PyTorch version of the tail (same signature, same bits)."""
    ho, wo, rows, rw, cols, cw = _tables(logits, out_hw, crop_hw,
                                         align_corners)
    dev = logits.device
    rows, cols = (torch.from_numpy(t).long().to(dev) for t in (rows, cols))
    rw, cw = (torch.from_numpy(t).to(dev) for t in (rw, cw))
    return _plain_core(logits, rows, rw, cols, cw, ho, wo)


@functools.lru_cache(maxsize=16)
def _device_tables(h: int, w: int, grid_h: int, grid_w: int, ho: int, wo: int,
                   align_corners: bool, bf16: bool, device: torch.device):
    """The tap tables of one call geometry, uploaded once per device."""
    rows, rw = interp_taps(h, grid_h, align_corners, ho, bf16)
    cols, cw = interp_taps(w, grid_w, align_corners, wo, False)
    return tuple(torch.from_numpy(t).to(device) for t in (rows, rw, cols, cw))


# The tail kernel's layout (csrc/upsample_argmax.cu upsample_argmax_kernel):
# a block takes bands of BR output rows x segments of SW output columns;
# each thread 8 consecutive columns of one row, a half-warp 128 columns;
# at most 256 threads.
_SMEM_LIMIT = 227 * 1024           # opt-in shared memory per block, H100
_THREE_BLOCKS = 228 * 1024 // 3 - 1024   # shared memory for three blocks
# the (BR, SW) tiles the plan may take; the plan's is the first, the
# fastest at the arch0 b8 path's tail on an H100 (``stem_tail_probe.py
# --tiles`` times them all)
TAIL_TILES = ((4, 256), (8, 256), (2, 256), (8, 128))
# The W-first kernel's (upsample_argmax_flat_kernel): a thread takes
# FLAT_PX consecutive output columns over all 4 rows of a band, so a
# block SW / FLAT_PX threads (whole warps, at most 256); the plan's tile is
# the first, the faster at G2's b8 tail on an H100 (``stem_tail_probe.py
# --tiles`` times both)
FLAT_PX = 4
FLAT_TILES = ((4, 512), (4, 256))


class TailPlan(NamedTuple):
    br: int          # output rows of a band
    sw: int          # output columns of a segment
    nr: int          # input rows staged: the most any band's taps name
    nc: int          # input columns staged (a multiple of 8)
    kc: int          # classes a staged chunk
    smem: int        # shared bytes


def tail_span(taps: np.ndarray, size: int, align: int = 1) -> int:
    """The most input rows (or columns) a block of ``size`` consecutive
    outputs names: from the first output's low tap (aligned down to a
    multiple of ``align``) to the largest tap of the block, which the
    kernel stages. Raises where a block's taps reach below its first
    output's low tap (tables that are not monotone)."""
    n = taps.shape[1]
    starts = np.arange(0, n, size)
    lo = taps[0, starts] // align * align
    blk = np.arange(n) // size
    if (taps.min(axis=0) < lo[blk]).any():
        raise ValueError("tail taps are not monotone")
    hi = np.maximum.reduceat(taps.max(axis=0), starts)
    return int((hi - lo).max()) + 1


def _staged_bytes(nr: int, nc: int, kc: int, esize: int) -> int:
    return -(-kc * nr * nc * esize // 16) * 16


def tail_smem(br: int, nr: int, nc: int, kc: int, esize: int) -> int:
    """Shared bytes of a tail block (csrc/upsample_argmax.cu
    ``tail_smem``): two buffers of staged logits [kc][nr][nc] in
    ``esize``-byte elements (each rounded up to 16 bytes), then the f32
    H pass [kc][br][nc + 1]."""
    return 2 * _staged_bytes(nr, nc, kc, esize) + 4 * kc * br * (nc + 1)


def flat_smem(nr: int, nc: int, kc: int, esize: int) -> int:
    """Shared bytes of a W-first block (``flat_smem``): the two buffers
    of staged logits alone."""
    return 2 * _staged_bytes(nr, nc, kc, esize)


def _fit_classes(br, sw, nr, nc, k, per_class, what) -> TailPlan:
    """The plan with the most classes a chunk whose shared memory
    (``per_class`` bytes a class; nc % 8 == 0 makes it linear in kc)
    leaves room for three blocks per SM, else one."""
    for limit in (_THREE_BLOCKS, _SMEM_LIMIT):
        kc = min(k, limit // per_class)
        if kc >= 1:
            return TailPlan(br, sw, nr, nc, kc, kc * per_class)
    raise ValueError(f"{what}: one class of a {br}x{sw} band does not fit "
                     f"shared memory")


def _spans(h, w, grid_h, grid_w, ho, wo, align_corners, br, sw, window):
    rows, _ = interp_taps(h, grid_h, align_corners, ho, False)
    cols, _ = interp_taps(w, grid_w, align_corners, wo, False)
    if window is not None:
        out_row0, rows_out, in_row0 = window
        rows = rows[:, out_row0:out_row0 + rows_out] - in_row0
    return tail_span(rows, br), -(-tail_span(cols, sw, 8) // 8) * 8


@functools.lru_cache(maxsize=None)
def tail_plan(h: int, w: int, grid_h: int, grid_w: int, ho: int, wo: int,
              align_corners: bool, k: int, esize: int,
              tile=TAIL_TILES[0], window=None) -> TailPlan:
    """The layout of a tail launch from [., k, h, w] logits to the
    (ho, wo) crop of the (grid_h, grid_w) grid: bands of ``tile`` = (BR,
    SW), the input rows and columns any band and segment names (from the
    tap tables), and the most classes a chunk whose shared memory leaves
    room for three blocks per SM, else one. ``window`` = (out_row0,
    rows_out, in_row0) plans one shard's launch instead: mask rows
    out_row0 .. out_row0 + rows_out - 1 of the frame, read from a window
    of logit rows whose first is the frame's row in_row0, so the bands
    and their staged rows are the shard's. The arithmetic does not depend
    on the plan."""
    br, sw = tile
    nr, nc = _spans(h, w, grid_h, grid_w, ho, wo, align_corners, br, sw,
                    window)
    return _fit_classes(br, sw, nr, nc, k, tail_smem(br, nr, nc, 1, esize),
                        f"tail of {k} classes {h}x{w} -> {ho}x{wo}")


@functools.lru_cache(maxsize=None)
def flat_plan(h: int, w: int, grid_h: int, grid_w: int, ho: int, wo: int,
              align_corners: bool, k: int, esize: int,
              tile=FLAT_TILES[0]) -> TailPlan:
    """The layout of a W-first launch (``upsample_argmax_flat_kernel``),
    as ``tail_plan``'s: bands of ``tile`` = (BR, SW), BR 4,
    SW a multiple of 32 * FLAT_PX up to 256 * FLAT_PX; shared memory
    ``flat_smem``."""
    br, sw = tile
    if br != 4 or sw % (32 * FLAT_PX) or sw > 256 * FLAT_PX:
        raise ValueError(f"no W-first kernel for a {br}x{sw} band")
    nr, nc = _spans(h, w, grid_h, grid_w, ho, wo, align_corners, br, sw,
                    None)
    return _fit_classes(br, sw, nr, nc, k, flat_smem(nr, nc, 1, esize),
                        f"flat tail of {k} classes {h}x{w} -> {ho}x{wo}")


def tail_args(plan: TailPlan, w: int, wo: int, esize: int, in_ptr: int,
              out_ptr: int, store: int = 8) -> tuple:
    """The 8 ints the C entry takes: the plan and the vector paths (vin:
    16-byte loads where logit rows are whole 16-byte chunks and the
    logits 16-byte aligned; vout: ``store``-byte mask stores, 8 for the
    H-first kernel and FLAT_PX for the W-first one, where ``wo`` is a
    multiple of ``store`` and the mask ``store``-byte aligned)."""
    vin = w % (16 // esize) == 0 and in_ptr % 16 == 0
    vout = wo % store == 0 and out_ptr % store == 0
    return tuple(plan) + (int(vin), int(vout))


def _entry(name: str):
    """The C entry ``name`` of csrc/upsample_argmax.cu with its argtypes:
    logits and mask pointers, 7 ints (B, K, h, w, Ho, Wo, bf16), the four
    tables, the plan, the stream."""
    from segtpu_torch.kernels._build import load
    fn = getattr(load("upsample_argmax"), name)
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tail_entry():
    return _entry("segtpu_upsample_argmax")


@functools.lru_cache(maxsize=None)
def _flat_entry():
    return _entry("segtpu_upsample_argmax_flat")


def _run(entry, what, logits, ho, wo, tables, plan, store):
    """``entry`` on contiguous CUDA logits [B, K, h, w] into a new uint8
    mask [B, ho, wo], with the tables (rows, rw, cols, cw on the logits'
    device) and ``plan`` (``tail_args`` with ``store``); raises
    RuntimeError when the launch fails."""
    if not logits.is_contiguous():
        raise ValueError("tail kernel needs contiguous logits")
    b, k, h, w = logits.shape
    esize = logits.element_size()
    out = torch.empty((b, ho, wo), dtype=torch.uint8, device=logits.device)
    ints = _plan_ints(tail_args(plan, w, wo, esize, logits.data_ptr(),
                                out.data_ptr(), store))
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = entry()(logits.data_ptr(), out.data_ptr(), b, k, h, w, ho, wo,
                     int(logits.dtype == torch.bfloat16),
                     *(t.data_ptr() for t in tables), ctypes.addressof(ints),
                     stream)
    count_launch()
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    return out


def _tail_launch(logits, out_hw, crop_hw, align_corners):
    """The kernel on checked CUDA logits (csrc/upsample_argmax.cu
    upsample_argmax_kernel, with the plan of ``tail_plan``)."""
    ho, wo, *_ = _tables(logits, out_hw, crop_hw, align_corners)
    b, k, h, w = logits.shape
    grid_h, grid_w = int(out_hw[0]), int(out_hw[1])
    tables = _device_tables(h, w, grid_h, grid_w, ho, wo, align_corners,
                            logits.dtype == torch.bfloat16, logits.device)
    plan = tail_plan(h, w, grid_h, grid_w, ho, wo, align_corners, k,
                     logits.element_size())
    return _run(_tail_entry, "upsample_argmax", logits, ho, wo, tables, plan,
                8)


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
    out = _tail_launch(logits, out_hw, crop_hw, align_corners)
    upsample_argmax.launches += 1
    return out


upsample_argmax.launches = 0


_HALO = 1    # a 2-tap resize reads at most one row beyond a shard's own


@functools.lru_cache(maxsize=None)
def shard_window(h: int, grid_h: int, n_shards: int, shard: int, hwin: int,
                 align_corners: bool):
    """(rows_out, in_row0, out_row0) of shard ``shard`` of ``n_shards`` of
    a frame of h logit rows upsampled to grid_h mask rows, whose window
    holds hwin rows: the shard's mask rows, and the frame's index of the
    window's first row (one halo row above the shard's own) and of the
    first mask row. Raises where the shard's taps reach outside the
    window."""
    rows_out, hl = grid_h // n_shards, h // n_shards
    in_row0, out_row0 = shard * hl - _HALO, shard * rows_out
    rows, _ = interp_taps(h, grid_h, align_corners, grid_h, False)
    rel = rows[:, out_row0:out_row0 + rows_out] - in_row0
    if rel.min() < 0 or rel.max() >= hwin:
        raise ValueError(
            f"shard {shard}/{n_shards}: mask rows {out_row0}..{out_row0 + rows_out - 1} "
            f"read logit rows {int(rel.min()) + in_row0}..{int(rel.max()) + in_row0}, "
            f"outside the window {in_row0}..{in_row0 + hwin - 1}")
    return rows_out, in_row0, out_row0


def _sharded_geometry(logits_ext, out_hw, shard, n_shards, align_corners):
    """Checks of one shard's call; returns (h, rows_out, in_row0,
    out_row0): the frame's logit rows, the shard's mask rows, and the
    global index of the window's first row and of the first mask row."""
    if n_shards < 1 or not 0 <= shard < n_shards:
        raise ValueError(f"bad shard {shard} of {n_shards}")
    grid_h = int(out_hw[0])
    if grid_h % n_shards:
        raise ValueError(f"H={grid_h} must divide into n_shards={n_shards}")
    _check_logits(logits_ext)
    hwin = logits_ext.shape[2]
    hl = hwin - 2 * _HALO
    if hl < 1:
        raise ValueError(f"window of {hwin} rows holds no local row beside "
                         f"its two halo rows")
    h = hl * n_shards
    return (h, *shard_window(h, grid_h, n_shards, shard, hwin,
                             align_corners))


def shard_taps(h: int, w: int, grid_h: int, grid_w: int, window,
               align_corners: bool, bf16: bool):
    """One shard's tap tables, numpy: its rows of the frame's row tables
    [2, rows_out], shifted to its window (int32), with their weights (bf16
    in bf16 mode), and the frame's column tables. ``window`` =
    (out_row0, rows_out, in_row0)."""
    out_row0, rows_out, in_row0 = window
    rows, rw = interp_taps(h, grid_h, align_corners, grid_h, bf16)
    cols, cw = interp_taps(w, grid_w, align_corners, grid_w, False)
    sl = slice(out_row0, out_row0 + rows_out)
    return (np.ascontiguousarray(rows[:, sl] - in_row0),
            np.ascontiguousarray(rw[:, sl]), cols, cw)


@functools.lru_cache(maxsize=64)
def _shard_tables(h: int, w: int, grid_h: int, grid_w: int, window,
                  align_corners: bool, bf16: bool, device: torch.device):
    """``shard_taps`` on ``device``, uploaded once."""
    return tuple(torch.from_numpy(t).to(device) for t in shard_taps(
        h, w, grid_h, grid_w, window, align_corners, bf16))


def upsample_argmax_sharded_plain(logits_ext, out_hw, *, shard: int,
                                  n_shards: int, align_corners: bool = True):
    """Plain PyTorch version of ``upsample_argmax_sharded`` (same
    signature, same bits)."""
    h, rows_out, in_row0, out_row0 = _sharded_geometry(
        logits_ext, out_hw, shard, n_shards, align_corners)
    grid_h, grid_w = int(out_hw[0]), int(out_hw[1])
    rows, rw, cols, cw = shard_taps(
        h, logits_ext.shape[3], grid_h, grid_w, (out_row0, rows_out, in_row0),
        align_corners, logits_ext.dtype == torch.bfloat16)
    dev = logits_ext.device
    rows, cols = (torch.from_numpy(t).long().to(dev) for t in (rows, cols))
    rw, cw = (torch.from_numpy(t).to(dev) for t in (rw, cw))
    return _plain_core(logits_ext, rows, rw, cols, cw, rows_out, grid_w)


def _sharded_launch(logits_ext, out_hw, shard, n_shards, align_corners):
    """One shard on the H-first kernel: its window of logit rows as the
    input, its mask rows as the output, the shard's row tables
    (``shard_taps``) and the plan of ``tail_plan(window=...)``."""
    h, rows_out, in_row0, out_row0 = _sharded_geometry(
        logits_ext, out_hw, shard, n_shards, align_corners)
    _, k, _, w = logits_ext.shape
    grid_h, grid_w = int(out_hw[0]), int(out_hw[1])
    window = (out_row0, rows_out, in_row0)
    tables = _shard_tables(h, w, grid_h, grid_w, window, align_corners,
                           logits_ext.dtype == torch.bfloat16,
                           logits_ext.device)
    plan = tail_plan(h, w, grid_h, grid_w, grid_h, grid_w, align_corners, k,
                     logits_ext.element_size(), window=window)
    return _run(_tail_entry, "upsample_argmax_sharded", logits_ext, rows_out,
                grid_w, tables, plan, 8)


def upsample_argmax_sharded(logits_ext, out_hw, *, shard: int, n_shards: int,
                            align_corners: bool = True,
                            use_kernels: bool = True):
    """One shard's rows of the mask of an H-sharded frame (counterpart:
    segtpu/kernels/upsample_argmax.py::upsample_argmax_sharded).

    ``logits_ext`` [B, K, h/n + 2, w] holds shard ``shard``'s h/n rows
    of the channel-first logits between one row of each neighbour
    (``parallel.halo_exchange(xs, 1, 1)``; zeros at the ends of the
    mesh, which no tap reads: a 2-tap resize reads at most one row
    beyond a shard's own). ``out_hw`` = (H, W) is the whole frame.
    Returns uint8 [B, H/n, W], row for row the bits of
    ``upsample_argmax(full_logits, out_hw)[:, shard*H/n:(shard+1)*H/n]``:
    the same tables, weights and order.

    On a CUDA tensor this launches the H-first kernel on the window with
    the shard's row tables (counted in ``upsample_argmax_sharded.launches``,
    not in ``upsample_argmax.launches``); on a CPU tensor, or with
    ``use_kernels=False``, it runs the plain version."""
    if logits_ext.device.type == "cpu" or (logits_ext.device.type == "cuda"
                                           and not use_kernels):
        return upsample_argmax_sharded_plain(
            logits_ext, out_hw, shard=shard, n_shards=n_shards,
            align_corners=align_corners)
    if logits_ext.device.type != "cuda":
        raise ValueError(f"tail runs on cuda or cpu, not {logits_ext.device}")
    out = _sharded_launch(logits_ext, out_hw, shard, n_shards, align_corners)
    upsample_argmax_sharded.launches += 1
    return out


upsample_argmax_sharded.launches = 0


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


def _flat_launch(logits_flat, in_hw, out_hw, crop_hw, align_corners):
    """The W-first kernel on checked CUDA logits (csrc/upsample_argmax.cu
    upsample_argmax_flat_kernel, with the plan of ``flat_plan``)."""
    logits, ho, wo, tables = _flat_geometry(logits_flat, in_hw, out_hw,
                                            crop_hw, align_corners)
    _, k, h, w = logits.shape
    plan = flat_plan(h, w, int(out_hw[0]), int(out_hw[1]), ho, wo,
                     align_corners, k, logits.element_size())
    return _run(_flat_entry, "upsample_argmax_flat", logits, ho, wo, tables,
                plan, FLAT_PX)


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
    out = _flat_launch(logits_flat, in_hw, out_hw, crop_hw, align_corners)
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
