"""segtpu_torch's H-sharded and W-first upsample+argmax tails on their CUDA
kernels' layouts, on the CPU: a shard of an H-sharded frame is the
H-first kernel (csrc/upsample_argmax.cu upsample_argmax_kernel) on the
shard's window of logit rows with the shard's row tables
(``shard_window``, ``shard_taps``, ``tail_plan(window=...)``); the W-first
tail is ``upsample_argmax_flat_kernel`` (``flat_plan``).

The plans are checked at the arch0 b8 path's geometry (256x512 logits ->
1024x2048 at n = 2, 4, 8 shards) and at odd frames: each fits shared
memory, stages every row its bands' taps name, within the window, and no
tap names a mesh end's halo row. Each kernel's work is walked in numpy
float32 (every product and sum rounded once, as the kernels and twins
round them), item by item as the persistent blocks take them: the
staged rows and columns of a (band, segment, chunk of classes), zero
outside the image, and for the W-first kernel each thread's FLAT_PX
columns over the band's rows with the W pass of two staged rows kept
(computed once a class and staged row). Each walk must give its plain
twin's bits exactly (the sharded tail's also the unsharded twin's rows)
and write every mask pixel once. A stood-in C entry checks the ints each
wrapper hands the library. The twins are held against the JAX package
by test_torch_upsample_argmax_sharded.py and test_torch_decoder_ops.py.
"""

import contextlib
import ctypes
import importlib
import types

import numpy as np
import pytest
import torch

from segtpu_torch.kernels.upsample_argmax import (
    FLAT_PX, FLAT_TILES, TAIL_TILES, _SMEM_LIMIT, _THREE_BLOCKS, flat_plan,
    flat_smem, interp_taps, shard_taps, shard_window, tail_args, tail_plan,
    tail_smem, upsample_argmax_flat_plain, upsample_argmax_plain,
    upsample_argmax_sharded_plain)
from segtpu_torch.parallel import halo_exchange

ua = importlib.import_module("segtpu_torch.kernels.upsample_argmax")

F32 = np.float32

# (h, w, grid) of H-sharded frames: the arch0 b8 path's, and odd ones (a
# width that is not a multiple of 8, a non-integer scale)
SHARD_FRAMES = {"b8": (256, 512, (1024, 2048)),
                "odd_width": (24, 37, (96, 150)),
                "odd_scale": (24, 10, (72, 33))}


def _windows(h, n):
    """(shard, hwin) of an n-way split of h logit rows."""
    return [(s, h // n + 2) for s in range(n)]


# ------------------------------------------------------------ shard plans

@pytest.mark.parametrize("frame", sorted(SHARD_FRAMES))
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("ac", [True, False])
def test_shard_plans_fit_and_cover_the_window(frame, n, esize, ac):
    """Every shard's plan fits shared memory (room for three blocks an
    SM), stages every row its bands name and no more rows than its
    window holds; no tap names the mesh ends' halo rows."""
    h, w, (gh, gw) = SHARD_FRAMES[frame]
    rows, _ = interp_taps(h, gh, ac, gh, False)
    for s, hwin in _windows(h, n):
        rows_out, in_row0, out_row0 = shard_window(h, gh, n, s, hwin, ac)
        assert (rows_out, out_row0) == (gh // n, s * gh // n)
        assert in_row0 == s * (h // n) - 1
        window = (out_row0, rows_out, in_row0)
        p = tail_plan(h, w, gh, gw, gh, gw, ac, 19, esize, window=window)
        assert (p.br, p.sw) == TAIL_TILES[0] and p.kc == 19
        assert p.smem == tail_smem(p.br, p.nr, p.nc, p.kc, esize)
        assert p.smem <= _THREE_BLOCKS
        assert 1 <= p.nr <= hwin
        rel = rows[:, out_row0:out_row0 + rows_out] - in_row0
        for oy0 in range(0, rows_out, p.br):
            band = rel[:, oy0:oy0 + p.br]
            assert band.min() >= band[0, 0] and band.max() < band[0, 0] + p.nr
        assert rel.min() >= 0 and rel.max() < hwin
        if s == 0:                   # the zero halo above the first shard
            assert rel.min() >= 1
        if s == n - 1:               # ... and below the last
            assert rel.max() <= hwin - 2


@pytest.mark.parametrize("frame", sorted(SHARD_FRAMES))
@pytest.mark.parametrize("ac", [True, False])
def test_shard_taps_are_the_frame_rows_in_the_window(frame, ac):
    """A shard's tables are its rows of the frame's tables, shifted to
    the window, with the same weights; the columns are the frame's."""
    h, w, (gh, gw) = SHARD_FRAMES[frame]
    for bf16 in (False, True):
        rows, rw = interp_taps(h, gh, ac, gh, bf16)
        cols, cw = interp_taps(w, gw, ac, gw, False)
        for s, hwin in _windows(h, 4):
            rows_out, in_row0, out_row0 = shard_window(h, gh, 4, s, hwin, ac)
            r, a, c, b = shard_taps(h, w, gh, gw,
                                    (out_row0, rows_out, in_row0), ac, bf16)
            sl = slice(out_row0, out_row0 + rows_out)
            assert r.dtype == np.int32 and r.flags.c_contiguous
            assert a.dtype == np.float32 and a.flags.c_contiguous
            np.testing.assert_array_equal(r + in_row0, rows[:, sl])
            np.testing.assert_array_equal(a, rw[:, sl])
            np.testing.assert_array_equal(c, cols)
            np.testing.assert_array_equal(b, cw)


def test_shard_window_rejects_a_window_short_of_its_taps():
    with pytest.raises(ValueError, match="outside the window"):
        shard_window(16, 64, 4, 1, 4, True)         # no halo rows
    assert shard_window(16, 64, 4, 1, 6, True) == (16, 3, 16)


# ------------------------------------------------------------- H-first walk

def walk_h_first(x, rows, rw, cols, cw, plan, bf16):
    """upsample_argmax_kernel's work on [B, K, h, w] logits with tap
    tables rows/rw [2, ho] and cols/cw [2, wo] (rw bf16-rounded in bf16
    mode), item by item: returns the mask it writes and the set of input
    rows its taps read; checks that every tap lies in what an item staged
    and that every mask pixel is written once."""
    b_n, k_n, h, w = x.shape
    ho, wo = rows.shape[1], cols.shape[1]
    br, sw, nr, nc = plan.br, plan.sw, plan.nr, plan.nc
    out = np.zeros((b_n, ho, wo), np.uint8)
    written = np.zeros((b_n, ho, wo), np.int64)
    tapped = set()
    for b in range(b_n):
        for oy0 in range(0, ho, br):
            nrow = min(br, ho - oy0)
            r_lo = rows[0, oy0]
            for ox0 in range(0, wo, sw):
                c_lo = cols[0, ox0] & ~7
                ox = np.arange(ox0, min(ox0 + sw, wo))
                j0, j1 = cols[0, ox] - c_lo, cols[1, ox] - c_lo
                assert j0.min() >= 0 and j1.max() < nc
                best = np.full((nrow, len(ox)), -np.inf, F32)
                idx = np.zeros((nrow, len(ox)), np.uint8)
                for k0 in range(0, k_n, plan.kc):
                    kc = min(plan.kc, k_n - k0)
                    xs = np.zeros((kc, nr, nc), F32)   # zero outside
                    n_r, n_c = min(nr, h - r_lo), min(nc, w - c_lo)
                    xs[:, :n_r, :n_c] = x[b, k0:k0 + kc, r_lo:r_lo + n_r,
                                          c_lo:c_lo + n_c]
                    for r in range(nrow):
                        gy = oy0 + r
                        i0, i1 = rows[0, gy] - r_lo, rows[1, gy] - r_lo
                        assert 0 <= i0 < nr and 0 <= i1 < nr
                        tapped.update((int(rows[0, gy]), int(rows[1, gy])))
                        t = rw[0, gy] * xs[:, i0] + rw[1, gy] * xs[:, i1]
                        if bf16:
                            t = torch.from_numpy(t).bfloat16().float().numpy()
                        for kk in range(kc):
                            v = t[kk, j0] * cw[0, ox] + t[kk, j1] * cw[1, ox]
                            upd = v > best[r]
                            best[r][upd] = v[upd]
                            idx[r][upd] = k0 + kk
                out[b, oy0:oy0 + nrow, ox0:ox0 + len(ox)] = idx
                written[b, oy0:oy0 + nrow, ox0:ox0 + len(ox)] += 1
    assert (written == 1).all()
    return torch.from_numpy(out), tapped


# (logits shape, grid, n): the sharded twin tests' frames
_SHARD_WALKS = {
    "n2": ((2, 5, 16, 24), (64, 96), 2),
    "n4_19": ((1, 19, 16, 24), (64, 96), 4),
    "n8_one_row": ((1, 7, 8, 12), (64, 40), 8),
    "n3_odd_scale": ((1, 3, 12, 10), (30, 33), 3),
    "n4_odd_width": ((1, 6, 24, 37), (96, 150), 4),
}


def _logits(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(F32)
    return torch.from_numpy(x).to(dtype)


def _shard_walks(xt, grid, n, ac, plans):
    """Each shard's window through walk_h_first with its tables and each
    plan of ``plans(h, w, window)``; NaN in the mesh ends' halo rows.
    Yields (shard, walked mask, twin mask, tapped window rows, hwin)."""
    _, k, h, w = xt.shape
    bf16 = xt.dtype == torch.bfloat16
    ext = halo_exchange(list(xt.chunk(n, dim=2)), 1, 1)
    ext[0][:, :, 0] = float("nan")
    ext[-1][:, :, -1] = float("nan")
    for s, e in enumerate(ext):
        hwin = e.shape[2]
        rows_out, in_row0, out_row0 = shard_window(h, grid[0], n, s, hwin, ac)
        window = (out_row0, rows_out, in_row0)
        rows, rw, cols, cw = shard_taps(h, w, *grid, window, ac, bf16)
        want = upsample_argmax_sharded_plain(e, grid, shard=s, n_shards=n,
                                             align_corners=ac)
        for plan in plans(h, w, window):
            got, tapped = walk_h_first(e.float().numpy(), rows, rw, cols, cw,
                                       plan, bf16)
            yield s, got, want, tapped, hwin


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ac", [True, False])
@pytest.mark.parametrize("case", sorted(_SHARD_WALKS))
def test_sharded_walk_gives_the_twin_and_the_unsharded_rows(case, ac, dtype):
    shape, grid, n = _SHARD_WALKS[case]
    xt = _logits(shape, dtype, seed=sum(shape))
    full = upsample_argmax_plain(xt, grid, align_corners=ac)
    rows_out = grid[0] // n

    def plans(h, w, window):
        return [tail_plan(h, w, *grid, *grid, ac, shape[1],
                          xt.element_size(), window=window)]
    for s, got, want, tapped, hwin in _shard_walks(xt, grid, n, ac, plans):
        assert torch.equal(got, want)
        assert torch.equal(got, full[:, s * rows_out:(s + 1) * rows_out])
        assert (s > 0 or 0 not in tapped) and (
            s < n - 1 or hwin - 1 not in tapped)


@pytest.mark.parametrize("tile", TAIL_TILES)
def test_sharded_walk_every_tile_and_class_chunk(tile):
    """Every (BR, SW) tile, and chunks of 4 of 19 classes with exact ties
    across two chunks, on each shard of a 4-way split."""
    shape, grid, n = (1, 19, 16, 40), (64, 160), 4
    xt = _logits(shape, torch.bfloat16, seed=4)
    xt[:, 7] = xt[:, 3]
    full = upsample_argmax_plain(xt, grid)

    def plans(h, w, window):
        p = tail_plan(h, w, *grid, *grid, True, 19, 2, tile, window=window)
        return [p, p._replace(kc=4, smem=tail_smem(p.br, p.nr, p.nc, 4, 2))]
    for s, got, want, _, _ in _shard_walks(xt, grid, n, True, plans):
        assert torch.equal(got, want)
        assert torch.equal(got, full[:, s * 16:(s + 1) * 16])


# ------------------------------------------------------------ W-first plan

@pytest.mark.parametrize("tile", FLAT_TILES)
@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("ac", [True, False])
def test_flat_plan_on_the_g2_path(tile, esize, ac):
    """G2's 128x128 logits -> 512x512: every tile stages the rows and
    columns its bands and segments name, and fits three blocks an SM."""
    p = flat_plan(128, 128, 512, 512, 512, 512, ac, 19, esize, tile)
    assert (p.br, p.sw) == tile and p.sw % (32 * FLAT_PX) == 0
    assert p.smem == flat_smem(p.nr, p.nc, p.kc, esize) <= _THREE_BLOCKS
    if flat_smem(p.nr, p.nc, 1, esize) * 19 <= _THREE_BLOCKS:
        assert p.kc == 19
    rows, _ = interp_taps(128, 512, ac, 512, False)
    cols, _ = interp_taps(128, 512, ac, 512, False)
    assert p.nr == max(
        rows[:, o:o + p.br].max() - rows[0, o] + 1 for o in range(0, 512, p.br))
    assert p.nc % 8 == 0 and p.nc >= max(
        cols[:, o:o + p.sw].max() - (cols[0, o] & ~7) + 1
        for o in range(0, 512, p.sw))


@pytest.mark.parametrize("k,esize", [(19, 2), (150, 4), (256, 2)])
def test_flat_plan_fits_any_class_count(k, esize):
    p = flat_plan(64, 128, 256, 512, 250, 509, False, k, esize)
    assert 1 <= p.kc <= k and p.smem <= _SMEM_LIMIT
    assert p.smem == flat_smem(p.nr, p.nc, p.kc, esize)
    if flat_smem(p.nr, p.nc, 1, esize) * k <= _THREE_BLOCKS:
        assert p.kc == k


@pytest.mark.parametrize("tile", [(8, 256), (4, 192), (4, 1152), (2, 256)])
def test_flat_plan_rejects_tiles_without_a_kernel(tile):
    with pytest.raises(ValueError, match="no W-first kernel"):
        flat_plan(128, 128, 512, 512, 512, 512, True, 19, 2, tile)


@pytest.mark.parametrize("wo,shift_out,want_vout", [
    (512, 0, 1), (509, 0, 0), (510, 0, 0), (500, 0, 1), (512, 2, 0)])
def test_flat_args_take_4_byte_stores(wo, shift_out, want_vout):
    p = flat_plan(128, 128, 512, 512, 512, wo, True, 19, 2)
    got = tail_args(p, 128, wo, 2, 4096, 8192 + shift_out, FLAT_PX)
    assert got[:6] == tuple(p) and got[6:] == (1, want_vout)


# ------------------------------------------------------------ W-first walk

def walk_w_first(x, rows, rw, cols, cw, plan):
    """upsample_argmax_flat_kernel's work on [B, K, h, w] logits with the
    flat tail's tables (cw bf16-rounded in bf16 mode), item by item: a
    thread's FLAT_PX columns over the band's rows, the W pass of two
    staged rows kept (za of row ra, zb of row rb) and each staged row's W
    pass computed once a class. Returns the mask; checks the taps lie in
    what an item staged, that the threads tile the segment and that every
    mask pixel is written once."""
    b_n, k_n, h, w = x.shape
    ho, wo = rows.shape[1], cols.shape[1]
    br, sw, nr, nc = plan.br, plan.sw, plan.nr, plan.nc
    threads = sw // FLAT_PX
    t_col = (np.arange(threads)[:, None] * FLAT_PX
             + np.arange(FLAT_PX)).ravel()
    assert (np.sort(t_col) == np.arange(sw)).all()
    out = np.zeros((b_n, ho, wo), np.uint8)
    written = np.zeros((b_n, ho, wo), np.int64)
    for b in range(b_n):
        for oy0 in range(0, ho, br):
            nrow = min(br, ho - oy0)
            r_lo = rows[0, oy0]
            i0 = rows[0, oy0:oy0 + nrow] - r_lo
            i1 = rows[1, oy0:oy0 + nrow] - r_lo
            assert i0.min() >= 0 and max(i0.max(), i1.max()) < nr
            for ox0 in range(0, wo, sw):
                c_lo = cols[0, ox0] & ~7
                ox = ox0 + t_col
                live = ox < wo
                oxl = np.minimum(ox, wo - 1)
                j0 = np.where(live, cols[0, oxl] - c_lo, 0)
                j1 = np.where(live, cols[1, oxl] - c_lo, 0)
                b0 = np.where(live, cw[0, oxl], 0).astype(F32)
                b1 = np.where(live, cw[1, oxl], 0).astype(F32)
                assert j0.min() >= 0 and j1.max() < nc
                best = np.full((nrow, sw), -np.inf, F32)
                idx = np.zeros((nrow, sw), np.uint8)
                for k0 in range(0, k_n, plan.kc):
                    kc = min(plan.kc, k_n - k0)
                    xs = np.zeros((kc, nr, nc), F32)   # zero outside
                    n_r, n_c = min(nr, h - r_lo), min(nc, w - c_lo)
                    xs[:, :n_r, :n_c] = x[b, k0:k0 + kc, r_lo:r_lo + n_r,
                                          c_lo:c_lo + n_c]
                    for kk in range(kc):
                        ra = rb = -1
                        passes = 0
                        for r in range(nrow):
                            if i0[r] != ra:
                                if i0[r] == rb:
                                    za = zb
                                else:
                                    xr = xs[kk, i0[r]]
                                    za = b0 * xr[j0] + b1 * xr[j1]
                                    passes += 1
                                ra = i0[r]
                            if i1[r] != rb:
                                if i1[r] == ra:
                                    zb = za
                                else:
                                    xr = xs[kk, i1[r]]
                                    zb = b0 * xr[j0] + b1 * xr[j1]
                                    passes += 1
                                rb = i1[r]
                            gy = oy0 + r
                            v = rw[0, gy] * za + rw[1, gy] * zb
                            upd = v > best[r]
                            best[r][upd] = v[upd]
                            idx[r][upd] = k0 + kk
                        # one W pass a class and staged row the band names
                        assert passes == len(set(i0) | set(i1))
                for r in range(nrow):
                    out[b, oy0 + r, ox[live]] = idx[r][live]
                    written[b, oy0 + r, ox[live]] += 1
    assert (written == 1).all()
    return torch.from_numpy(out)


# (logits shape, in_hw is shape[2:], grid, crop)
_FLAT_WALKS = {
    "g2_x4": ((1, 19, 32, 32), (128, 128), None),
    "crop_ragged": ((2, 5, 16, 24), (64, 96), (61, 93)),
    "odd_scale": ((1, 7, 12, 10), (30, 33), None),
    "two_segments": ((1, 3, 8, 80), (32, 320), (30, 318)),
}


def _flat_case(case, dtype, ac, seed):
    shape, grid, crop = _FLAT_WALKS[case]
    xt = _logits(shape, dtype, seed)
    b, k, h, w = shape
    ho, wo = crop or grid
    rows, rw = interp_taps(h, grid[0], ac, ho, False)
    cols, cw = interp_taps(w, grid[1], ac, wo, dtype == torch.bfloat16)
    want = upsample_argmax_flat_plain(xt.reshape(b, k, h * w), (h, w), grid,
                                      crop_hw=crop, align_corners=ac)
    return xt, (rows, rw, cols, cw), want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ac", [True, False])
@pytest.mark.parametrize("case", sorted(_FLAT_WALKS))
def test_flat_walk_gives_the_twin_bits(case, ac, dtype):
    xt, tables, want = _flat_case(case, dtype, ac, seed=len(case))
    _, k, h, w = xt.shape
    shape, grid, crop = _FLAT_WALKS[case]
    ho, wo = crop or grid
    plan = flat_plan(h, w, *grid, ho, wo, ac, k, xt.element_size())
    assert torch.equal(walk_w_first(xt.float().numpy(), *tables, plan), want)


@pytest.mark.parametrize("tile", FLAT_TILES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flat_walk_every_tile_and_class_chunk(tile, dtype):
    """Every (BR, SW) tile, and chunks of 4 of 19 classes (the last
    ragged) with exact ties across two chunks: ties still go to the
    lower class."""
    xt, tables, want = _flat_case("g2_x4", dtype, False, seed=5)
    xt[:, 9] = xt[:, 2]
    want = upsample_argmax_flat_plain(xt.reshape(1, 19, 32 * 32), (32, 32),
                                      (128, 128), align_corners=False)
    p = flat_plan(32, 32, 128, 128, 128, 128, False, 19, xt.element_size(),
                  tile)
    p4 = p._replace(kc=4, smem=flat_smem(p.nr, p.nc, 4, xt.element_size()))
    for plan in (p, p4):
        assert torch.equal(walk_w_first(xt.float().numpy(), *tables, plan),
                           want)


def test_flat_walk_shares_the_w_pass_between_rows():
    """At x4 a band of 4 output rows names 2-3 staged rows, each W-passed
    once a class: 0.75 W passes an output row, where the per-pixel kernel
    ran two (one a tap)."""
    br = FLAT_TILES[0][0]
    rows, _ = interp_taps(128, 512, True, 512, False)
    named = [len(set(rows[:, o:o + br].ravel())) for o in range(0, 512, br)]
    assert max(named) <= 3 and sum(named) / 512 < 0.75


# ------------------------------------------------------ the entries' ints

@contextlib.contextmanager
def stood_in(monkeypatch, name):
    """``ua.<name>`` replaced by a stand-in C entry that records its
    arguments, with the plan it is handed read back as 8 ints; the CUDA
    device switch and stream are stood in too (CPU tensors)."""
    calls = []

    def entry(*args):
        calls.append(args[:9] + (args[9:13],
                                 tuple((ctypes.c_int * 8).from_address(
                                     args[13])), args[14]))
        return 0
    monkeypatch.setattr(ua, name, lambda: entry)
    monkeypatch.setattr(ua.torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(ua.torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=77))
    yield calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ac", [True, False])
def test_sharded_launch_hands_the_window_and_its_tables(monkeypatch, dtype,
                                                        ac):
    """Each shard launches the H-first entry with h = its window's rows,
    Ho = its mask rows, its own tables and the window's plan."""
    shape, grid, n = (1, 19, 16, 24), (64, 96), 4
    xt = _logits(shape, dtype, seed=2)
    ext = [e.contiguous() for e in halo_exchange(list(xt.chunk(n, dim=2)),
                                                 1, 1)]
    with stood_in(monkeypatch, "_tail_entry") as calls:
        outs = [ua._sharded_launch(e, grid, s, n, ac)
                for s, e in enumerate(ext)]
    assert len(calls) == n
    esize = xt.element_size()
    for s, (e, out, call) in enumerate(zip(ext, outs, calls)):
        ptrs, ints, tabs, plan, stream = call[:2], call[2:9], call[9], \
            call[10], call[11]
        assert ptrs == (e.data_ptr(), out.data_ptr()) and stream == 77
        assert out.shape == (1, 16, 96) and out.dtype == torch.uint8
        assert ints == (1, 19, 6, 24, 16, 96, int(dtype == torch.bfloat16))
        window = (s * 16, 16, s * 4 - 1)
        dev_tabs = ua._shard_tables(16, 24, *grid, window, ac,
                                    dtype == torch.bfloat16, e.device)
        assert tabs == tuple(t.data_ptr() for t in dev_tabs)
        for t, want in zip(dev_tabs, shard_taps(16, 24, *grid, window, ac,
                                                dtype == torch.bfloat16)):
            np.testing.assert_array_equal(t.numpy(), want)
        p = tail_plan(16, 24, *grid, *grid, ac, 19, esize, window=window)
        assert plan == tail_args(p, 24, 96, esize, e.data_ptr(),
                                 out.data_ptr())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("crop", [None, (61, 93)])
def test_flat_launch_hands_its_plan(monkeypatch, dtype, crop):
    """The W-first entry gets the view's [B, K, h, w], the crop, the flat
    tables (W weights bf16 in bf16 mode) and flat_plan with 4-byte
    stores."""
    xt = _logits((2, 5, 16 * 24), dtype, seed=3)
    with stood_in(monkeypatch, "_flat_entry") as calls:
        out = ua._flat_launch(xt, (16, 24), (64, 96), crop, True)
    (call,) = calls
    ho, wo = crop or (64, 96)
    bf16 = dtype == torch.bfloat16
    assert call[:2] == (xt.data_ptr(), out.data_ptr()) and call[11] == 77
    assert call[2:9] == (2, 5, 16, 24, ho, wo, int(bf16))
    tabs = ua._flat_device_tables(16, 24, 64, 96, ho, wo, True, bf16,
                                  xt.device)
    assert call[9] == tuple(t.data_ptr() for t in tabs)
    np.testing.assert_array_equal(tabs[3].numpy(),
                                  interp_taps(24, 96, True, wo, bf16)[1])
    esize = xt.element_size()
    p = flat_plan(16, 24, 64, 96, ho, wo, True, 5, esize)
    assert call[10] == tail_args(p, 24, wo, esize, xt.data_ptr(),
                                 out.data_ptr(), FLAT_PX)
    assert call[10][7] == int(wo % 4 == 0)
