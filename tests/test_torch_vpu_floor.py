"""segtpu_torch.kernels.vpu_floor (plain twins) against the f32 floor
experiment's own Pallas kernels (scripts/exp_vpu_floor.py), run in
interpret mode on seeded random inputs.

The script is loaded from its file with its ``pl.pallas_call`` made to
interpret, and its ``pltpu.roll`` given a non-negative shift (a circular
roll by -dx is a roll by n - dx; this jax refuses negative shifts). Its
timing helper is replaced by one that keeps the built call, which the
test then feeds random inputs (the script feeds ones, which would hide an
indexing error). Tolerances: ``fma_peak`` rel 1e-5 (XLA's multiply and
add against the twin's); the tap loop within 1e-6 of its largest value
(the same sums in the same order, but XLA's CPU compiler contracts a
multiply and an add into one fused multiply-add here and there, a
difference of a few f32 ulp).
"""

import functools
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from segtpu_torch.kernels.vpu_floor import (dw_tap_sum, dw_tap_sum_plain,
                                            fma_peak, fma_peak_plain,
                                            tap_halo, taps)
from segtpu_torch.scripts import exp_vpu_floor

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _roll(x, shift, axis):
    return pltpu.roll(x, shift % x.shape[axis], axis)


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(**{**vars(pl), "pallas_call": functools.partial(
        pl.pallas_call, interpret=True)})
    mod.pltpu = types.SimpleNamespace(**{**vars(pltpu), "roll": _roll})
    return mod


@pytest.fixture(scope="module")
def script():
    mod = load_script("exp_vpu_floor")
    built = []
    mod._time = lambda f, *args: built.append(f) or 1.0
    mod.built = built
    return mod


@pytest.mark.parametrize("n_fma,n_acc", [(16, 4), (16, 8), (12, 1)])
def test_fma_peak_matches_pallas_kernel(script, n_fma, n_acc):
    script.bench_peak(c=8, tile=256, grid=2, n_fma=n_fma, n_acc=n_acc)
    x = np.random.default_rng(n_fma + n_acc).standard_normal(
        (2, 8, 256)).astype(np.float32)
    want = np.asarray(script.built[-1](jnp.asarray(x)))
    got = fma_peak_plain(torch.from_numpy(x), n_fma=n_fma, n_acc=n_acc)
    assert got.dtype == torch.float32 and got.shape == (2, 8, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("bench", ["bench_taploop", "bench_taploop_roll"])
@pytest.mark.parametrize("k,dil", [(5, 2), (3, 1)])
def test_dw_tap_sum_matches_pallas_kernel(script, bench, k, dil):
    c, w, rows, grid = 8, 128, 8, 2
    getattr(script, bench)(c, k, dil, w=w, tile_rows=rows, grid=grid)
    rng = np.random.default_rng(k * 10 + dil)
    total = rows * w + 2 * tap_halo(k, dil, w)
    x = rng.standard_normal((grid, c, total)).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16)
    wt = rng.standard_normal((k * k, c, 1)).astype(np.float32)
    want = np.asarray(script.built[-1](
        jnp.asarray(wt), jnp.asarray(x.float().numpy(), jnp.bfloat16)))
    got = dw_tap_sum_plain(x, torch.from_numpy(wt), k=k, dilation=dil, w=w)
    assert got.dtype == torch.float32 and got.shape == (grid, c, rows * w)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_taps_match_reference_helper():
    from segtpu.kernels.chw_ops import _taps
    for k, dil, h, w in [(3, 1, 10**6, 512), (5, 6, 10**6, 512), (7, 12, 8, 8)]:
        assert taps(k, dil, h, w) == _taps(k, dil, h, w)


def test_wrappers_run_twin_on_cpu_without_launching():
    x = torch.randn(2, 4, 64)
    before = (fma_peak.launches, dw_tap_sum.launches)
    assert torch.equal(fma_peak(x, n_fma=8, n_acc=2),
                       fma_peak_plain(x, n_fma=8, n_acc=2))
    xb = torch.randn(1, 4, 16 * 8 + 2 * tap_halo(3, 1, 16)).to(torch.bfloat16)
    wt = torch.randn(9, 4)
    assert torch.equal(dw_tap_sum(xb, wt, k=3, dilation=1, w=16),
                       dw_tap_sum_plain(xb, wt, k=3, dilation=1, w=16))
    assert (fma_peak.launches, dw_tap_sum.launches) == before


def test_wrappers_check_shape_dtype_and_device():
    with pytest.raises(ValueError):
        fma_peak(torch.randn(4).double())                       # not f32
    with pytest.raises(ValueError):
        fma_peak(torch.randn(4), n_fma=8, n_acc=3)              # n_acc
    xb = torch.zeros(1, 4, 16 * 8 + 2 * tap_halo(3, 1, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        dw_tap_sum(xb.float(), torch.randn(9, 4), k=3, dilation=1, w=16)
    with pytest.raises(ValueError):
        dw_tap_sum(xb, torch.randn(9, 5), k=3, dilation=1, w=16)  # C
    with pytest.raises(ValueError):
        dw_tap_sum(xb, torch.randn(9, 4), k=3, dilation=1, w=16, halo=8)
    with pytest.raises(ValueError):
        dw_tap_sum(xb.to("meta"), torch.randn(9, 4), k=3, dilation=1, w=16)


def test_script_runs_on_cpu_only_when_asked():
    out = exp_vpu_floor.run(device="cpu", peak_shape=(2, 4, 64),
                            peak_cases=((8, 4),),
                            tap_cases=((4, 3, 1, 32, 4),),
                            roll_cases=((4, 5, 2, 32, 4),), tap_grid=1)
    assert out["device"] == "cpu"
    assert [len(out[k]) for k in ("peak", "tap", "roll")] == [1, 1, 1]
    assert out["peak"][0]["ms"] is None and out["tap"][0]["bit_identical"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            exp_vpu_floor.run()


@pytest.mark.parametrize("case", [(4, 3, 1, 32, 4, 2), (8, 5, 2, 16, 8, 1)])
def test_tap_bound_counts_each_input_and_output_once(case):
    c, k, dil, w, rows, grid = case
    x, wt = exp_vpu_floor.tap_inputs(c, k, dil, w, rows, grid, "cpu")
    out = dw_tap_sum(x, wt, k=k, dilation=dil, w=w)
    nbytes = x.numel() * 2 + wt.numel() * 4 + out.numel() * 4
    assert exp_vpu_floor.tap_bound_ms(c, k, dil, w, rows, grid) == pytest.approx(
        nbytes / exp_vpu_floor.HBM_BYTES_PER_S * 1e3, rel=1e-12)
