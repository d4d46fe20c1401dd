"""segtpu_torch's ``space`` axis of sharded training (``core/bands.py``;
``parallel.mesh.shard_batch``, ``make_sharded_train_step`` and
``make_sharded_eval_step`` on meshes with ``space`` > 1) on logical CPU
devices, at tests/test_parallel.py's size: arch0 with aux heads (it has
GAP, ``conv3x3_dil3`` and ``sep_conv_5x5_dil6``), K = 5 classes, 4
images of 64x64, in f32 with PyTorch's own convolutions (see
tests/test_torch_data_parallel.py, whose helpers and rule these tests
share).

The JAX package places images as ``P("data", "space", None, None)`` and
XLA partitions the step, inserting the convolutions' halo exchanges and
the global reductions; its sharded step is its unsharded step up to
rounding. The port's is held to that:

* ``shard_batch`` on (2, 2) and (4, 2) gives each device exactly the
  rows JAX's ``shard_batch`` places on the device at its mesh position;
* one step on (1, 2), (2, 2) and JAX's own (4, 2) (template0 on (2, 2))
  against the unsharded step on the whole batch: the loss at rtol 2e-4,
  the parameters, traces, Polyak averages and running stats within
  max(FLOOR, SPREAD x the unsharded step's own spread);
* three planted faults fail those limits on (1, 2): zero halos (every
  band reads zeros past its cuts), the pool over the band alone, and
  ghost BatchNorm across the ``space`` axis (each band's own moments);
* the eval on JAX's (2, 4) mesh, where stride 32 has 2 rows over 4
  shards (empty bands): the unsharded confusion matrix, and JAX's
  ``make_sharded_eval_step``'s;
* the primitives in threads of one row: ``Bands.rows`` from any shard
  and past both ends of the image, with its gradient; a banded
  ``ConvBN`` at strides 1 and 2 and dilations 1 to 12 (more rows than a
  band holds), forward and input gradient; the encoder on bands from
  either stem (the s2d12 stem's top padding row is the image's); a
  banded ``resize_bilinear`` up, down and to its own size, at both
  ``align_corners``;
* a shard that fails on a ``space`` mesh raises in the caller, and the
  others do not hang.
"""

import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from segtpu.parallel.mesh import make_mesh as jax_make_mesh
from segtpu.parallel.mesh import shard_batch as jax_shard_batch

from segtpu_torch.core import bands
from segtpu_torch.core.bands import band
from segtpu_torch.core.layers import ConvBN
from segtpu_torch.core.resize import resize_bilinear
from segtpu_torch.engine import trainer
from segtpu_torch.engine.trainer import init_train_state, make_train_step
from segtpu_torch.models.encoders import MobileNetV2, space_to_depth
from segtpu_torch.parallel import (make_mesh, make_sharded_train_step,
                                   shard_batch)
from segtpu_torch.utils.solvers import create_optimisers

from test_torch_data_parallel import (  # noqa: F401 - its two fixtures
    HW, K, N, _batch, _eval_matches_unsharded_and_jax, _exact_convolutions,
    _fails, _holds, _in_threads, _model, _one_thread, _run)

ARCH = "arch0"
STEPS = (("arch0", (1, 2)), ("arch0", (2, 2)), ("arch0", (4, 2)),
         ("template0", (2, 2)))
_ROWS = bands.Bands.rows


def _zero_halo_rows(self, lo, hi):
    """Planted: every band reads zeros past its cuts, not the other
    shards' rows."""
    own = copy.copy(self)
    own.parts = [p if i == self.rank else torch.zeros_like(p)
                 for i, p in enumerate(self.parts)]
    return _ROWS(own, lo, hi)


def _band_mean(x):
    """Planted: the pool over the shard's own band."""
    return x.float().mean((-2, -1), keepdim=True)


FAULTS = {"zero_halos": (bands.Bands, "rows", _zero_halo_rows),
          "band_local_gap": (bands, "mean_hw", _band_mean),
          "ghost_bn_across_space": "ghost_bn"}


def _cpu_mesh(data, space):
    return make_mesh(data, space, devices=["cpu"] * (data * space))


# ------------------------------------------------------------- placement


@pytest.mark.parametrize("mesh", [(2, 2), (4, 2)])
def test_shard_batch_places_the_rows_jax_places(mesh):
    """Each device's image and label rows are those JAX's shard_batch
    puts on the device at the same mesh position, exactly; a teacher is
    cut along N and its own rows by the same rule."""
    b = _batch()
    jm = jax_make_mesh(*mesh, devices=jax.devices("cpu"))
    placed = jax_shard_batch(jm, {k: jnp.asarray(v) for k, v in b.items()})
    teacher = torch.randn(N, K, HW // 4, HW // 4)
    shards = shard_batch(_cpu_mesh(*mesh), dict(b, teacher=teacher))
    devices = list(jm.devices.flat)
    assert len(shards) == len(devices)
    for key in ("image", "label"):
        held = {s.device: np.asarray(s.data)
                for s in placed[key].addressable_shards}
        for r, shard in enumerate(shards):
            np.testing.assert_array_equal(shard[key].numpy(),
                                          held[devices[r]])
    per = N // mesh[0]
    for r, shard in enumerate(shards):
        d, s = divmod(r, mesh[1])
        lo, hi = band(HW // 4, mesh[1], s)
        assert torch.equal(shard["teacher"],
                           teacher[d * per:(d + 1) * per, :, lo:hi])


# ------------------------------------------------------------ train step


@pytest.mark.parametrize("arch, mesh", STEPS)
@pytest.mark.parametrize("what", ["loss", "params", "stats", "polyak"])
def test_space_step_matches_unsharded(arch, mesh, what):
    """One step on the (data, space) mesh against the unsharded step, by
    tests/test_torch_data_parallel.py's rule."""
    _holds(_run(mesh[0], arch=arch, space=mesh[1])[1], what, arch)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_limits(fault):
    """Each fault throws the loss, and both groups' parameters, traces
    and Polyak averages, out of ``test_space_step_matches_unsharded``'s
    limits on (1, 2)."""
    _fails(_run(1, fault=FAULTS[fault], arch=ARCH, space=2)[1],
           ["params", "trace", "polyak"], ARCH)


# ------------------------------------------------------------------ eval


def test_space_eval_matches_unsharded_and_jax():
    """On JAX's eval mesh (2, 4), where the stride-32 maps have empty
    bands: the unsharded confusion matrix and JAX's sharded eval's."""
    _eval_matches_unsharded_and_jax(_model(ARCH).genotype, 2, 4)


# ------------------------------------------------------------ primitives


def _bands_of(x, n, r):
    lo, hi = band(x.shape[-2], n, r)
    return x[..., lo:hi, :]


@pytest.mark.parametrize("n", [2, 4])
def test_rows_from_any_shard_and_past_both_ends(n):
    """Every shard reads any window of the global rows, from whichever
    shards hold them, with zeros outside the image; the global size is
    the rows summed; gradients reach the rows' owners."""
    h = 10
    x = torch.arange(2 * 3 * h * 4, dtype=torch.float32).reshape(
        2, 3, h, 4).requires_grad_()
    windows = [(-3, 4), (0, h), (2, 9), (6, h + 4), (-2, h + 3), (5, 5)]

    def read(r):
        view = bands.gather(_bands_of(x, n, r))
        return (view.h, bands.global_hw(_bands_of(x, n, r)),
                [view.rows(lo, hi) for lo, hi in windows])

    padded = F.pad(x, (0, 0, 5, 5))
    loss = 0.0
    for r, (h_got, hw, rows) in enumerate(_in_threads(n, read, row=True)):
        assert h_got == h and hw == (h, 4)
        for (lo, hi), got in zip(windows, rows):
            assert torch.equal(got, padded[:, :, lo + 5:hi + 5]), (r, lo, hi)
            loss = loss + (got * (r + 1)).sum()
    loss.backward()
    want = torch.zeros_like(padded)
    for r in range(n):
        for lo, hi in windows:
            want[:, :, lo + 5:hi + 5] += r + 1
    assert torch.equal(x.grad, want[:, :, 5:h + 5])


@pytest.mark.parametrize("stride, dilation",
                         [(1, 1), (1, 3), (1, 6), (1, 12), (2, 1), (2, 3)])
def test_banded_convbn_is_the_rows_of_the_whole(stride, dilation):
    """A train-mode 3x3 ConvBN on 4 bands of 30 rows (7 or 8 a band,
    fewer than dilation 12 reaches): the bands' outputs, stacked, are
    the whole input's, and so is the input's gradient (rel 1e-5)."""
    n, h = 4, 30
    rng = np.random.default_rng(10 * stride + dilation)
    x = torch.from_numpy(rng.standard_normal((2, 3, h, 11)).astype(
        np.float32)).requires_grad_()
    conv = ConvBN(3, 5, 3, stride=stride, dilation=dilation,
                  generator=torch.Generator().manual_seed(0)).train()
    want = conv(x)
    g = torch.from_numpy(rng.standard_normal(want.shape).astype(np.float32))
    (want * g).sum().backward()
    want_grad, x.grad = x.grad, None
    parts = _in_threads(n, lambda r: conv(_bands_of(x, n, r)), row=True)
    assert [p.shape[-2] for p in parts] == [
        hi - lo for lo, hi in (band(want.shape[-2], n, r) for r in range(n))]
    got = torch.cat(parts, -2)
    (got * g).sum().backward()
    for a, b in ((got, want), (x.grad, want_grad)):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-5


@pytest.mark.parametrize("input_format", ["nhwc3", "s2d12"])
def test_banded_encoder_taps_are_the_rows_of_the_whole(input_format):
    """The eval-mode encoder on 4 bands of a 64x64 batch: each tap's
    bands stacked are the whole batch's tap (rel 1e-5), the stride-32 tap
    with empty bands. The s2d12 stem pads the image's top row, not each
    band's."""
    n = 4
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 3, HW, HW)).astype(
        np.float32))
    if input_format == "s2d12":
        x = space_to_depth(x)
    enc = MobileNetV2(generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = enc(x, input_format)
        parts = _in_threads(n, lambda r: enc(_bands_of(x, n, r),
                                             input_format), row=True)
    for i, tap in enumerate(want):
        got = torch.cat([p[i] for p in parts], -2)
        assert ((got - tap).abs().max() / tap.abs().max()).item() <= 1e-5, i
    assert min(p[3].shape[-2] for p in parts) == 0


@pytest.mark.parametrize("align_corners", [True, False])
def test_banded_resize_is_the_rows_of_the_whole(align_corners):
    """resize_bilinear on 3 bands of 13 rows to a global size, up, down
    and to its own: the bands' outputs stacked are the whole resize's
    (to 1e-6 of its largest value), each band the output's band."""
    n = 3
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 4, 13, 9)).astype(np.float32))
    for out in ((29, 17), (5, 4), (2, 9), (13, 9)):
        want = resize_bilinear(x, out, align_corners=align_corners)
        parts = _in_threads(n, lambda r: resize_bilinear(
            _bands_of(x, n, r), out, align_corners=align_corners), row=True)
        assert [p.shape[-2] for p in parts] == [
            hi - lo for lo, hi in (band(out[0], n, r) for r in range(n))]
        got = torch.cat(parts, -2)
        assert ((got - want).abs().max()
                <= 1e-6 * want.abs().max()).item(), out


# --------------------------------------------------------------- failure


def test_a_failing_shard_on_a_space_mesh_raises_and_nobody_hangs(
        monkeypatch):
    """On (2, 2), shard 3 (the lower rows of data row 1) fails before
    its stem: the step raises its error in the caller; shard 2, waiting
    for it at the stem's rows, and shards 0 and 1, at BatchNorm, are let
    go rather than left waiting."""
    real = trainer.images_to
    model = copy.deepcopy(_model(ARCH))
    opt = create_optimisers()
    state = init_train_state(model, opt)
    step = make_sharded_train_step(
        make_train_step(model.genotype, opt, num_classes=K),
        _cpu_mesh(2, 2))
    b = _batch()
    b["image"] = b["image"].copy()
    b["image"][2:, HW // 2:] = np.nan

    def fail_on_nan(image, device):
        if torch.isnan(torch.as_tensor(image)).any():
            raise FloatingPointError("shard 3's rows")
        return real(image, device)

    monkeypatch.setattr(trainer, "images_to", fail_on_nan)
    raised = []

    def run():
        with pytest.raises(FloatingPointError, match="shard 3"):
            step(state, b)
        raised.append(True)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and raised
