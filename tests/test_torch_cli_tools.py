"""The port's remaining CLI tools and helpers against the JAX package's,
on the CPU:

* ``main_search fidelity`` end to end from files, as
  tests/test_fidelity_drill.py drives the JAX package's: a twin segmenter
  in the upstream layout (tonylins MobileNet-v2 trunk and genotype
  decoder, BatchNorm perturbed) saved with ``torch.save`` as a released
  checkpoint is packaged, its golden made by the reference's inference
  (normalize, pad to the stride, forward, bilinear with align_corners,
  crop) on a 56x72 image that pads to 64x96; the f32 engine must report
  worst max|dlogit| < 1e-3 and exit 0 at ``--max-dlogit 1e-3``, and a
  wrong checkpoint must exit 1;
* the kernel build cache's knobs (``utils.cache``): the build directory
  and ``library_path`` under ``SEGTPU_CACHE_DIR``, ``SEGTPU_NO_CACHE=1``
  and neither, and the entry points calling it (no ``nvcc`` is needed:
  nothing is built);
* ``prettify`` equal to JAX's for arch0, arch1 and arch2, and the search
  logging it;
* ``measure_checkpoint_miou`` equal to JAX's on one ``run_training``
  checkpoint over an on-disk split of ``.npy`` files;
* ``debug_mode`` raising on a planted NaN, forward and backward;
  ``trace`` writing a trace and the program's spans;
  ``StepTimer.steps_per_sec`` and ``sec_per_step`` against the JAX
  package's on the same clock.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from segtpu.models.micro_decoders import prettify as jax_prettify
from segtpu.train import measure_checkpoint_miou as jax_measure
from segtpu.utils import profiling as jax_profiling
from segtpu.utils.helpers import prepare_img

from segtpu_torch import main_search
from segtpu_torch.config import SearchConfig
from segtpu_torch.data.datasets import BatchLoader, SyntheticDataset
from segtpu_torch.kernels import _build
from segtpu_torch.models import ARCHS, create_segmenter, prettify
from segtpu_torch.search import run_search
from segtpu_torch.train import (TrainConfig, measure_checkpoint_miou,
                                run_training)
from segtpu_torch.utils import cache, profiling
from segtpu_torch.utils.profiling import StepTimer, debug_mode, trace

from test_fidelity_drill import (TorchSegmenter, _randomize_bn,
                                 _released_style_ckpt)

K = 7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread while this module runs (the suite runs six
    workers on the machine's cores), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _exact_convolutions():
    """PyTorch's own f32 convolutions, not oneDNN's, for every test (as
    in tests/test_torch_trainer.py: the mIoU comparison with JAX counts
    argmax near-ties, which oneDNN's sums move)."""
    was = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = was


@pytest.fixture(autouse=True)
def _cache_state(monkeypatch):
    """Each test starts from the cache module's state at import, with
    neither knob set, and leaves the module state as it found it."""
    saved = (_build.BUILD_DIR, cache._ENABLED_DIR, cache._FRESH_DIR)
    monkeypatch.delenv("SEGTPU_CACHE_DIR", raising=False)
    monkeypatch.delenv("SEGTPU_NO_CACHE", raising=False)
    cache._ENABLED_DIR = cache._FRESH_DIR = None
    _build.BUILD_DIR = _build.DEFAULT_BUILD_DIR
    yield
    _build.BUILD_DIR, cache._ENABLED_DIR, cache._FRESH_DIR = saved


# --------------------------------------------------------------- fidelity


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """(checkpoint, wrong checkpoint, golden): the drill's files."""
    tmp = tmp_path_factory.mktemp("fidelity")
    torch.manual_seed(11)
    twin = TorchSegmenter(ARCHS["arch0"], K).eval()
    _randomize_bn(twin, 12)
    ckpt = str(tmp / "arch0_drill.ckpt")
    _released_style_ckpt(twin, ckpt)
    torch.manual_seed(99)
    wrong = str(tmp / "wrong.ckpt")
    _released_style_ckpt(TorchSegmenter(ARCHS["arch0"], K).eval(), wrong)

    rng = np.random.RandomState(0)
    h, w, hp, wp = 56, 72, 64, 96
    img_u8 = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
    x = np.pad(prepare_img(img_u8), ((0, hp - h), (0, wp - w), (0, 0)))
    with torch.no_grad():
        logits = twin(torch.from_numpy(
            np.transpose(x[None], (0, 3, 1, 2)).copy()))
        logits = F.interpolate(logits, size=(hp, wp), mode="bilinear",
                               align_corners=True)[:, :, :h, :w]
    golden = str(tmp / "golden0.npz")
    np.savez(golden, image=img_u8,
             logits=np.transpose(logits.numpy(), (0, 2, 3, 1))[0])
    return ckpt, wrong, golden


def _fidelity(ckpt, golden):
    main_search.main(["fidelity", "--arch", "arch0", "--num-classes",
                      str(K), "--ckpt", ckpt, "--golden", golden,
                      "--max-dlogit", "1e-3", "--device", "cpu"])


def test_fidelity_passes_on_the_checkpoint(drill, capsys):
    ckpt, _, golden = drill
    _fidelity(ckpt, golden)
    out = capsys.readouterr().out
    line = out.splitlines()[-2]
    assert line.startswith(f"{golden}: max|dlogit|=")
    assert float(line.split("argmax-agreement=")[1]) == 1.0
    worst = float(out.rsplit("worst max|dlogit|:", 1)[1].split()[0])
    assert worst < 1e-3


def test_fidelity_fails_a_wrong_checkpoint(drill, capsys):
    _, wrong, golden = drill
    with pytest.raises(SystemExit) as e:
        _fidelity(wrong, golden)
    assert e.value.code == 1
    assert "FAIL: worst" in capsys.readouterr().out


# ----------------------------------------------------------- cache knobs


def test_cache_default_is_the_package_build_dir():
    assert cache.enable_compilation_cache() == str(_build.DEFAULT_BUILD_DIR)
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
    assert _build.DEFAULT_BUILD_DIR == _build.PKG_DIR / "_build"
    assert _build.library_path("front").parent == _build.DEFAULT_BUILD_DIR


def test_cache_dir_knob_moves_the_libraries(tmp_path, monkeypatch):
    monkeypatch.setenv("SEGTPU_CACHE_DIR", str(tmp_path))
    assert cache.enable_compilation_cache() == str(tmp_path)
    lib = _build.library_path("front")
    assert lib.parent == tmp_path and lib.name.startswith("front-")
    # the first call's choice stays, as the JAX package's does
    monkeypatch.setenv("SEGTPU_CACHE_DIR", str(tmp_path / "other"))
    assert cache.enable_compilation_cache() == str(tmp_path)


def test_cache_dir_argument(tmp_path):
    assert cache.enable_compilation_cache(str(tmp_path)) == str(tmp_path)
    assert _build.library_path("cell").parent == tmp_path


def test_no_cache_builds_into_a_fresh_directory(monkeypatch):
    monkeypatch.setenv("SEGTPU_NO_CACHE", "1")
    assert cache.enable_compilation_cache() is None
    fresh = _build.BUILD_DIR
    assert fresh != _build.DEFAULT_BUILD_DIR and fresh.is_dir()
    assert not any(fresh.iterdir())
    assert _build.library_path("resize").parent == fresh
    # one directory a process
    assert cache.enable_compilation_cache() is None
    assert _build.BUILD_DIR == fresh


@pytest.mark.parametrize("entry", ["main", "engine"])
def test_entry_points_enable_the_cache(tmp_path, monkeypatch, entry):
    monkeypatch.setenv("SEGTPU_CACHE_DIR", str(tmp_path))
    if entry == "main":
        with pytest.raises(SystemExit):
            main_search.main(["--help"])
    else:
        from segtpu_torch.engine import Segmenter
        Segmenter(create_segmenter(ARCHS["arch0"], K, device="cpu",
                                   generator=torch.Generator().manual_seed(0)),
                  device="cpu")
    assert _build.BUILD_DIR == tmp_path


# --------------------------------------------------------------- prettify


@pytest.mark.parametrize("name", ["arch0", "arch1", "arch2"])
def test_prettify_matches_jax(name):
    assert prettify(ARCHS[name]) == jax_prettify(ARCHS[name])


def test_search_logs_prettify(tmp_path, caplog):
    cfg = SearchConfig(synthetic=True, num_classes=4, crop_size=(32, 32),
                       batch_size=(4, 4), num_epochs=(1, 1), num_iters=1,
                       snapshot_dir=str(tmp_path))
    with caplog.at_level(logging.INFO, logger="segtpu_torch.search"):
        saver = run_search(cfg, device="cpu")
    genotype = saver.history[0]["genotype"]
    assert prettify(genotype) in caplog.text


# ------------------------------------------------ measure_checkpoint_miou


def test_measure_checkpoint_miou_matches_jax(tmp_path):
    """A run_training checkpoint (two epochs on a synthetic split) and a
    split of 6 .npy images with masks on disk: the port's mIoU and JAX's
    on the same files, equal."""
    ds = SyntheticDataset(n=6, hw=(64, 64), num_classes=4, seed=3)
    lines = []
    for i in range(len(ds)):
        np.save(tmp_path / f"img{i}.npy", ds.images[i])
        np.save(tmp_path / f"mask{i}.npy", ds.masks[i])
        lines.append(f"img{i}.npy mask{i}.npy")
    (tmp_path / "val.lst").write_text("\n".join(lines) + "\n")
    cfg = TrainConfig(num_classes=4, crop_size=(32, 32), batch_size=4,
                      num_epochs=2, val_every=1,
                      snapshot_dir=str(tmp_path / "snap"))
    loaders = tuple(BatchLoader(ds, batch_size=4, crop=(32, 32), train=t)
                    for t in (True, False))
    run_training(ARCHS["arch2"], *loaders, cfg, device="cpu")
    ckpt = str(tmp_path / "snap" / "best_params.npz")
    kw = dict(data_root=str(tmp_path), val_list=str(tmp_path / "val.lst"),
              num_classes=4, crop=(64, 64), batch_size=4)
    got = measure_checkpoint_miou(ckpt, ARCHS["arch2"], device="cpu", **kw)
    want = jax_measure(ckpt, ARCHS["arch2"], **kw)
    assert np.isfinite(got) and got == want


# --------------------------------------------------------------- profiling


class _Log(torch.nn.Module):
    def forward(self, x):
        return torch.log(x)


def test_debug_mode_raises_on_a_forward_nan():
    with debug_mode():
        _Log()(torch.ones(3))
    with pytest.raises(FloatingPointError, match="log"):
        with debug_mode():
            _Log()(-torch.ones(3))
    _Log()(-torch.ones(3))      # and checks nothing outside the block


def test_debug_mode_raises_on_a_backward_nan():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(FloatingPointError, match="nan"):
        with debug_mode():
            # sqrt's gradient at 0 is inf, times the zero upstream: NaN
            (torch.sqrt(x) * 0).sum().backward()


def test_trace_writes_a_trace(tmp_path):
    from segtpu_torch.utils.solvers import polyak_update
    logdir = tmp_path / "trace"
    assert not profiling.enabled()
    with trace(str(logdir)):
        # tracing is on in the block: the program's spans are recorded
        assert profiling.enabled()
        torch.nn.Linear(4, 4)(torch.ones(2, 4)).sum()
        polyak_update({"w": torch.zeros(3)}, {"w": torch.ones(3)}, 0.9, 5)
    assert not profiling.enabled()
    path = logdir / "trace.json"
    assert path.is_file() and os.path.getsize(path) > 0
    text = path.read_text()
    assert "aten::" in text and "segtpu.train.polyak" in text
    spans = json.loads((logdir / "spans.json").read_text())
    assert [s["name"] for s in spans] == ["segtpu.train.polyak"]
    assert spans[0]["host_ms"] > 0 and spans[0]["parent"] is None


class _Clock:
    """A scripted clock: step 1 and 2 (warm-up) take 1 s and 2 s, steps 3
    and 4 half a second each."""

    def __init__(self):
        self._ticks = iter([0.0, 1.0, 1.0, 3.0, 3.0, 3.5, 3.5, 4.0])

    def time(self):
        return next(self._ticks)

    perf_counter = time


def test_step_timer_rates_match_jax(monkeypatch):
    """The port's StepTimer and the JAX package's on the same scripted
    clock: the warm-up skipped, the same steps/s, items/s and s/step."""
    monkeypatch.setattr(profiling, "time", _Clock())
    monkeypatch.setattr(jax_profiling, "time", _Clock())
    timers = (StepTimer(warmup=2), jax_profiling.StepTimer(warmup=2))
    for t in timers:
        assert t.steps_per_sec is None and t.sec_per_step is None
        for _ in range(4):
            with t.step(n_items=4):
                pass
    got, want = timers
    assert got.steps_per_sec == want.steps_per_sec == 2.0
    assert got.sec_per_step == want.sec_per_step == 0.5
    assert got.items_per_sec == want.items_per_sec == 8.0
