"""The port's per-shape programs (``utils.aot``), the engine's program
cache, the build record and ``segtpu_torch.bench`` against the JAX
package's, on the CPU:

* ``aot_graph`` on the CPU runs eagerly and is keyed: the same key gives
  the same program, another key another; ``SEGTPU_NO_AOT=1`` gives an
  eager program with ``aot_hit`` False, as ``segtpu.utils.aot.aot_jit``;
* ``Segmenter.predict``, ``predict_batch`` and ``predict_stream`` go
  through ``_compiled`` (one program per shape bucket, ``return_logits``
  and staged shape) and equal the eager ``_run`` bit for bit, on a tiny
  arch0 and template0 (an odd frame among them: the path that normalizes
  on the device);
* those masks equal the JAX ``Segmenter``'s (f32, the engine parity
  tests' 99.9 %);
* ``kernels._build``'s record reports no build where none ran;
* the bench's JSON line at ``--device cpu`` (64x128, b1, one rep, one
  batch): its keys, unit and metric name, the roofline fields from the
  port's roofline, none of the JAX fields that are not ported.

A card's graphs (capture, replay, held tensors) are checked by
``chip_smoke.py`` phase ``bench``.
"""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from segtpu.engine.inference import Segmenter as JaxSegmenter
from segtpu.models.segmenter import segmenter_init

from segtpu_torch import main_search
from segtpu_torch.core.layers import ConvBN
from segtpu_torch.engine import Segmenter
from segtpu_torch.kernels import _build
from segtpu_torch.models import ARCHS, TEMPLATE_ARCHS, create_segmenter
from segtpu_torch.utils import aot
from segtpu_torch.utils.roofline import compute_roofline

K = 19
# weight seeds whose masks hold several classes
SEEDS = {"arch0": 3, "template0": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread while this module runs (the suite runs six
    workers on the machine's cores), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """{name: (genotype, the port's model)}, BatchNorm perturbed."""
    out = {}
    for name, genotype in (("arch0", ARCHS["arch0"]),
                           ("template0", TEMPLATE_ARCHS["template0"])):
        gen = torch.Generator().manual_seed(SEEDS[name])
        model = create_segmenter(genotype, K, generator=gen, device="cpu")
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, ConvBN):
                    m.scale.uniform_(0.5, 1.5, generator=gen)
                    m.bias.normal_(0.0, 0.1, generator=gen)
                    m.mean.normal_(0.0, 0.1, generator=gen)
                    m.var.uniform_(0.5, 1.5, generator=gen)
        out[name] = (genotype, model)
    return out


def _jax_trees(genotype, model):
    """(params, stats) of ``model`` as numpy trees in the structure of the
    JAX init (``jax.eval_shape``: empty dicts where an op has no
    weights), kernels OIHW -> HWIO."""
    shapes = jax.eval_shape(lambda k: segmenter_init(k, genotype,
                                                     num_classes=K),
                            jax.random.PRNGKey(0))
    named = {**dict(model.named_parameters()), **dict(model.named_buffers())}

    def leaf(path, sd):
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        arr = named[key].detach().numpy().copy()
        arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr
        assert arr.shape == sd.shape, key
        return arr

    return tuple(jax.tree_util.tree_map_with_path(leaf, t) for t in shapes)


def _imgs(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# ------------------------------------------------------------ aot_graph


def test_aot_graph_on_the_cpu_is_eager_and_keyed(monkeypatch):
    monkeypatch.delenv("SEGTPU_NO_AOT", raising=False)
    x = torch.arange(6.0)
    p1 = aot.aot_graph(lambda t: t * 2, ("double", 6), x)
    assert p1.graph is None and p1.held == ()
    assert p1.aot_hit is True          # this process compiled nothing
    assert p1 is aot.aot_graph(lambda t: t * 3, ("double", 6), x)
    p2 = aot.aot_graph(lambda t: t * 3, ("triple", 6), x)
    assert p2 is not p1
    assert torch.equal(p1(x), x * 2) and torch.equal(p2(x), x * 3)


def test_no_aot_knob_gives_an_eager_program(monkeypatch):
    monkeypatch.setenv("SEGTPU_NO_AOT", "1")
    x = torch.ones(3)
    p = aot.aot_graph(lambda t: t + 1, ("plus one",), x)
    assert p.graph is None and p.aot_hit is False
    assert torch.equal(p(x), x + 1)
    # the knob is part of the key: the same key without it is another one
    monkeypatch.delenv("SEGTPU_NO_AOT")
    assert aot.aot_graph(lambda t: t + 1, ("plus one",), x) is not p


def test_build_record_reports_no_build_when_none_ran(tmp_path, monkeypatch):
    """Every library already in the build directory: ``build()`` runs no
    nvcc (none exists here) and records nothing."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILDS", [])
    for name in _build.KERNEL_SOURCES:
        _build.library_path(name).write_bytes(b"")
    paths = _build.build()
    assert set(paths) == set(_build.KERNEL_SOURCES)
    assert _build.BUILDS == [] and _build.built() == set()
    assert _build.build_seconds() == 0.0
    assert aot.aot_graph(lambda t: t, ("id",), torch.zeros(1)).aot_hit


# ------------------------------------------------------ the engine's cache


@pytest.mark.parametrize("name", ["arch0", "template0"])
def test_predict_paths_through_compiled_equal_eager_run(models, name):
    _, model = models[name]
    seg = Segmenter(model, compute_dtype=torch.float32, device="cpu")
    batch = _imgs((2, 64, 128, 3), 1)
    odd = _imgs((45, 67, 3), 2)

    def eager(imgs, logits=False):
        return seg._run(torch.from_numpy(imgs), return_logits=logits).numpy()

    np.testing.assert_array_equal(seg.predict_batch(batch), eager(batch))
    np.testing.assert_array_equal(seg.predict(odd), eager(odd[None])[0])
    np.testing.assert_array_equal(seg.predict(batch[:1], return_logits=True),
                                  eager(batch[:1], True))
    out = seg.predict(torch.from_numpy(batch))
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), eager(batch))
    streamed = list(seg.predict_stream([batch[0], odd, batch]))
    for got, want in zip(streamed, [eager(batch[:1])[0], eager(odd[None])[0],
                                    eager(batch)]):
        np.testing.assert_array_equal(got, want)
    assert set(seg._cache) == {
        ((64, 128), False, (2, 64, 128, 3), "cpu"),
        ((45, 67), False, (1, 45, 67, 3), "cpu"),
        ((64, 128), True, (1, 64, 128, 3), "cpu"),
        ((64, 128), False, (1, 64, 128, 3), "cpu")}
    with pytest.raises(ValueError, match="uint8"):
        seg.predict(torch.zeros((1, 64, 128, 3)))


@pytest.mark.parametrize("name", ["arch0", "template0"])
def test_compiled_masks_equal_the_jax_segmenter(models, name, monkeypatch):
    genotype, model = models[name]
    imgs = _imgs((2, 64, 128, 3), 0)
    got = Segmenter(model, compute_dtype=torch.float32,
                    device="cpu").predict_batch(imgs)
    with monkeypatch.context() as m:
        # the JAX engine without its on-disk program store and XLA cache
        m.setenv("SEGTPU_NO_AOT", "1")
        m.setenv("SEGTPU_NO_CACHE", "1")
        want = JaxSegmenter(genotype, *_jax_trees(genotype, model),
                            num_classes=K,
                            compute_dtype=jnp.float32).predict_batch(imgs)
    assert got.shape == want.shape == (2, 64, 128)
    second = np.sort(np.bincount(want.ravel(), minlength=K))[-2]
    assert second > 0.01 * want.size, "one class everywhere"
    rate = (got == want).mean()
    assert rate >= 0.999, f"f32 mask agreement {rate}"


# ------------------------------------------------------------ the bench


DROPPED = ("vs_baseline", "assumed_baseline_ips",
           "pct_of_attainable_r4_model", "flops_per_frame_g_xla_lower_bound",
           "trace_s", "xla_compile_s")


def test_bench_json_line_on_the_cpu(monkeypatch, capsys):
    for k, v in (("BENCH_HW", "64x128"), ("BENCH_BATCH", "1"),
                 ("BENCH_REPS", "1"), ("BENCH_SCAN", "1")):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BENCH_ARCH", raising=False)
    monkeypatch.delenv("SEGTPU_NO_AOT", raising=False)
    main_search.main(["bench", "--arch", "arch1", "--device", "cpu"])
    out, err = capsys.readouterr()
    rec = json.loads(out.strip().splitlines()[-1])
    assert list(rec) == [
        "metric", "value", "unit", "compile_s", "build_s", "capture_s",
        "first_exec_s", "aot_hit", "compile_cache",
        "flops_per_frame_g_analytic", "roofline_ips", "pct_of_roofline",
        "attainable_ips", "pct_of_attainable", "gpu"]
    assert rec["metric"] == \
        "cityscapes_64x128_arch1_inference_throughput_per_gpu"
    assert rec["unit"] == "images/sec" and rec["value"] > 0
    assert rec["gpu"] == "cpu" and rec["build_s"] == rec["capture_s"] == 0
    assert rec["compile_s"] == rec["first_exec_s"]
    roof = compute_roofline(64, 128, "arch1", num_classes=K)
    assert rec["flops_per_frame_g_analytic"] == round(roof["gflop_total"], 2)
    assert rec["roofline_ips"] == round(roof["roofline_ips"], 1)
    assert rec["attainable_ips"] == round(roof["attainable_ips"], 1)
    assert abs(rec["pct_of_attainable"]
               - 100 * rec["value"] / roof["attainable_ips"]) < 0.06
    assert not set(DROPPED) & set(rec)
    assert "eager_ips=" in err and "e2e_predict_stream_ips=" in err
