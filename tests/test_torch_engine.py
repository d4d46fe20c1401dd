"""segtpu_torch serving path vs the JAX engine, on the CPU.

``Segmenter(device="cpu")`` runs the plain versions of both kernels;
the JAX side is ``build_infer_fn(use_pallas=False)`` on the same
weights (``load_jax_params``, BatchNorm perturbed from a numpy seed).
f32 masks agree on >= 99.9 % of pixels (ties of f32 sums). bf16 masks
agree on >= 99 %: the two frameworks round bf16 convolutions
differently, and the port's tail rounds the H pass to bf16 as the TPU
kernel does, where the JAX reference path upsamples in f32. Measured
at 2x64x128 with these weights: f32 100 %, bf16 99.31 % (99.33 % with
per-conv BatchNorm everywhere, 99.37 % with it folded into the encoder
only: folding rounds the bf16 network at other points than per-conv
BatchNorm does).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from segtpu.engine.inference import build_infer_fn
from segtpu.models.segmenter import segmenter_init

from segtpu_torch.convert import load_jax_params
from segtpu_torch.engine import Segmenter, pad_to_stride
from segtpu_torch.models import ARCHS
from segtpu_torch.models.segmenter import Segmenter as SegmenterNet

from test_torch_layers import _np_tree, perturb_bn

K = 19


@pytest.fixture(scope="module")
def arch0():
    genotype = ARCHS["arch0"]
    p, s = perturb_bn(*_np_tree(segmenter_init(jax.random.PRNGKey(5),
                                               genotype, num_classes=K)),
                      np.random.default_rng(5))
    model = SegmenterNet(genotype, K, generator=torch.Generator().manual_seed(0))
    load_jax_params(model, p, s)
    return genotype, p, s, model.eval()


def _imgs(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _jax_masks(genotype, p, s, imgs, dtype):
    fn = jax.jit(build_infer_fn(genotype, num_classes=K,
                                input_hw=imgs.shape[1:3],
                                compute_dtype=dtype, use_pallas=False))
    return np.asarray(fn(p, s, jnp.asarray(imgs)))


@pytest.mark.parametrize("dtype,min_rate", [("float32", 0.999),
                                            ("bfloat16", 0.99)])
def test_masks_match_jax_engine(arch0, dtype, min_rate):
    genotype, p, s, model = arch0
    imgs = _imgs((2, 64, 128, 3), 0)
    want = _jax_masks(genotype, p, s, imgs, getattr(jnp, dtype))
    seg = Segmenter(model, compute_dtype=getattr(torch, dtype), device="cpu")
    got = seg.predict_batch(imgs)
    assert got.shape == (2, 64, 128) and got.dtype == np.uint8
    rate = (got == want).mean()
    assert rate >= min_rate, f"{dtype} mask agreement {rate}"


@pytest.mark.parametrize("hw", [(70, 100), (65, 97)])
def test_pad_and_odd_shapes_match_jax_engine(arch0, hw):
    """70x100 pads to 96x128 through the s2d front; 65x97 is odd: the
    JAX engine takes its 3x3 stride-2 stem (its use_s2d rule), the port
    packs the padded frame by space-to-depth into the folded encoder."""
    genotype, p, s, model = arch0
    imgs = _imgs((1, *hw, 3), 1)
    want = _jax_masks(genotype, p, s, imgs, jnp.float32)
    seg = Segmenter(model, compute_dtype=torch.float32, device="cpu")
    got = seg.predict(imgs[0])
    assert got.shape == hw
    rate = (got == want[0]).mean()
    assert rate >= 0.999, f"mask agreement {rate}"


def test_return_logits_match_jax_engine(arch0):
    genotype, p, s, model = arch0
    imgs = _imgs((1, 40, 72, 3), 2)
    fn = jax.jit(build_infer_fn(genotype, num_classes=K, input_hw=(40, 72),
                                compute_dtype=jnp.float32, return_logits=True,
                                use_pallas=False))
    want = np.asarray(fn(p, s, jnp.asarray(imgs)))            # [N,H,W,K]
    seg = Segmenter(model, compute_dtype=torch.float32, device="cpu")
    got = seg.predict(imgs, return_logits=True)               # [N,K,H,W]
    assert got.shape == (1, K, 40, 72) and got.dtype == np.float32
    np.testing.assert_allclose(np.transpose(got, (0, 2, 3, 1)), want,
                               rtol=1e-4, atol=1e-4)


def test_single_image_equals_batch_and_tensor_io(arch0):
    *_, model = arch0
    seg = Segmenter(model, device="cpu")
    imgs = _imgs((3, 64, 96, 3), 3)
    batch = seg.predict_batch(imgs)
    for i in range(3):
        np.testing.assert_array_equal(seg.predict(imgs[i]), batch[i])
    out = seg.predict(torch.from_numpy(imgs))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), batch)


def test_predict_stream_keeps_order(arch0):
    *_, model = arch0
    seg = Segmenter(model, device="cpu")
    frames = [_imgs((64, 64, 3), 10 + i) for i in range(3)]
    frames.append(_imgs((2, 32, 64, 3), 20))            # a batch mid-stream
    out = list(seg.predict_stream(iter(frames)))
    assert len(out) == 4
    for f, m in zip(frames, out):
        np.testing.assert_array_equal(m, seg.predict(f))
    assert list(seg.predict_stream([])) == []


def test_engine_defaults_to_cuda_and_keeps_model(arch0):
    *_, model = arch0
    if torch.cuda.is_available():
        pytest.skip("this checks the CUDA-less behaviour")
    with pytest.raises(RuntimeError, match="CUDA"):
        Segmenter(model)
    seg = Segmenter(model, device="cpu")
    # the engine folds and casts its own copies; the caller's model stays
    # f32
    assert model.decoder.clf.w.dtype == torch.float32
    assert model.encoder.stem.w.dtype == torch.float32
    assert seg.decoder.clf_w.dtype == torch.bfloat16
    assert seg.encoder.stem_w.dtype == torch.bfloat16
    assert seg.encoder.stem_b.dtype == torch.float32
    assert pad_to_stride((1000, 1500)) == (1024, 1504)
