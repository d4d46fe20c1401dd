"""segtpu_torch's template (WACV'20) decoder family vs the JAX package,
on the CPU.

Weights from ``segmenter_init`` with BatchNorm perturbed from a numpy
seed (unless a test says otherwise), carried over by
``load_jax_params``. The genotypes: ``template0``, ``TEMPLATE_G`` of
tests/test_template.py, three that between them put each of the 11 ops
in a block under both aggregations (``FORMS``), and three samples of
the JAX template controller.

* ``TemplateDecoder`` against ``template_decoder_apply``, f32, rtol =
  atol = 1e-4;
* the folded decoder's plain twins against
  ``build_fast_template_decoder(interpret=True)``: f32 at 1e-4, bf16
  with the share of bit-identical logits each measured;
* ``Segmenter(device="cpu")`` masks against
  ``build_infer_fn(use_pallas=False)``: f32 >= 99.9 %, as
  tests/test_torch_engine.py holds arch0; bf16 >= 98 %, no further from
  the f32 masks than that engine's own bf16 run, and >= 99 % against the
  Pallas engine (``test_template_masks_match_jax_engine_bf16`` says why);
* logical shards (``mode="space"``, the decoder whole on the gathered
  taps; ``mode="data"``): masks and logits bit-equal to the unsharded
  engine's, bf16 and f32; and against JAX's
  ``make_sharded_pallas_infer_fn`` in interpret mode, >= 99.9 %.
"""

import copy
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from segtpu.engine.inference import build_infer_fn
from segtpu.models.families import (get_family as jax_get_family,
                                    infer_family as jax_infer_family)
from segtpu.models.fast_decoder import build_fast_template_decoder
from segtpu.models.micro_decoders import GenotypeError as JaxGenotypeError
from segtpu.models.segmenter import segmenter_init
from segtpu.models.template_decoders import (
    template_conns as jax_template_conns, template_decoder_apply,
    validate_template_genotype as jax_validate)
from segtpu.ops.layer_factory import AGG_OP_NAMES as JAX_AGG_OP_NAMES
from segtpu.parallel.mesh import (make_mesh as jax_make_mesh,
                                  make_sharded_pallas_infer_fn)
from segtpu.rl.controller import (TemplateControllerSpec, controller_init,
                                  sample, template_genotype_from_actions)

from segtpu_torch.convert import load_jax_params
from segtpu_torch.engine import Segmenter, ShardedSegmenter
from segtpu_torch.kernels.front import normalize_s2d_front
from segtpu_torch.kernels.upsample_argmax import upsample_argmax_plain
from segtpu_torch.models import (ARCHS, TEMPLATE_ARCHS, GenotypeError,
                                 TemplateDecoder, validate_template_genotype)
from segtpu_torch.models.families import get_family, infer_family
from segtpu_torch.models.fast_decoder import (FoldedTemplateDecoder,
                                              ShardedTemplateDecoder,
                                              fold_decoder)
from segtpu_torch.models.segmenter import Segmenter as SegmenterNet
from segtpu_torch.models.template_decoders import template_conns
from segtpu_torch.ops.layer_factory import AGG_OP_NAMES, OP_NAMES
from segtpu_torch.parallel import make_mesh, make_sharded_infer_fn

from test_torch_layers import _nhwc, _np_tree, perturb_bn

K = 7
CPU = torch.device("cpu")
TAP_SHAPES = [(24, 16, 128), (32, 8, 64), (96, 4, 32), (320, 2, 16)]
TEMPLATE_G = [[3, 2, 0, 2], [4, 1, 1, 0], [5, 0, 0, 9]]
# each of the 11 ops in a block, psum and cat each; FORMS[0]'s first
# block resizes its first branch (a plain add), FORMS[2]'s its second
# (the resize kernel's acc); FORMS[1] collects two entries (pw_multi_chw)
FORMS = [[[3, 2, 0, 0], [4, 1, 1, 1], [5, 0, 0, 2], [6, 2, 1, 3]],
         [[3, 2, 1, 4], [4, 1, 0, 5], [4, 0, 1, 6], [6, 3, 0, 7]],
         [[2, 3, 0, 8], [1, 4, 1, 9], [0, 5, 0, 10], [6, 2, 1, 0]]]


NAMES = (["template0", "TEMPLATE_G"] + [f"forms{i}" for i in range(3)]
         + [f"controller{i}" for i in range(3)])


@functools.lru_cache(maxsize=None)
def _genotype(name):
    """The genotype of ``name``; "controller{i}" is the JAX template
    controller's sample i, drawn on first use (not at import)."""
    if name.startswith("controller"):
        spec = TemplateControllerSpec()
        params = controller_init(jax.random.PRNGKey(0), spec)
        actions = sample(params, spec, jax.random.PRNGKey(int(name[-1])))[0]
        return template_genotype_from_actions(actions, spec)
    if name.startswith("forms"):
        return FORMS[int(name[-1])]
    return {"template0": TEMPLATE_ARCHS["template0"],
            "TEMPLATE_G": TEMPLATE_G}[name]


# weight seeds whose random-weight masks hold several classes (most seeds
# give one class everywhere, which would make a mask comparison empty)
SEEDS = {"template0": 0, "forms1": 5}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread while this module runs: the suite runs six
    workers on the machine's cores, and a pool of intra-op threads in each
    on top of that spends its time waiting for cores (this module's plain
    twins ran 14 times slower so than alone). Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name, seed, perturb=True):
    genotype = _genotype(name)
    p, s = _np_tree(segmenter_init(jax.random.PRNGKey(seed), genotype,
                                   num_classes=K))
    if perturb:
        p, s = perturb_bn(p, s, np.random.default_rng(seed))
    model = SegmenterNet(genotype, K,
                         generator=torch.Generator().manual_seed(0))
    load_jax_params(model, p, s)
    return genotype, p, s, model.eval()


def _taps(seed):
    rng = np.random.default_rng(seed)
    return [np.abs(rng.standard_normal((1, c, h, w))).astype(np.float32)
            for c, h, w in TAP_SHAPES]


def _imgs(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _several_classes(masks):
    """The comparison is not of one class against itself."""
    share = np.bincount(masks.ravel(), minlength=K) / masks.size
    assert np.sort(share)[-2] >= 0.01, f"one class everywhere: {share}"


def test_forms_cover_every_op_and_both_aggregations():
    ops = {(AGG_OP_NAMES[agg], OP_NAMES[op]) for g in FORMS
           for _, _, agg, op in g}
    assert {op for _, op in ops} == set(OP_NAMES)
    assert {agg for agg, _ in ops} == {"psum", "cat"}
    assert AGG_OP_NAMES == JAX_AGG_OP_NAMES
    for name in NAMES:
        g = _genotype(name)
        validate_template_genotype(g)
        assert template_conns(g) == jax_template_conns(g)


def test_invalid_template_genotypes_rejected():
    for bad in ([[0, 1, 5, 0]],                 # agg out of range
                [[0, 9, 0, 0]],                 # index out of range
                [[0, 1, 0]],                    # arity
                [],                             # empty
                [[0, 1, 0, 11]],                # op out of range
                [[0, 1, 0, 0], [0, 5, 0, 0]],   # block 1 reads past its pool
                "nonsense"):
        with pytest.raises(JaxGenotypeError):
            jax_validate(bad)
        with pytest.raises(GenotypeError):
            validate_template_genotype(bad)
        with pytest.raises(GenotypeError):
            SegmenterNet(bad, K, family="template",
                         generator=torch.Generator().manual_seed(0))


def test_family_inference_matches_jax():
    for genotype in (TEMPLATE_G, TEMPLATE_ARCHS["template0"], ARCHS["arch0"],
                     ARCHS["arch2"], [[2, [0, 1, 3, 4]], [[3, 2]]],
                     [[3, 2, 0, 2], [4, 1, 1, 0]], FORMS[1]):
        assert infer_family(genotype).name == \
            jax_infer_family(genotype).name, genotype
    for name in ("micro", "cvpr", "template", "wacv"):
        assert get_family(name).name == jax_get_family(name).name


@pytest.mark.parametrize("name", NAMES)
def test_template_decoder_matches_jax(name):
    genotype, p, s, model = _setup(name, 1)
    taps = _taps(2)
    want, _, _ = template_decoder_apply(
        genotype, p["decoder"], s["decoder"],
        [jnp.asarray(np.transpose(t, (0, 2, 3, 1))) for t in taps])
    with torch.no_grad():
        got = model.decoder([torch.from_numpy(t) for t in taps])
    assert isinstance(model.decoder, TemplateDecoder)
    assert got.shape == (1, K, 16, 128)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert np.abs(np.asarray(want)).max() > 0.1   # not a comparison of zeros


@functools.lru_cache(maxsize=None)
def _fast_logits(name, dtype, seed=3):
    genotype, p, s, model = _setup(name, seed)
    taps = _taps(seed + 1)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    fast = build_fast_template_decoder(genotype, p["decoder"], s["decoder"],
                                       taps_channel_first=True,
                                       interpret=True)
    want = fast([jnp.asarray(t).astype(jdt) for t in taps])
    dec = fold_decoder(model.decoder, dtype)
    with torch.no_grad():
        got = dec([torch.from_numpy(t).to(dtype) for t in taps])
    return got, torch.from_numpy(np.array(want.astype(jnp.float32)))


@pytest.mark.parametrize("name", NAMES)
def test_folded_template_decoder_matches_fast_decoder_f32(name):
    got, want = _fast_logits(name, torch.float32)
    assert got.shape == (1, K, 16, 128)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


# the share of bf16 logits bit-identical to JAX's, as measured (held at
# the measurement rounded down). template0 rounds at the same points as
# JAX: 100 %. Elsewhere a resize that JAX runs as an einsum, a dense 3x3
# or dilated conv, or a sum the port's resize kernel adds in f32 before
# rounding (JAX adds it to the rounded einsum in bf16:
# tests/test_torch_fast_decoder.py) rounds an element the other way,
# which then spreads through the blocks after it. Both stay as close to
# the f32 logits: worst error 0.60-0.82 % of their largest value for both
# (measured), held <= 1.5 %.
BF16_SHARE = {"template0": 1.0, "TEMPLATE_G": 0.99, "forms0": 0.95,
              "forms1": 0.73, "forms2": 0.999, "controller0": 0.64,
              "controller1": 0.997, "controller2": 0.999}


@pytest.mark.parametrize("name", sorted(BF16_SHARE))
def test_folded_template_decoder_bf16(name):
    got, want = _fast_logits(name, torch.bfloat16)
    want32 = _fast_logits(name, torch.float32)[1]
    wb = want.to(torch.bfloat16)
    rate = (got.view(torch.int16) == wb.view(torch.int16)).float().mean()
    assert rate.item() >= BF16_SHARE[name], rate.item()
    err = (got.float() - want32).abs().max() / want32.abs().max()
    assert err.item() <= 1.5e-2, err.item()


def test_fold_template_decoder_layout_and_dtypes():
    *_, model = _setup("forms1", 5)
    dec = fold_decoder(model.decoder, torch.bfloat16)
    assert isinstance(dec, FoldedTemplateDecoder)
    assert dec.aggs == ["cat", "psum", "cat", "psum"]
    assert dec.collect == [5, 7]
    assert sorted(dec.blocks[0].keys()) == ["op", "reduce"]
    assert sorted(dec.blocks[1].keys()) == ["b1", "b2", "op"]
    assert [b["op"].kind for b in dec.blocks] == ["gap", "conv", "conv",
                                                  "sep"]
    assert dec.adapt[0].w.dtype == torch.bfloat16
    assert dec.blocks[0]["reduce"].w.shape == (48, 96, 1, 1)
    assert dec.blocks[0]["op"].w.dtype == torch.float32    # pool 1x1 in f32
    assert dec.clf_w.shape == (K, 96, 1, 1) and dec.clf_b.dtype == \
        torch.float32
    with pytest.raises(ValueError, match="f32"):
        fold_decoder(model.decoder.to(torch.bfloat16), torch.bfloat16)
    with pytest.raises(TypeError, match="TemplateDecoder"):
        fold_decoder(torch.nn.Identity())


def _jax_masks(genotype, p, s, imgs, dtype):
    fn = jax.jit(build_infer_fn(genotype, num_classes=K,
                                input_hw=imgs.shape[1:3],
                                compute_dtype=dtype, use_pallas=False))
    return np.asarray(fn(p, s, jnp.asarray(imgs)))


def test_template_masks_match_jax_engine_f32():
    genotype, p, s, model = _setup("template0", SEEDS["template0"])
    imgs = _imgs((2, 64, 128, 3), 0)
    want = _jax_masks(genotype, p, s, imgs, jnp.float32)
    seg = Segmenter(model, compute_dtype=torch.float32, device="cpu")
    assert isinstance(seg.decoder, FoldedTemplateDecoder)
    got = seg.predict_batch(imgs)
    assert got.shape == (2, 64, 128) and got.dtype == np.uint8
    _several_classes(want)
    rate = (got == want).mean()
    assert rate >= 0.999, f"f32 mask agreement {rate}"


def test_template_masks_match_jax_engine_bf16():
    """bf16 masks of template0 at 2x64x128 against JAX's reference engine
    (``use_pallas=False``): measured 98.52 %, under arch0's 99 %, because
    JAX's reference rounds bf16 at other points than its own Pallas
    engine does (per-conv BatchNorm, the pool's 1x1 on a bf16 mean, an
    f32 tail), and this small decoder's random-weight logits nearly tie
    more often: that run agrees with the f32 masks on 97.77 % of pixels,
    the port's bf16 run on 98.78 %. So the port is held (1) to the
    reference at 98 %, (2) to agree with the f32 masks at least as well
    as the reference's bf16 run does, and (3) to JAX's Pallas engine
    (``use_pallas=True`` in interpret mode, the path the port mirrors)
    at arch0's 99 % (measured 99.44 %)."""
    genotype, p, s, model = _setup("template0", SEEDS["template0"])
    imgs = _imgs((2, 64, 128, 3), 0)
    want = _jax_masks(genotype, p, s, imgs, jnp.bfloat16)
    want32 = _jax_masks(genotype, p, s, imgs, jnp.float32)
    got = Segmenter(model, device="cpu").predict_batch(imgs)
    got32 = Segmenter(model, compute_dtype=torch.float32,
                      device="cpu").predict_batch(imgs)
    _several_classes(want)
    rate = (got == want).mean()
    assert rate >= 0.98, f"bf16 mask agreement with the reference {rate}"
    assert (got == got32).mean() >= (want == want32).mean()
    pallas = jax.jit(build_infer_fn(
        genotype, num_classes=K, input_hw=imgs.shape[1:3],
        compute_dtype=jnp.bfloat16, use_pallas=True, pallas_interpret=True))
    rate = (got == np.asarray(pallas(p, s, jnp.asarray(imgs)))).mean()
    assert rate >= 0.99, f"bf16 mask agreement with the Pallas engine {rate}"


def test_template_return_logits_match_jax_engine():
    genotype, p, s, model = _setup("forms2", 6)
    imgs = _imgs((1, 64, 96, 3), 2)
    fn = jax.jit(build_infer_fn(genotype, num_classes=K, input_hw=(64, 96),
                                compute_dtype=jnp.float32, return_logits=True,
                                use_pallas=False))
    want = np.asarray(fn(p, s, jnp.asarray(imgs)))
    seg = Segmenter(model, compute_dtype=torch.float32, device="cpu")
    got = seg.predict(imgs, return_logits=True)
    np.testing.assert_allclose(np.transpose(got, (0, 2, 3, 1)), want,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,hw,n,dtype", [
    ("template0", (64, 64), 2, torch.bfloat16),
    ("template0", (64, 64), 2, torch.float32),
    ("template0", (128, 64), 4, torch.bfloat16),
    ("forms1", (64, 96), 2, torch.bfloat16)])
def test_space_masks_bit_equal(name, hw, n, dtype):
    *_, model = _setup(name, SEEDS[name])
    seg = Segmenter(model, compute_dtype=dtype, device="cpu")
    run = make_sharded_infer_fn(seg, make_mesh(1, n, devices=[CPU] * n),
                                mode="space")
    imgs = _imgs((2, *hw, 3), 1)
    got = run(imgs)
    assert got.shape == (2, *hw) and got.dtype == np.uint8
    _several_classes(got)
    sh = ShardedSegmenter(seg, [CPU] * n)
    assert isinstance(sh.decoder, ShardedTemplateDecoder)
    x = torch.from_numpy(imgs)
    rows = sh.decoder(sh.infer_shards(x, return_taps=True))
    assert len(rows) == n and rows[0].shape[2] == hw[0] // 4 // n
    with torch.inference_mode():
        want = seg.decoder(seg.encoder(normalize_s2d_front(x,
                                                           out_dtype=dtype)))
    assert torch.equal(torch.cat(rows, dim=2), want)
    # both take the H-first tail at these widths: the masks bit for bit
    np.testing.assert_array_equal(got, seg.predict_batch(imgs))
    np.testing.assert_array_equal(got, upsample_argmax_plain(want, hw).numpy())


def test_data_mode_template_bit_equal():
    *_, model = _setup("template0", SEEDS["template0"])
    seg = Segmenter(model, device="cpu")
    run = make_sharded_infer_fn(seg, make_mesh(2, 1, devices=[CPU] * 2),
                                mode="data")
    imgs = _imgs((2, 64, 96, 3), 3)
    got = run(imgs)
    _several_classes(got)
    np.testing.assert_array_equal(got, seg.predict_batch(imgs))


def test_space_masks_match_jax_sharded_pallas_engine():
    """template0 at 64x64 over 2 shards, f32, against the JAX package's
    sharded engine in interpret mode (gathered taps, the decoder whole),
    BatchNorm unperturbed as in tests/test_torch_parallel.py's
    counterpart: the JAX sharded encoder hands the end shards a halo row
    of zeros, exact only while the folded expand bias is zero."""
    genotype, p, s, model = _setup("template0", 5, perturb=False)
    hw = (64, 64)
    imgs = _imgs((1, *hw, 3), 6)
    run = make_sharded_pallas_infer_fn(
        genotype, jax_make_mesh(1, 2), num_classes=K, input_hw=hw,
        compute_dtype=jnp.float32, pallas_interpret=True)
    want = np.asarray(run(p, s, jnp.asarray(imgs)))
    seg = Segmenter(model, compute_dtype=torch.float32, device="cpu")
    got = ShardedSegmenter(seg, [CPU] * 2).predict(imgs)
    _several_classes(got)
    rate = (got == want).mean()
    assert rate >= 0.999, f"mask agreement {rate}"


def test_sharded_segmenter_takes_either_family_only():
    *_, model = _setup("template0", 5)
    seg = Segmenter(model, device="cpu")
    other = copy.copy(seg)
    other.decoder = torch.nn.Identity()
    with pytest.raises(TypeError, match="Identity"):
        ShardedSegmenter(other, [CPU] * 2)
