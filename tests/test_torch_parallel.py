"""segtpu_torch.parallel: meshes, the H-sharded encoder, decoder and
engine, and batch fan-out, on the CPU with logical shards (a device
list that repeats the CPU, the counterpart of the JAX tests' virtual
CPU mesh).

Overlap-discard runs every kernel's plain version on true neighbour
rows, so what a shard computes has the bits of the unsharded rows:
encoder taps, and masks of a genotype without a global-average-pool
op, are held bit for bit against the unsharded port. A pool branch's
mean is summed per shard (one f32 reassociation), so arch0's masks are
held to >= 99.9 %. One test holds the port against the JAX package's
sharded Pallas engine in interpret mode.
"""

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from jax import shard_map
from jax.sharding import PartitionSpec as P

from segtpu.models.fast_decoder import (
    _shard_interp_bands as jax_shard_interp_bands,
    build_fast_decoder as jax_build_fast_decoder,
    decoder_shard_plan as jax_decoder_shard_plan)
from segtpu.models.fast_encoder import mbv2_chw_apply as jax_mbv2_chw_apply
from segtpu.models.segmenter import segmenter_init
from segtpu.parallel.mesh import (make_mesh as jax_make_mesh,
                                  make_sharded_pallas_infer_fn)

from segtpu_torch.convert import load_jax_params
from segtpu_torch.engine import Segmenter, ShardedSegmenter
from segtpu_torch.kernels.front import normalize_s2d_front
from segtpu_torch.kernels.resize_chw import (resize_chw, resize_chw_plain,
                                             shard_interp_bands)
from segtpu_torch.kernels.upsample_argmax import upsample_argmax_plain
from segtpu_torch.models import ARCHS, TEMPLATE_ARCHS, create_segmenter
from segtpu_torch.models.fast_decoder import (ShardedMicroDecoder,
                                              ShardedTemplateDecoder, _Entry,
                                              decoder_shard_plan)
from segtpu_torch.models.segmenter import Segmenter as SegmenterNet
from segtpu_torch.parallel import (DeviceMesh, gather_h, halo_exchange,
                                   make_mesh, make_sharded_infer_fn,
                                   sum_shards)

from test_torch_layers import _np_tree, perturb_bn

K = 5
CPU = torch.device("cpu")
# arch0 without its pool branch: halos up to 12 rows and no f32
# reassociation, so the blocks that compute whole are held bit for bit
NO_POOL = [[2, [0, 1, 3, 9], [2, 0, 5, 2], [1, 3, 8, 0]],
           [[3, 2], [4, 1], [5, 0]]]
GENOTYPES = dict(ARCHS, no_pool=NO_POOL)


# weight seeds whose random-weight masks hold several classes (most seeds
# give one class everywhere, which would make a mask comparison empty)
SEEDS = {"arch0": 1, "arch1": 1, "arch2": 2, "no_pool": 1}


def _jax_weights(genotype, seed, perturb=True):
    p, s = _np_tree(segmenter_init(jax.random.PRNGKey(seed), genotype,
                                   num_classes=K))
    return perturb_bn(p, s, np.random.default_rng(seed)) if perturb else (p, s)


def _port_model(genotype, p, s):
    model = SegmenterNet(genotype, K,
                         generator=torch.Generator().manual_seed(0))
    load_jax_params(model, p, s)
    return model.eval()


_MODELS = {}


def _model(name):
    """(genotype, JAX params, JAX stats, the port's model on them),
    BatchNorm perturbed from a numpy seed; built once per genotype."""
    if name not in _MODELS:
        genotype = GENOTYPES[name]
        p, s = _jax_weights(genotype, SEEDS[name])
        _MODELS[name] = (genotype, p, s, _port_model(genotype, p, s))
    return _MODELS[name]


def _several_classes(masks):
    """The comparison is not of one class against itself."""
    share = np.bincount(masks.ravel(), minlength=K) / masks.size
    assert np.sort(share)[-2] >= 0.01, f"one class everywhere: {share}"


def _imgs(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def test_make_mesh_shapes_and_errors():
    mesh = make_mesh(2, 2, devices=[CPU] * 4)
    assert isinstance(mesh, DeviceMesh)
    assert mesh.shape == {"data": 2, "space": 2} and mesh.size == 4
    assert mesh.devices == [CPU] * 4 and len(mesh.grid[1]) == 2
    assert make_mesh(3, devices=["cpu"] * 5).shape == {"data": 3, "space": 1}
    with pytest.raises(ValueError, match="need 16 devices, have 4"):
        make_mesh(16, 1, devices=[CPU] * 4)
    with pytest.raises(ValueError):
        make_mesh(0, 1, devices=[CPU])
    if not torch.cuda.is_available():
        # the default is every CUDA device: none here, and no fallback
        with pytest.raises(ValueError, match="have 0"):
            make_mesh(1, 1)


def test_collectives_on_lists_of_shards():
    x = torch.arange(2 * 3 * 8 * 2, dtype=torch.float32).reshape(2, 3, 8, 2)
    shards = list(x.chunk(4, dim=2))
    ext = halo_exchange(shards, 1, 2)
    padded = torch.nn.functional.pad(x, (0, 0, 1, 2))
    for s, e in enumerate(ext):
        assert e.is_contiguous()
        assert torch.equal(e, padded[:, :, 2 * s:2 * s + 5])
    bare = halo_exchange(shards, 1, 2, ends=False)
    assert torch.equal(bare[0], x[:, :, 0:4]) and bare[0].shape[2] == 4
    assert torch.equal(bare[3], x[:, :, 5:8])
    assert torch.equal(bare[1], ext[1])
    assert halo_exchange(shards, 0, 0)[2] is shards[2]
    with pytest.raises(ValueError, match="reaches past"):
        halo_exchange(shards, 3, 0)
    full = gather_h(shards)
    assert len(full) == 4 and all(torch.equal(f, x) for f in full)
    assert full[0] is full[3]                     # one per distinct device
    parts = [torch.full((2, 3), float(10 ** -s)) for s in range(4)]
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert all(torch.equal(t, want) for t in sum_shards(parts))


@pytest.mark.parametrize("arch", ["arch0", "arch1", "arch2"])
@pytest.mark.parametrize("hw,n", [((256, 512), 4), ((1024, 2048), 8),
                                  ((64, 512), 2)])
def test_decoder_shard_plan_matches_jax(arch, hw, n):
    assert decoder_shard_plan(ARCHS[arch], hw, n) == \
        jax_decoder_shard_plan(ARCHS[arch], hw, n)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("h_in,h_out,n", [(8, 16, 2), (16, 64, 4),
                                          (4, 32, 4), (32, 32, 2),
                                          (12, 30, 3)])
def test_shard_interp_bands_match_jax(h_in, h_out, n, align_corners):
    got, hu, hd = shard_interp_bands(h_in, h_out, n, align_corners)
    want, whu, whd = jax_shard_interp_bands(h_in, h_out, n, align_corners)
    assert (hu, hd) == (whu, whd)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["plain", "acc", "acc_chain"])
def test_row_window_resize_has_the_unsharded_rows(dtype, form):
    g = torch.Generator().manual_seed(4)
    n, h, oh, ow, c = 4, 8, 32, 20, 6
    x = torch.randn(2, c, h, 10, generator=g).to(dtype)
    acc = torch.randn(2, c, oh, ow, generator=g).to(dtype) \
        if form == "acc" else None
    raw = torch.randn(2, 3, oh, ow, generator=g).to(dtype)
    stages = [(torch.randn(4, 3, 1, 1, generator=g).to(dtype),
               torch.randn(4, generator=g)),
              (torch.randn(c, 4, 1, 1, generator=g).to(dtype),
               torch.randn(c, generator=g))]
    for ac in (True, False):
        want = resize_chw_plain(x, (oh, ow), acc,
                                (raw, stages) if form == "acc_chain" else None,
                                align_corners=ac)
        _, hu, hd = shard_interp_bands(h, oh, n, ac)
        ext = halo_exchange(list(x.chunk(n, dim=2)), hu, hd)
        lr = oh // n
        for s, e in enumerate(ext):
            rows = slice(s * lr, (s + 1) * lr)
            got = resize_chw(
                e, (oh, ow), None if acc is None else acc[:, :, rows],
                (raw[:, :, rows].contiguous(), stages)
                if form == "acc_chain" else None,
                align_corners=ac, shard=(s, n, h))
            assert torch.equal(got, want[:, :, rows]), (ac, s)
    with pytest.raises(ValueError, match="window"):
        resize_chw(x, (oh, ow), shard=(0, n, h))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_encoder_taps_are_bit_equal(dtype):
    *_, model = _model("arch2")
    seg = Segmenter(model, compute_dtype=dtype, device="cpu")
    imgs = torch.from_numpy(_imgs((2, 64, 64, 3), 0))
    want = seg.encoder(normalize_s2d_front(imgs, out_dtype=dtype))
    sh = ShardedSegmenter(seg, [CPU] * 2)
    got = sh.infer_shards(imgs, return_taps=True)
    assert len(got) == 4
    for tap, ref in zip(got, want):
        assert len(tap) == 2 and tap[0].shape[2] * 2 == ref.shape[2]
        assert torch.equal(torch.cat(tap, dim=2), ref)


@pytest.mark.parametrize("arch,hw,n,dtype", [
    ("arch2", (64, 64), 2, torch.bfloat16),
    ("arch2", (64, 64), 2, torch.float32),
    ("arch2", (64, 512), 2, torch.bfloat16),
    ("arch2", (128, 64), 4, torch.bfloat16),
    ("no_pool", (128, 256), 2, torch.bfloat16),
])
def test_space_masks_bit_equal_without_a_pool_branch(arch, hw, n, dtype):
    genotype, _, _, model = _model(arch)
    plan = decoder_shard_plan(genotype, hw, n)
    if arch == "no_pool":     # blocks 1 and 2 compute whole, block 3 shards
        assert [b["sharded"] for b in plan["blocks"]] == [False, False, True]
    else:
        assert all(b["sharded"] for b in plan["blocks"])
    seg = Segmenter(model, compute_dtype=dtype, device="cpu")
    run = make_sharded_infer_fn(seg, make_mesh(1, n, devices=[CPU] * n),
                                mode="space")
    imgs = _imgs((2, *hw, 3), 1)
    got = run(imgs)
    assert got.shape == (2, *hw) and got.dtype == np.uint8
    _several_classes(got)
    # the logits under the masks, bit for bit, and their H-first tail
    sh = ShardedSegmenter(seg, [CPU] * n)
    x = torch.from_numpy(imgs)
    logits = torch.cat(sh.decoder(sh.infer_shards(x, return_taps=True)), dim=2)
    with torch.inference_mode():
        want = seg.decoder(seg.encoder(normalize_s2d_front(x, out_dtype=dtype)))
    assert torch.equal(logits, want)
    np.testing.assert_array_equal(got, upsample_argmax_plain(want, hw).numpy())
    if hw[1] == 512:
        # the unsharded engine's own choice there is the W-first tail,
        # which rounds other operands to bf16 than the H-first tail does
        # (its W weights; the H-first tail its H weights and H-pass
        # result): near-ties move (measured 99.86 %)
        rate = (got == seg.predict_batch(imgs)).mean()
        assert rate >= 0.995, f"vs the W-first tail: {rate}"
    else:
        np.testing.assert_array_equal(got, seg.predict_batch(imgs))
    one = run(torch.from_numpy(imgs[0]))           # a frame, as a tensor
    assert isinstance(one, torch.Tensor)
    np.testing.assert_array_equal(one.numpy(), got[0])


def test_space_masks_arch0_pool_branch():
    """arch0 at 128x256 over 2 shards: blocks 1 and 2 compute whole (16
    rows a shard at most, under the 12-row halo of sep_conv_5x5_dil6 only
    for block 3), block 3 shards, and its pool branch sums per shard."""
    genotype, _, _, model = _model("arch0")
    plan = decoder_shard_plan(genotype, (128, 256), 2)
    assert [b["sharded"] for b in plan["blocks"]] == [False, False, True]
    seg = Segmenter(model, device="cpu")
    sh = ShardedSegmenter(seg, [CPU] * 2)
    imgs = _imgs((2, 128, 256, 3), 2)
    got = sh.predict(imgs)
    _several_classes(got)
    rate = (got == seg.predict_batch(imgs)).mean()
    assert rate >= 0.999, f"arch0 space-sharded mask agreement {rate}"
    x = torch.from_numpy(imgs)
    logits = torch.cat(sh.decoder(sh.infer_shards(x, return_taps=True)), dim=2)
    with torch.inference_mode():
        want = seg.decoder(seg.encoder(normalize_s2d_front(x)))
    # bf16 logits: the re-associated mean moves some by a rounding step
    err = (logits.float() - want.float()).abs().max().item()
    assert err <= 2 ** -7 * want.float().abs().max().item(), err


def test_whole_map_resize_fallback_keeps_the_rows():
    """A map whose rows do not divide among the shards is resized whole
    on each device and sliced, with the adds kept in the kernel."""
    *_, model = _model("arch2")
    seg = Segmenter(model, compute_dtype=torch.float32, device="cpu")
    dec = ShardedMicroDecoder([seg.decoder] * 4, align_corners=True,
                              use_kernels=True)
    g = torch.Generator().manual_seed(9)
    x = torch.randn(1, 3, 2, 5, generator=g)
    acc = torch.randn(1, 3, 8, 10, generator=g)
    want = resize_chw_plain(x, (8, 10), acc)
    got = dec._resize_any(_Entry([x] * 4, False), (8, 10), True,
                          acc=list(acc.chunk(4, dim=2)))
    assert got.local and torch.equal(torch.cat(got.ts, dim=2), want)


def test_data_mode_is_bit_equal_and_checks_the_batch():
    *_, model = _model("arch2")
    seg = Segmenter(model, device="cpu")
    run = make_sharded_infer_fn(seg, make_mesh(2, 2, devices=[CPU] * 4),
                                mode="data")
    imgs = _imgs((4, 64, 96, 3), 3)
    got = run(imgs)
    assert got.shape == (4, 64, 96) and got.dtype == np.uint8
    _several_classes(got)
    np.testing.assert_array_equal(got, seg.predict_batch(imgs))
    out = run(torch.from_numpy(imgs))
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), got)
    with pytest.raises(ValueError, match="must divide mesh size 4"):
        run(imgs[:3])
    with pytest.raises(ValueError, match="unknown mode"):
        make_sharded_infer_fn(seg, make_mesh(1, 1, devices=[CPU]), mode="x")


def test_space_mode_shape_and_family_errors():
    *_, model = _model("arch2")
    seg = Segmenter(model, device="cpu")
    sh = ShardedSegmenter(seg, [CPU] * 2)
    with pytest.raises(ValueError, match="stride-32-multiple"):
        sh.predict(_imgs((1, 70, 64, 3), 0))
    with pytest.raises(ValueError, match=r"must divide 2\*n_shards=6"):
        ShardedSegmenter(seg, [CPU] * 3).predict(_imgs((1, 64, 64, 3), 0))
    with pytest.raises(ValueError, match="takes a"):   # the batch is not split
        make_sharded_infer_fn(seg, make_mesh(2, 2, devices=[CPU] * 4),
                              mode="space")
    # a decoder of either family is taken; any other raises
    tseg = Segmenter(create_segmenter(
        TEMPLATE_ARCHS["template0"], K,
        generator=torch.Generator().manual_seed(0), device="cpu"),
        device="cpu")
    assert isinstance(ShardedSegmenter(tseg, [CPU] * 2).decoder,
                      ShardedTemplateDecoder)
    other = copy.copy(seg)
    other.decoder = torch.nn.Identity()
    with pytest.raises(TypeError, match="Identity"):
        ShardedSegmenter(other, [CPU] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):   # no fallback
            ShardedSegmenter(seg, ["cuda:0"] * 2)


def test_space_masks_match_jax_sharded_pallas_engine():
    """The port's sharded engine against the JAX package's
    (``make_sharded_pallas_infer_fn`` in interpret mode on the virtual
    CPU mesh): arch2, 64x64, 2 shards, f32, the same weights and frame.
    Both run f32 sums in their own order, so near-ties may flip: >= 99.9 %
    of the pixels must agree (measured: 100 %, on a mask of four classes).

    BatchNorm keeps its initial statistics here, unlike in the other
    tests: the JAX sharded encoder hands the shards at the ends of the
    mesh a halo row of zeros, which is the inverted residual's padding
    only while the folded expand bias is zero (the block pads its
    expanded tensor, and a zero input row expands to relu6(bias)). With
    perturbed BatchNorm its sharded taps are no longer its unsharded
    ones (``test_jax_sharded_encoder_end_halo``); the port gives the end
    shards no halo and stays bit-equal to its unsharded run either way.
    The sharded decoder's folded biases are held against JAX's in
    ``test_sharded_decoder_matches_jax_sharded_decoder``."""
    genotype = GENOTYPES["arch2"]
    p, s = _jax_weights(genotype, 2, perturb=False)
    hw = (64, 64)
    imgs = _imgs((1, *hw, 3), 6)
    run = make_sharded_pallas_infer_fn(
        genotype, jax_make_mesh(1, 2), num_classes=K, input_hw=hw,
        compute_dtype=jnp.float32, pallas_interpret=True)
    want = np.asarray(run(p, s, jnp.asarray(imgs)))
    seg = Segmenter(_port_model(genotype, p, s), compute_dtype=torch.float32,
                    device="cpu")
    got = ShardedSegmenter(seg, [CPU] * 2).predict(imgs)
    _several_classes(got)
    rate = (got == want).mean()
    assert rate >= 0.999, f"mask agreement {rate}"


def _space_map(fn, n_in, n):
    """``fn`` under shard_map on the virtual CPU mesh: every argument
    and the result channel-first, H-sharded over 'space'."""
    spec = P(None, None, "space", None)
    return jax.jit(shard_map(fn, mesh=jax_make_mesh(1, n),
                             in_specs=([spec] * n_in,), out_specs=spec,
                             check_vma=False))


@pytest.mark.parametrize("arch,hw,n,plan", [
    ("arch0", (128, 256), 2, [False, False, True]),
    ("arch2", (64, 64), 2, [True, True, True]),
])
def test_sharded_decoder_matches_jax_sharded_decoder(arch, hw, n, plan):
    """The H-sharded decoder alone against JAX's
    ``build_fast_decoder(spatial=...)`` in interpret mode, f32, with
    perturbed BatchNorm, so the folded biases count in every extended
    ``acc``, in the pool branch's vector and in the blocks computed
    whole. Both take the taps of the port's unsharded encoder, cut along
    H: the decoder's halos at the ends of the mesh are the convs' own
    zero padding, so JAX's zero rows are exact there. Logits agree to
    rtol = atol = 1e-4, the unsharded decoders' tolerance
    (test_torch_fast_decoder.py)."""
    genotype, p, s, model = _model(arch)
    assert [b["sharded"] for b in
            decoder_shard_plan(genotype, hw, n)["blocks"]] == plan
    seg = Segmenter(model, compute_dtype=torch.float32, device="cpu")
    x = torch.from_numpy(_imgs((1, *hw, 3), 7))
    with torch.inference_mode():
        taps = seg.encoder(normalize_s2d_front(x, out_dtype=torch.float32))
        dec = ShardedMicroDecoder([seg.decoder] * n, align_corners=True,
                                  use_kernels=True)
        got = torch.cat(dec([list(t.chunk(n, dim=2)) for t in taps]), dim=2)
        whole = seg.decoder(taps)
    jdec = jax_build_fast_decoder(genotype, p["decoder"], s["decoder"],
                                  taps_channel_first=True,
                                  spatial=("space", n), interpret=True)
    want = np.asarray(_space_map(jdec, len(taps), n)(
        [jnp.asarray(t.numpy()) for t in taps]))
    assert got.shape == want.shape == (1, K, hw[0] // 4, hw[1] // 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert np.abs(want).max() > 0.1           # not a comparison of zeros


@pytest.mark.parametrize("perturb", [False, True])
def test_jax_sharded_encoder_end_halo(perturb):
    """Why the end-to-end comparison runs with initial BatchNorm: JAX's
    sharded encoder gives the shards at the ends of the mesh a halo row
    of zeros, and the inverted residual expands it to relu6(folded
    bias), not to the zero padding of its expanded tensor. With initial
    BatchNorm the bias is zero and JAX's sharded taps are its unsharded
    ones; with perturbed BatchNorm they differ, and only in the
    neighbourhood of the image's first and last rows. The port's sharded
    taps are bit-equal to its unsharded ones either way
    (``test_sharded_encoder_taps_are_bit_equal`` runs perturbed)."""
    genotype = GENOTYPES["arch2"]
    p, s = _jax_weights(genotype, 2, perturb=perturb)
    x12 = jnp.asarray(normalize_s2d_front(
        torch.from_numpy(_imgs((1, 64, 64, 3), 0)),
        out_dtype=torch.float32).numpy())
    want = jax_mbv2_chw_apply(p["encoder"], s["encoder"], x12, interpret=True)
    spec = P(None, None, "space", None)
    got = jax.jit(shard_map(
        lambda x: jax_mbv2_chw_apply(p["encoder"], s["encoder"], x,
                                     interpret=True, spatial_axis="space"),
        mesh=jax_make_mesh(1, 2), in_specs=spec, out_specs=[spec] * 4,
        check_vma=False))(x12)
    err = np.abs(np.asarray(got[0]) - np.asarray(want[0]))   # stride-4 tap
    if not perturb:
        assert err.max() <= 1e-5, err.max()
        return
    rows = err.max(axis=(0, 1, 3))
    assert rows[0] > 1e-3 and rows[-1] > 1e-3, rows
    assert rows[5:-5].max() <= 1e-5, rows
