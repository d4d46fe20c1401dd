"""segtpu_torch.data against segtpu.data on the CPU: byte for byte.

The same datasets and seeds go through both packages' loaders,
transforms, label maps and image readers; every batch, sample and
decoded image must be the JAX package's bytes (``assert_array_equal``
on equal dtypes and shapes), no tolerance:

* ``create_loaders`` and ``BatchLoader`` over a ``SyntheticDataset``:
  training with the ``shorter_side`` scale jitter, pad, crop and mirror,
  over two epochs; evaluation with its ragged tail (the last sample
  repeated with an all-ignore mask); uint8 transport;
* the transforms one by one, on uint8 and float images;
* ``SegmentationDataset`` over a ``.lst`` the test writes, of ``.npy``
  pairs and of PNGs, under every ``LABEL_MAPS`` entry;
* the native library (``native/segtpu_io.cc``, built by the test into its
  own directory): ``decode_image`` and the ``Prefetcher``'s order, and
  the readers' error when neither it nor PIL can be loaded.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import segtpu.data.datasets as jds
import segtpu.data.label_maps as jlm
import segtpu.data.native_io as jnio
import segtpu.data.transforms as jtr

import segtpu_torch.data.datasets as tds
import segtpu_torch.data.label_maps as tlm
import segtpu_torch.data.native_io as tnio
import segtpu_torch.data.transforms as ttr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(got, want):
    assert type(got) is type(want)
    if isinstance(got, dict):
        assert got.keys() == want.keys()
        for k in got:
            _same(got[k], want[k])
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _epochs(loader, n):
    return [list(loader) for _ in range(n)]


def test_synthetic_dataset_is_the_jax_packages():
    a = tds.SyntheticDataset(n=5, hw=(24, 40), num_classes=7, seed=3)
    b = jds.SyntheticDataset(n=5, hw=(24, 40), num_classes=7, seed=3)
    _same(a.images, b.images)
    _same(a.masks, b.masks)
    assert len(a) == len(b) == 5
    _same(a[4], b[4])


# (dataset hw, crop, shorter_side, normalise_on_host)
LOADERS = {
    "jitter": ((40, 56), (32, 32), 36, True),
    "pad": ((20, 28), (32, 32), None, True),
    "uint8": ((40, 56), (24, 32), 30, False),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_create_loaders_give_the_jax_batches(name):
    """Meta-train (augmented) and meta-val (padded, ragged tail) loaders
    over two epochs: the same split and the same bytes."""
    hw, crop, shorter, norm = LOADERS[name]
    a = tds.SyntheticDataset(n=11, hw=hw, num_classes=5, seed=1)
    b = jds.SyntheticDataset(n=11, hw=hw, num_classes=5, seed=1)
    kw = dict(batch_size=3, crop=crop, meta_train_prct=0.6,
              shorter_side=shorter, seed=9, normalise_on_host=norm)
    (tt, tv), (jt, jv) = tds.create_loaders(a, **kw), jds.create_loaders(b, **kw)
    assert tt.indices == jt.indices and tv.indices == jv.indices
    assert (len(tt), len(tv)) == (len(jt), len(jv)) == (2, 2)
    got, want = _epochs(tt, 2) + _epochs(tv, 2), _epochs(jt, 2) + _epochs(jv, 2)
    assert [len(e) for e in got] == [len(e) for e in want]
    for ge, we in zip(got, want):
        for g, w in zip(ge, we):
            _same(g, w)
    # the two training epochs differ (a new generator each), the eval
    # epochs do not; the eval tail's repeats are all-ignore
    assert not np.array_equal(got[0][0]["image"], got[1][0]["image"])
    _same(got[2][1], got[3][1])
    assert (got[2][1]["label"][2:] == 255).all()
    assert got[0][0]["image"].dtype == (np.float32 if norm else np.uint8)


def test_batch_loader_indices_and_drop_last():
    ds = tds.SyntheticDataset(n=7, hw=(16, 16), num_classes=3)
    jd = jds.SyntheticDataset(n=7, hw=(16, 16), num_classes=3)
    for train in (True, False):
        kw = dict(batch_size=2, crop=(16, 16), train=train, seed=4,
                  indices=[6, 0, 3, 5, 1])
        a, b = tds.BatchLoader(ds, **kw), jds.BatchLoader(jd, **kw)
        assert len(a) == len(b) == (2 if train else 3)
        for g, w in zip(list(a), list(b)):
            _same(g, w)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_transforms_match_jax(dtype):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (23, 37, 3)).astype(dtype)
    msk = rng.integers(0, 6, (23, 37)).astype(np.uint8)
    sample = {"image": img, "mask": msk}
    cases = [
        (ttr.Pad((30, 40)), jtr.Pad((30, 40))),
        (ttr.Pad((30, 40), img_val=(1, 2, 3), msk_val=7),
         jtr.Pad((30, 40), img_val=(1, 2, 3), msk_val=7)),
        (ttr.RandomCrop((16, 20)), jtr.RandomCrop((16, 20))),
        (ttr.RandomMirror(), jtr.RandomMirror()),
        (ttr.ResizeShorterScale(19), jtr.ResizeShorterScale(19)),
        (ttr.ResizeShorterScale(30, 0.9, 1.3),
         jtr.ResizeShorterScale(30, 0.9, 1.3)),
        (ttr.Normalise(), jtr.Normalise()),
        (ttr.Compose([ttr.ResizeShorterScale(25), ttr.Pad((40, 40)),
                      ttr.RandomCrop((32, 32)), ttr.RandomMirror(),
                      ttr.Normalise()]),
         jtr.Compose([jtr.ResizeShorterScale(25), jtr.Pad((40, 40)),
                      jtr.RandomCrop((32, 32)), jtr.RandomMirror(),
                      jtr.Normalise()])),
    ]
    for port, ref in cases:
        for seed in range(4):
            _same(port(sample, np.random.default_rng(seed)),
                  ref(sample, np.random.default_rng(seed)))
    for hw in ((11, 50), (46, 74), (23, 37)):
        _same(ttr._resize_img(img, hw), jtr._resize_img(img, hw))
        _same(ttr._resize_img(img[..., 0], hw), jtr._resize_img(img[..., 0], hw))
        _same(ttr._resize_nearest(msk, hw), jtr._resize_nearest(msk, hw))


def test_label_maps_match_jax():
    every = np.arange(256, dtype=np.uint8).reshape(16, 16)
    assert set(tlm.LABEL_MAPS) == set(jlm.LABEL_MAPS)
    for name in jlm.LABEL_MAPS:
        _same(tlm.LABEL_MAPS[name](every), jlm.LABEL_MAPS[name](every))
    _same(tlm._lut({3: 1, 200: 9}), jlm._lut({3: 1, 200: 9}))
    assert tlm.NUM_CLASSES == jlm.NUM_CLASSES
    assert tlm.CITYSCAPES_CLASSES == jlm.CITYSCAPES_CLASSES
    assert tlm.CAMVID_CLASSES == jlm.CAMVID_CLASSES


def _write_pairs(d, fmt):
    """Three image/mask pairs in ``fmt`` ('npy' or 'png') under ``d`` and a
    .lst naming them relative to ``d``; masks hold raw CityScapes ids."""
    rng = np.random.default_rng(5)
    lines = []
    for i, hw in enumerate([(20, 30), (33, 17), (24, 24)]):
        img = rng.integers(0, 256, (*hw, 3)).astype(np.uint8)
        msk = rng.integers(0, 40, hw).astype(np.uint8)
        msk[0, :3] = (255, 7, 26)
        ip, mp = f"img{i}.{fmt}", f"mask{i}.{fmt}"
        if fmt == "npy":
            np.save(os.path.join(d, ip), img)
            np.save(os.path.join(d, mp), msk)
        else:
            from PIL import Image
            Image.fromarray(img).save(os.path.join(d, ip))
            Image.fromarray(msk, mode="L").save(os.path.join(d, mp))
        lines.append(f"{ip} {mp}")
    lst = os.path.join(d, "train.lst")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n\n")
    return lst


@pytest.mark.parametrize("fmt", ["npy", "png"])
@pytest.mark.parametrize("label_map", ["cityscapes", "camvid", "voc", None])
def test_segmentation_dataset_matches_jax(tmp_path, fmt, label_map):
    if fmt == "png":
        pytest.importorskip("PIL")
    lst = _write_pairs(str(tmp_path), fmt)
    a = tds.SegmentationDataset(str(tmp_path), lst, label_map=label_map)
    b = jds.SegmentationDataset(str(tmp_path), lst, label_map=label_map)
    assert a.pairs == b.pairs and len(a) == 3
    for i in range(len(a)):
        _same(a[i], b[i])
    kw = dict(batch_size=2, crop=(32, 32), train=True, shorter_side=28,
              seed=2)
    for g, w in zip(tds.BatchLoader(a, **kw), jds.BatchLoader(b, **kw)):
        _same(g, w)


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """native/segtpu_io.cc built into the test's own directory, bound by
    both packages' native_io in place of native/libsegtpu_io.so."""
    out = str(tmp_path_factory.mktemp("native") / "libsegtpu_io.so")
    r = subprocess.run(
        ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-o", out,
         os.path.join(ROOT, "native", "segtpu_io.cc"), "-lpng", "-ljpeg",
         "-lpthread"], capture_output=True)
    if r.returncode != 0:
        pytest.skip(f"native build unavailable: {r.stderr.decode()[:200]}")
    return out


@pytest.fixture
def bound(native_lib, monkeypatch):
    for mod in (tnio, jnio):
        monkeypatch.setattr(mod, "_LIB_PATH", native_lib)
        monkeypatch.setattr(mod, "_lib", None)
    assert tnio.available() and jnio.available()


def test_native_decode_and_prefetch_match_jax(tmp_path, bound):
    from PIL import Image
    rng = np.random.default_rng(1)
    paths = []
    for i, hw in enumerate([(37, 53), (21, 96)]):
        p = str(tmp_path / f"rgb{i}.png")
        Image.fromarray(rng.integers(0, 256, (*hw, 3)).astype(np.uint8)).save(p)
        paths.append(p)
    p = str(tmp_path / "mask.png")
    Image.fromarray(rng.integers(0, 19, (40, 40)).astype(np.uint8),
                    mode="L").save(p)
    paths.append(p)
    for p in paths:
        _same(tnio.decode_image(p), jnio.decode_image(p))
        _same(tds._read_image(p), jds._read_image(p))
        _same(tds._read_mask(p), jds._read_mask(p))
    seq = paths * 3
    got = list(tnio.Prefetcher(seq, threads=3, lookahead=4))
    want = list(jnio.Prefetcher(seq, threads=3, lookahead=4))
    assert len(got) == len(want) == len(seq)
    for g, w, p in zip(got, want, seq):
        _same(g, w)
        _same(g, jnio.decode_image(p))


def test_readers_raise_without_native_and_pil(tmp_path, monkeypatch):
    """No library and no PIL: a PNG cannot be read, and the error names
    both; a .npy still reads."""
    monkeypatch.setattr(tnio, "_LIB_PATH", str(tmp_path / "absent.so"))
    monkeypatch.setattr(tnio, "_lib", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    png = str(tmp_path / "x.png")
    open(png, "wb").close()
    for read in (tds._read_image, tds._read_mask):
        with pytest.raises(RuntimeError, match="native IO library.*PIL"):
            read(png)
    with pytest.raises(RuntimeError, match="not built or not loadable"):
        tnio.decode_image(png)
    np.save(tmp_path / "x.npy", np.arange(6, dtype=np.uint8))
    _same(tds._read_image(str(tmp_path / "x.npy")), np.arange(6, dtype=np.uint8))
