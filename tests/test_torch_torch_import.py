"""segtpu_torch.convert.torch_import vs the JAX package's converter
(segtpu/convert/torch_import.py), on the CPU.

State dicts are built here, as tests/test_convert.py builds them: a
segmenter's in the order of the JAX parameter tree (conv weight, bn
weight, bias, running mean and var, num_batches_tracked; a classifier's
weight and bias) with seeded values, and the tonylins MobileNet-v2
trunk's by name. The port's import must give, bit for bit, the weights
of JAX's import carried over by ``load_jax_params``.
"""

import numpy as np
import pytest
import torch
import jax

from segtpu.convert.torch_import import (
    load_mbv2_state_dict as jax_load_mbv2_state_dict,
    load_segmenter_checkpoint as jax_load_segmenter_checkpoint,
    match_by_shape_order as jax_match_by_shape_order)
from segtpu.models.segmenter import segmenter_init

from segtpu_torch.convert import (load_jax_params, load_mbv2_checkpoint,
                                  load_mbv2_state_dict,
                                  load_segmenter_checkpoint,
                                  match_by_shape_order)
from segtpu_torch.models import ARCHS, TEMPLATE_ARCHS, MobileNetV2
from segtpu_torch.models.segmenter import Segmenter as SegmenterNet

from test_convert import MBV2_TAP_IDX, build_torch_mbv2_trunk
from test_torch_layers import _np_tree

K = 5
GENOTYPES = {"arch0": ARCHS["arch0"], "template0": TEMPLATE_ARCHS["template0"]}


def _ordered_state_dict(genotype, seed):
    """A torch state dict whose tensors follow ``segmenter_init``'s tree
    in its insertion order, with seeded values (positive variances)."""
    params, stats = segmenter_init(jax.random.PRNGKey(0), genotype,
                                   num_classes=K)
    rng = np.random.default_rng(seed)
    sd = {}

    def put(key, shape, positive=False):
        v = rng.uniform(0.5, 1.5, shape) if positive else \
            rng.normal(0.0, 0.2, shape)
        sd[key] = torch.tensor(np.asarray(v, np.float32))

    def oihw(w):
        kh, kw, ci, co = w.shape
        return (co, ci, kh, kw)

    def walk(p, s, path):
        if isinstance(p, dict) and set(p) >= {"w", "scale", "bias"}:
            put(f"{path}.conv.weight", oihw(p["w"]))
            c = p["scale"].shape
            put(f"{path}.bn.weight", c)
            put(f"{path}.bn.bias", c)
            put(f"{path}.bn.running_mean", c)
            put(f"{path}.bn.running_var", c, positive=True)
            sd[f"{path}.bn.num_batches_tracked"] = torch.tensor(7)
        elif isinstance(p, dict) and set(p) == {"w", "b"}:
            put(f"{path}.weight", oihw(p["w"]))
            put(f"{path}.bias", p["b"].shape)
        elif isinstance(p, dict):
            for k in p:
                walk(p[k], s.get(k, {}) if isinstance(s, dict) else {},
                     f"{path}.{k}")
        else:
            for i, sub in enumerate(p):
                walk(sub, s[i] if i < len(s) else {}, f"{path}.{i}")

    walk(params, stats, "net")
    return sd


def _net(genotype, seed=1):
    return SegmenterNet(genotype, K,
                        generator=torch.Generator().manual_seed(seed))


def _assert_same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("name", sorted(GENOTYPES))
def test_order_import_equals_jax_converter(name):
    genotype = GENOTYPES[name]
    sd = _ordered_state_dict(genotype, 3)
    template = segmenter_init(jax.random.PRNGKey(1), genotype, num_classes=K)
    p, s = _np_tree(jax_match_by_shape_order(sd, template))
    want = load_jax_params(_net(genotype, 2), p, s)
    got = match_by_shape_order(sd, _net(genotype))
    _assert_same_weights(got, want)
    # every tensor of the stream landed somewhere: no weight kept its init
    assert torch.equal(got.decoder.clf.b, sd["net.decoder.clf.bias"])


@pytest.mark.parametrize("name", sorted(GENOTYPES))
def test_order_import_rejects_a_wrong_model_and_leftovers(name):
    genotype = GENOTYPES[name]
    other = GENOTYPES["template0" if name == "arch0" else "arch0"]
    sd = _ordered_state_dict(genotype, 4)
    with pytest.raises(ValueError, match="shape mismatch"):
        match_by_shape_order(sd, _net(other))
    extra = dict(sd)
    extra["net.extra.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match="unconsumed"):
        match_by_shape_order(extra, _net(genotype))
    short = dict(list(sd.items())[:-1])
    with pytest.raises(ValueError, match="exhausted"):
        match_by_shape_order(short, _net(genotype))
    # the shapes of a wrong number of classes
    with pytest.raises(ValueError, match="shape mismatch"):
        match_by_shape_order(sd, SegmenterNet(
            genotype, K + 1, generator=torch.Generator().manual_seed(0)))


@pytest.fixture(scope="module")
def trunk():
    torch.manual_seed(0)
    model = build_torch_mbv2_trunk().eval()
    with torch.no_grad():         # BatchNorm that is not the identity
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0.0, 0.1)
    sd = {f"features.{k}": v for k, v in model.state_dict().items()}
    return model, sd


def test_mbv2_by_name_gives_the_trunks_taps(trunk):
    model, sd = trunk
    enc = load_mbv2_state_dict(sd)
    assert isinstance(enc, MobileNetV2)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (1, 3, 64, 64), dtype=np.float32))
    with torch.no_grad():
        want = []
        y = x
        for i, m in enumerate(model):
            y = m(y)
            if i in MBV2_TAP_IDX:
                want.append(y)
        got = enc.eval()(x)
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-4)


def test_mbv2_by_name_equals_jax_converter(trunk):
    _, sd = trunk
    p, s = _np_tree(jax_load_mbv2_state_dict(sd))
    want = load_jax_params(MobileNetV2(generator=torch.Generator()
                                       .manual_seed(1)), p, s)
    enc = MobileNetV2(generator=torch.Generator().manual_seed(2))
    assert load_mbv2_state_dict(sd, enc) is enc
    _assert_same_weights(enc, want)
    bad = dict(sd)
    bad["features.0.0.weight"] = torch.zeros(64, 3, 3, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_mbv2_state_dict(bad)
    bad = dict(sd)
    del bad["features.5.conv.4.running_var"]
    with pytest.raises(KeyError):
        load_mbv2_state_dict(bad)


def test_mbv2_checkpoint_file(trunk, tmp_path):
    _, sd = trunk
    path = tmp_path / "mbv2.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)
    _assert_same_weights(load_mbv2_checkpoint(str(path)),
                         load_mbv2_state_dict(sd))


@pytest.mark.parametrize("name", sorted(GENOTYPES))
def test_segmenter_checkpoint_round_trip(name, tmp_path):
    genotype = GENOTYPES[name]
    sd = _ordered_state_dict(genotype, 5)
    path = tmp_path / f"{name}.ckpt"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)
    model = load_segmenter_checkpoint(str(path), genotype, K, device="cpu")
    assert isinstance(model, SegmenterNet) and not model.training
    assert model.decoder.clf.w.device.type == "cpu"
    p, s = _np_tree(jax_load_segmenter_checkpoint(str(path), genotype, K))
    _assert_same_weights(model, load_jax_params(_net(genotype), p, s))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):   # no fallback
            load_segmenter_checkpoint(str(path), genotype, K)
