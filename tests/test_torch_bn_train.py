"""Train-mode BatchNorm and its activation (``kernels/bn_train.py``,
``csrc/bn_train.cu``): the plain backward formula against autograd of
the written-out ``bn_train`` and activation, ``bn_act_train``'s plain
route against today's composition bit for bit, the route rule and the
route counter.

    python -m pytest tests/test_torch_bn_train.py -q

Tests marked ``card`` need a CUDA card and skip without one; on the card:
``python -m pytest tests/test_torch_bn_train.py -q -m card``. They hold
the kernels to their plain twins at arch0's BatchNorm shapes, count the
routes of a train step and of a vmapped population step, and replay a
CUDA graph of the forward.
"""

import copy

import numpy as np
import pytest
import torch

from segtpu_torch import supernet as sn
from segtpu_torch.core import bands, layers
from segtpu_torch.engine.trainer import init_train_state, make_train_step
from segtpu_torch.kernels import bn_train as bnk
from segtpu_torch.models import ARCHS, create_segmenter
from segtpu_torch.models.encoders import MBV2_TAP_CHANNELS
from segtpu_torch.rl import controller as ctrl
from segtpu_torch.utils.solvers import PopulationSGD, create_optimisers

K = 19
ACTS = ("none", "relu", "relu6")
# arch0 with aux heads: BatchNorms a train step, and their shapes at
# 512x512 (N = 1; the card tests take b8)
ARCH0_BNS = 94
ARCH0_SHAPES_512 = (
    (16, 256, 256), (24, 128, 128), (32, 64, 64), (32, 256, 256),
    (48, 1, 1), (48, 16, 16), (48, 32, 32), (48, 64, 64), (48, 128, 128),
    (64, 32, 32), (96, 32, 32), (96, 128, 128), (96, 256, 256),
    (144, 64, 64), (144, 128, 128), (160, 16, 16), (192, 32, 32),
    (192, 64, 64), (320, 16, 16), (384, 32, 32), (576, 16, 16),
    (576, 32, 32), (960, 16, 16))


def _params(c, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    scale = (1 + 0.5 * torch.randn(c, generator=g)).to(dtype)
    bias = (0.5 * torch.randn(c, generator=g)).to(dtype)
    mean = (0.1 * torch.randn(c, generator=g)).to(dtype)
    var = (1 + torch.rand(c, generator=g)).to(dtype)
    return scale, bias, mean, var


def _case(kind, dtype):
    """(y, dy, scale, bias) of a backward case: ``hw1`` H*W = 1, ``ragged``
    5x7, ``vec`` 8x8 (whole 16-byte vectors), ``offset`` mean^2 >> var,
    ``bounds`` z exactly 0 (bias 0) and 6 (bias 6) wherever y is 0."""
    g = torch.Generator().manual_seed(3)
    shape = {"hw1": (16, 6, 1, 1), "ragged": (3, 5, 5, 7),
             "vec": (2, 4, 8, 8), "offset": (2, 4, 8, 8),
             "bounds": (3, 4, 4, 6)}[kind]
    y = torch.randn(shape, generator=g, dtype=torch.float64)
    scale, bias, _, _ = _params(shape[1], torch.float64)
    if kind == "offset":
        y = 100.0 + y
    if kind == "bounds":
        # each channel holds -1, 0 and 1 equally often: its mean is 0 and
        # z = bias exactly where y is 0
        n, c, h, w = shape
        per = n * h * w
        base = torch.tensor([-1.0, 0.0, 1.0], dtype=torch.float64)
        y = torch.stack([base.repeat(per // 3)[torch.randperm(per,
                                                              generator=g)]
                         for _ in range(c)])
        y = y.reshape(c, n, h, w).permute(1, 0, 2, 3).contiguous()
        scale = torch.ones(shape[1], dtype=torch.float64)
        bias = torch.tensor([0.0, 6.0, 0.0, 6.0], dtype=torch.float64)
    dy = torch.randn(shape, generator=g, dtype=torch.float64)
    return y.to(dtype), dy.to(dtype), scale.to(dtype), bias.to(dtype)


def _written_out(y, scale, bias, act):
    """Autograd's reference: ``bn_train`` and the activation as the port
    writes them, in f32; in f64 the same sequence of ops in f64 (bn_train
    itself computes in f32)."""
    mean = torch.zeros(y.shape[1], dtype=y.dtype)
    var = torch.ones(y.shape[1], dtype=y.dtype)
    if y.dtype == torch.float32:
        return layers.ACTIVATIONS[act](layers.bn_train(y, scale, bias,
                                                       mean, var))
    batch_mean = y.mean((0, 2, 3))
    batch_var = (y - batch_mean[:, None, None]).square().mean((0, 2, 3))
    inv = torch.rsqrt(batch_var + layers.BN_EPS) * scale
    shift = bias - batch_mean * inv
    return layers.ACTIVATIONS[act](y * inv[:, None, None]
                                   + shift[:, None, None])


# The formula and autograd differ in the order and form of their sums
# only: autograd's dscale is sum(g y) - mean sum(g), times invstd, which
# cancels where mean^2 >> var; the formula's is sum(g x_hat). Each
# gradient within TOL[dtype] of its largest |.|; f32's 3e-4 leaves the
# offset case (|mean| / std = 100: ~100 eps of cancellation) room.
TOL = {torch.float64: 1e-10, torch.float32: 3e-4}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("kind", ["hw1", "ragged", "vec", "offset",
                                  "bounds"])
def test_backward_formula_matches_autograd(kind, act, dtype):
    y, dy, scale, bias = _case(kind, dtype)
    ya, sa, ba = (t.clone().requires_grad_() for t in (y, scale, bias))
    out = _written_out(ya, sa, ba, act)
    want = torch.autograd.grad(out, (ya, sa, ba), dy)
    batch_mean, invstd = bnk.batch_stats_plain(y)
    got = bnk.bn_act_backward_plain(dy, y, batch_mean, invstd, scale, bias,
                                    act)
    for name, a, b in zip(("dx", "dscale", "dbias"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        err = (a - b).abs().max().item()
        assert err <= TOL[dtype] * max(b.abs().max().item(), 1e-30), \
            (name, err)
    if kind == "bounds" and act != "none":
        # the mask passes the gradient at z = 0 (and at z = 6 for relu6):
        # a gradient that stopped there would move dbias by sum(dy) there
        z = out.detach()
        at_bound = (y == 0)
        assert bool((z[at_bound] == bias[None, :, None, None]
                     .expand_as(y)[at_bound]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ACTS)
def test_plain_route_is_the_composition_bit_for_bit(act, dtype):
    g = torch.Generator().manual_seed(1)
    y = torch.randn(4, 6, 5, 7, generator=g).to(dtype)
    dy = torch.randn(4, 6, 5, 7, generator=g).to(dtype)
    params = _params(6)
    runs = []
    for fn in (lambda *a: bnk.bn_act_train(*a, act),
               lambda y, s, b, m, v: layers.ACTIVATIONS[act](
                   layers.bn_train(y, s, b, m, v))):
        ya = y.clone().requires_grad_()
        scale, bias = (t.clone().requires_grad_() for t in params[:2])
        mean, var = (t.clone() for t in params[2:])
        before = dict(layers.BN_TRAIN_ROUTES)
        out = fn(ya, scale, bias, mean, var)
        grads = torch.autograd.grad(out, (ya, scale, bias), dy)
        runs.append((out, mean, var, *grads))
        runs[-1] += (dict(layers.BN_TRAIN_ROUTES), before)
    for got, want in zip(runs[0][:6], runs[1][:6]):
        assert got.dtype == want.dtype and torch.equal(got, want)
    after, before = runs[0][6:]
    assert after.get("plain", 0) == before.get("plain", 0) + 1
    assert after.get("kernel", 0) == before.get("kernel", 0)


def test_route_rule(monkeypatch):
    """Plain on the CPU; with the device taken as a card's, the kernel
    for a plain tensor and plain under ``torch.func.vmap`` and inside
    ``shard_context``."""
    y = torch.randn(2, 3, 4, 4)
    assert bnk.bn_route(y) == "plain"
    monkeypatch.setattr(bnk, "_on_card", lambda t: True)
    assert bnk.bn_route(y) == "kernel"
    seen = []
    torch.func.vmap(lambda t: seen.append(bnk.bn_route(t)) or t)(
        torch.randn(5, 2, 3, 4, 4))
    assert seen == ["plain"]
    with bands.shard_context(bands.ShardGroup(1), 0):
        assert bnk.bn_route(y) == "plain"
    assert bnk.bn_route(y) == "kernel"


def _arch0(device="cpu"):
    return create_segmenter(ARCHS["arch0"], K, aux=True, device=device,
                            generator=torch.Generator().manual_seed(0))


def _train_batch(n=2, hw=64):
    rng = np.random.default_rng(0)
    return {"image": rng.standard_normal((n, hw, hw, 3), np.float32),
            "label": rng.integers(0, K, (n, hw, hw))}


def _step_routes(device):
    """BN_TRAIN_ROUTES' and bn_act_train.launches' moves over one arch0
    train step with aux heads on ``device``."""
    opt = create_optimisers()
    state = init_train_state(_arch0(device), opt, do_polyak=True)
    step = make_train_step(ARCHS["arch0"], opt, num_classes=K)
    before = dict(layers.BN_TRAIN_ROUTES)
    launches = bnk.bn_act_train.launches
    state, loss = step(state, _train_batch())
    if device != "cpu":
        torch.cuda.synchronize()
    moved = {k: layers.BN_TRAIN_ROUTES[k] - before.get(k, 0)
             for k in ("kernel", "plain")}
    return moved, bnk.bn_act_train.launches - launches, loss


def test_arch0_step_counts_94_plain_on_cpu():
    moved, launches, loss = _step_routes("cpu")
    assert moved == {"kernel": 0, "plain": ARCH0_BNS}
    assert launches == 0 and torch.isfinite(loss)


def test_arch0_shapes():
    """The BatchNorm shapes the card tests take: arch0's 23 at 512x512."""
    model = _arch0().train()
    shapes = []
    real = bnk.bn_act_train

    def spy(y, *rest):
        shapes.append(tuple(y.shape[1:]))
        return real(y, *rest)

    bnk.bn_act_train = spy
    try:
        with torch.no_grad():
            model(torch.zeros(1, 3, 512, 512), with_aux=True)
    finally:
        bnk.bn_act_train = real
    assert len(shapes) == ARCH0_BNS
    assert tuple(sorted(set(shapes))) == ARCH0_SHAPES_512


def test_plan_covers_each_channel_without_empty_blocks():
    for n, (c, h, w) in [(8, s) for s in ARCH0_SHAPES_512] + [
            (64, (32, 256, 256)), (3, (5, 5, 7)), (1, (2, 1, 1))]:
        for itemsize in (4, 2):
            for aligned in (True, False):
                plan = bnk.bn_plan((n, c, h, w), itemsize, aligned)
                vec = 16 // itemsize
                want_vec = vec if aligned and (h * w) % vec == 0 else 1
                assert plan.vec == want_vec
                total = n * h * w // plan.vec
                assert 1 <= plan.blocks <= 65535
                assert plan.blocks * plan.chunk >= total
                assert (plan.blocks - 1) * plan.chunk < total


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


# Tolerances, by dtype (kernels against their twins on the same input):
# the kernels sum the moments and the gradient sums in another order
# than PyTorch's reductions, so in f32 the saved mean, invstd, running
# buffers and dscale/dbias agree to a few units in 1e-6 of their scale,
# and every elementwise output to 1e-4 of its largest |.| (SUM_TOL);
# in bf16 an output rounds from f32 values that differ that little, so
# it may land one bf16 unit (2^-7 of its magnitude at most) apart.
SUM_TOL = 1e-4
ULP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}


def _close(got, want, what, dtype=torch.float32):
    scale = max(want.abs().max().item(), 1e-30)
    err = (got.float() - want.float()).abs()
    bound = SUM_TOL * scale + ULP[dtype] * want.float().abs()
    worst = (err - bound).max().item()
    assert worst <= 0, (what, err.max().item(), scale)


def _kernel_and_twin(y, dy, act, seed=0):
    """Both routes on the same input and parameters: (kernel: out, mean,
    var, dx, dscale, dbias, saved mean, saved invstd), and the twin's
    forward (out, mean, var) and backward fed the kernel's saved
    statistics, so its mask sees the same z."""
    params = [t.to(y.device) for t in _params(y.shape[1], seed=seed)]
    ya = y.clone().requires_grad_()
    scale, bias = (t.clone().requires_grad_() for t in params[:2])
    mean, var = (t.clone() for t in params[2:])
    out = bnk._BnActTrain.apply(ya, scale, bias, mean, var, act)
    saved_mean, saved_invstd = out.grad_fn.saved_tensors[1:3]
    dx, dscale, dbias = torch.autograd.grad(out, (ya, scale, bias), dy)
    kernel = (out, mean, var, dx, dscale, dbias, saved_mean, saved_invstd)
    t_mean, t_var = (t.clone() for t in params[2:])
    t_out = bnk.bn_act_train_plain(y, params[0], params[1], t_mean, t_var,
                                   act)
    t_back = bnk.bn_act_backward_plain(dy, y, saved_mean, saved_invstd,
                                       params[0], params[1], act)
    return kernel, (t_out, t_mean, t_var) + t_back


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_twins_at_arch0_shapes(card, dtype):
    """arch0's 23 BatchNorm shapes at b8 512x512, a 1x1 and a ragged
    shape; each act in turn; every output, the running buffers, dx,
    dscale and dbias against the twins; a second run bit-equal."""
    g = torch.Generator(device=card).manual_seed(5)
    shapes = [(8,) + s for s in ARCH0_SHAPES_512] + [(3, 7, 1, 1),
                                                      (3, 5, 5, 7)]
    for i, shape in enumerate(shapes):
        act = ACTS[i % 3]
        y = (torch.randn(shape, generator=g, device=card) * 2 + 0.5).to(dtype)
        dy = torch.randn(shape, generator=g, device=card).to(dtype)
        kernel, twin = _kernel_and_twin(y, dy, act, seed=i)
        what = f"{shape} {act} {dtype}"
        assert kernel[0].dtype == dtype and kernel[3].dtype == dtype
        want_mean, want_invstd = bnk.batch_stats_plain(y)
        _close(kernel[6], want_mean, f"saved mean {what}")
        _close(kernel[7], want_invstd, f"saved invstd {what}")
        for j, name in enumerate(("out", "running mean", "running var",
                                  "dx", "dscale", "dbias")):
            elementwise = name in ("out", "dx")
            _close(kernel[j], twin[j], f"{name} {what}",
                   dtype if elementwise else torch.float32)
        again, _ = _kernel_and_twin(y, dy, act, seed=i)
        for a, b in zip(kernel, again):
            assert torch.equal(a, b), f"not deterministic: {what}"


@pytest.mark.card
def test_kernels_raise_on_what_they_do_not_take(card):
    scale, bias, mean, var = (t.to(card) for t in _params(4))
    y = torch.randn(2, 4, 6, 6, device=card)
    with pytest.raises(ValueError):
        bnk.bn_act_train(y.half(), scale, bias, mean, var, "relu")
    with pytest.raises(ValueError):
        bnk.bn_act_train(y.transpose(2, 3), scale, bias, mean, var, "relu")


@pytest.mark.card
def test_arch0_step_on_card_takes_the_kernel(card):
    moved, launches, loss = _step_routes(card)
    assert moved == {"kernel": ARCH0_BNS, "plain": 0}
    assert launches == 4 * ARCH0_BNS and torch.isfinite(loss)


@pytest.mark.card
def test_vmapped_population_step_on_card_stays_plain(card):
    spec = sn.SupernetSpec(num_classes=4, agg_size=8)
    pop = sn.population_init(torch.Generator().manual_seed(0), spec,
                             MBV2_TAP_CHANNELS, 2, device=card)
    cspec = ctrl.MicroControllerSpec()
    cparams = ctrl.controller_init(torch.Generator().manual_seed(1), cspec)
    acts = torch.stack([ctrl.sample(cparams, cspec, torch.Generator()
                                    .manual_seed(i))[0] for i in range(2)])
    masks = {k: v.to(card) for k, v in
             sn.masks_from_actions(acts, spec).items()}
    rng = np.random.RandomState(0)
    batch = {"taps": [torch.from_numpy(rng.randn(2, c, 16 // s, 16 // s)
                                       .astype(np.float32)).to(card)
                      for s, c in zip((1, 2, 4, 8), MBV2_TAP_CHANNELS)],
             "label": torch.from_numpy(rng.randint(0, 4, (2, 64, 64)))
             .to(card)}
    step = sn.make_population_train_step(
        spec, PopulationSGD(0.05, momentum=0.9, wd=1e-4, clip=0.5))
    before = dict(layers.BN_TRAIN_ROUTES)
    _, losses = step(pop, masks, batch)
    torch.cuda.synchronize()
    assert layers.BN_TRAIN_ROUTES["kernel"] == before.get("kernel", 0)
    assert layers.BN_TRAIN_ROUTES["plain"] > before.get("plain", 0)
    assert bool(torch.isfinite(losses).all())


@pytest.mark.card
def test_graph_capture_of_the_forward_replays_equal_to_eager(card):
    g = torch.Generator(device=card).manual_seed(9)
    y = torch.randn(8, 48, 64, 64, generator=g, device=card)
    scale, bias, mean, var = (t.to(card) for t in _params(48))
    start = (mean.clone(), var.clone())
    eager = bnk.bn_act_train(y, scale, bias, mean, var, "relu6")
    eager_buffers = (mean.clone(), var.clone())
    mean.copy_(start[0])
    var.copy_(start[1])
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(stream):   # warm: the library loads outside
        bnk.bn_act_train(y, scale, bias, copy.deepcopy(mean),
                         copy.deepcopy(var), "relu6")
    torch.cuda.current_stream(card).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = bnk.bn_act_train(y, scale, bias, mean, var, "relu6")
    mean.copy_(start[0])
    var.copy_(start[1])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert torch.equal(mean, eager_buffers[0])
    assert torch.equal(var, eager_buffers[1])
