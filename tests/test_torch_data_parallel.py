"""segtpu_torch's data-parallel training (``parallel.mesh.shard_batch``,
``make_sharded_train_step``, ``make_sharded_eval_step``) on logical CPU
devices, at tests/test_parallel.py's size: arch2 with aux heads, K = 5
classes, 4 images of 64x64, in f32 with PyTorch's own convolutions
(oneDNN's f32 backward loses up to 10 % on some weight gradients on a
CPU with AMX; see tests/test_torch_trainer.py).

The JAX package's sharded step is its unsharded step on the whole batch
up to rounding (XLA reduces the gradients and BatchNorm's moments over
the mesh). The port's is held to that:

* one step on ``[cpu] * 2`` and ``[cpu] * 4`` against the unsharded step
  on the whole batch, whose shards hold different numbers of ignored
  pixels (255 and the out-of-range 7): the loss at rtol 2e-4; by group
  (encoder, decoder) the parameters, momentum traces, Polyak averages
  (floor 1e-2 of the unsharded step's own move) and BatchNorm running
  stats (floor 1e-3) within max(floor, SPREAD x the unsharded step's own
  spread: the same step on the batch in reversed order, which only
  reorders its sums), tests/test_torch_trainer.py's rule. Measured: at
  most 1.06x that spread on 2 shards and 2.3e-3x on 4;
* two planted faults fail those limits: each shard normalizing with its
  own moments (ghost BN: the loss 17x-37x its limit, parameters 17x-22x,
  running stats 238x-982x) and the loss as the mean of the shards' mean
  losses (the loss 2.8x-27x, parameters 3.6x-8.1x);
* the components: sharded ``bn_train`` against ``bn_train`` on the
  whole batch where mean^2 >> var (outputs and stats rel 1e-5, the stats
  moved once), ``combine_loss_terms`` against JAX's ``segmentation_loss``
  on the whole batch (aux heads and KD, rel 1e-5);
* the sharded eval's confusion matrix equal to the unsharded one's and
  to JAX's ``make_sharded_eval_step`` on its virtual CPU mesh;
* ``run_training(data_parallel=True)`` on one device: the unsharded run,
  bit for bit; over ``devices=[cpu] * 2``: the sharded step, each loss
  at rtol 2e-4 of the unsharded run's, which ghost BN fails;
* a shard that fails raises in the caller and the other shards do not
  hang.

The step, spread and fault helpers take a genotype and a ``space`` axis:
tests/test_torch_space_parallel.py holds the ``space`` axis to the same
rule with them.
"""

import contextlib
import copy
import functools
import threading
from unittest import mock

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from segtpu.engine.trainer import make_eval_step as jax_make_eval_step
from segtpu.engine.trainer import segmentation_loss as jax_segmentation_loss
from segtpu.models.segmenter import segmenter_init
from segtpu.parallel.mesh import make_mesh as jax_make_mesh
from segtpu.parallel.mesh import \
    make_sharded_eval_step as jax_make_sharded_eval_step

from segtpu_torch.convert import load_jax_params
from segtpu_torch.core import layers
from segtpu_torch.core.bands import ShardGroup, shard_context
from segtpu_torch.core.layers import bn_train
from segtpu_torch.data.datasets import BatchLoader, SyntheticDataset
from segtpu_torch.engine import trainer
from segtpu_torch.engine.trainer import (combine_loss_terms,
                                         init_train_state, make_eval_step,
                                         make_train_step,
                                         segmentation_loss_terms)
from segtpu_torch.models import ARCHS, TEMPLATE_ARCHS, create_segmenter
from segtpu_torch.models.segmenter import Segmenter
from segtpu_torch.parallel import (make_mesh, make_sharded_eval_step,
                                   make_sharded_train_step, shard_batch)
from segtpu_torch.train import TrainConfig, run_training
from segtpu_torch.utils.solvers import create_optimisers

from test_torch_layers import perturb_bn

K = 5
N, HW = 4, 64
ARCH = "arch2"
GENOTYPE = ARCHS[ARCH]
AUX_WEIGHT = 0.15
OPT = dict(enc_lr=1e-3, dec_lr=3e-3, enc_wd=1e-2, dec_wd=1e-3,
           enc_grad_clip=3.0, dec_grad_clip=3.0)
LOSS_RTOL = 2e-4
SPREAD = 4
FLOOR = {"params": 1e-2, "trace": 1e-2, "polyak": 1e-2, "stats": 1e-3}
SHARDS = (2, 4)
FAULTS = ("ghost_bn", "mean_of_shard_means")


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
    """PyTorch's own f32 convolutions, not oneDNN's, for every test."""
    was = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = was


def _batch(reverse=False, seed=0):
    """Normal images and labels in [0, K) with ignored pixels that differ
    from image to image: a band of 255 in image 0, a patch of the
    out-of-range 7 in image 1, none in image 2, 40 rows of 255 in image
    3. ``reverse``: the same batch in reversed order."""
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((N, HW, HW, 3)).astype(np.float32)
    label = rng.integers(0, K, (N, HW, HW)).astype(np.int32)
    label[0, 20:28] = 255
    label[1, 40:44, :10] = 7
    label[3, :40] = 255
    if reverse:
        image, label = image[::-1].copy(), label[::-1].copy()
    return {"image": image, "label": label}


@functools.lru_cache(maxsize=None)
def _model(arch=ARCH):
    return create_segmenter({**ARCHS, **TEMPLATE_ARCHS}[arch], K, aux=True, device="cpu",
                            generator=torch.Generator().manual_seed(0))


def _snap(state, loss=None):
    return {"params": {k: v.detach().clone() for k, v in state.params.items()},
            "trace": {k: v.clone() for k, v in state.opt_state.items()},
            "polyak": {k: v.clone() for k, v in state.polyak.items()},
            "stats": {k: v.clone() for k, v in state.stats.items()},
            "loss": None if loss is None else float(loss)}


def _local_moments(yf):
    """Ghost BN: the shard's own batch moments."""
    mean = yf.mean((0, 2, 3))
    var = (yf - mean[:, None, None]).square().mean((0, 2, 3))
    return mean, var, yf.numel() // yf.shape[1]


def _mean_of_shard_means(shard_terms, device):
    """The loss as the mean over shards of each shard's own loss."""
    loss = None
    for parts in zip(*shard_terms):
        value = sum(s.to(device) / c.to(device).clamp_min(1)
                    for _, s, c in parts) / len(parts)
        loss = value if loss is None else loss + parts[0][0] * value
    return loss


FAULT_PATCHES = {
    "ghost_bn": (layers, "_batch_moments", _local_moments),
    "mean_of_shard_means": (trainer, "combine_loss_terms",
                            _mean_of_shard_means)}


@functools.lru_cache(maxsize=None)
def _run(n=None, reverse=False, fault=None, arch=ARCH, space=1):
    """(state before, state after) of one step of ``arch`` from the
    seeded model: the unsharded step (``n`` None) or the step sharded
    over an (n, ``space``) mesh of logical CPU devices, with ``fault``
    planted: a key of ``FAULT_PATCHES`` or a (module, name, value)
    patch."""
    model = copy.deepcopy(_model(arch))
    opt = create_optimisers(**OPT)
    state = init_train_state(model, opt, do_polyak=True)
    with (mock.patch.object(*FAULT_PATCHES.get(fault, fault)) if fault
          else contextlib.nullcontext()):
        step = make_train_step(model.genotype, opt, num_classes=K,
                               aux_weight=AUX_WEIGHT)
        if n:
            step = make_sharded_train_step(step, make_mesh(
                n, space, devices=["cpu"] * (n * space)))
        before = _snap(state)
        state, loss = step(state, _batch(reverse))
    return before, _snap(state, loss)


def _dist(a, b, group) -> float:
    return float(np.sqrt(sum(
        (a[k].double() - b[k].double()).square().sum().item()
        for k in a if k.startswith(group + "."))))


def _errors(what, got, arch=ARCH):
    """[(group, error, limit, spread, update)]: ``got``'s L2 distance to
    the unsharded step's ``what``, and its limit from the unsharded
    step's own spread (reversed batch) and move."""
    before, want = _run(arch=arch)
    _, reversed_ = _run(reverse=True, arch=arch)
    out = []
    for group in ("encoder", "decoder"):
        spread = _dist(reversed_[what], want[what], group)
        update = _dist(want[what], before[what], group)
        out.append((group, _dist(got[what], want[what], group),
                    max(FLOOR[what] * update, SPREAD * spread), spread,
                    update))
    return out


def _loss_error(got, arch=ARCH) -> float:
    want = _run(arch=arch)[1]["loss"]
    return abs(got["loss"] - want) / abs(want)


def _holds(got, what, arch=ARCH):
    """Assert a sharded step's snapshot ``got`` within the rule for
    ``what`` ("params" holds the parameters and the momentum traces)."""
    if what == "loss":
        assert _loss_error(got, arch) <= LOSS_RTOL, (
            got["loss"], _run(arch=arch)[1]["loss"])
        return
    for key in ("params", "trace") if what == "params" else (what,):
        for group, err, limit, spread, update in _errors(key, got, arch):
            assert err <= limit, (key, group, err, limit)
            if key != "stats":
                # the limit still catches a step skipped or taken twice
                assert SPREAD * spread < update, (key, group)


def _fails(got, keys, arch=ARCH):
    """Assert a faulty step's snapshot ``got`` outside the rule: the
    loss, and every group of each of ``keys``."""
    assert _loss_error(got, arch) > LOSS_RTOL
    for key in keys:
        for group, err, limit, _, _ in _errors(key, got, arch):
            assert err > limit, (key, group, err, limit)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("what", ["loss", "params", "stats", "polyak"])
def test_sharded_step_matches_unsharded(n, what):
    """"params" holds the parameters and the momentum traces."""
    _holds(_run(n)[1], what)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_limits(fault, n):
    """Ghost BN and the mean of the shards' mean losses each throw the
    loss, and every group's parameters, traces and Polyak averages, out
    of ``test_sharded_step_matches_unsharded``'s limits; ghost BN the
    running stats too."""
    _fails(_run(n, fault=fault)[1], ["params", "trace", "polyak"]
           + (["stats"] if fault == "ghost_bn" else []))


# ------------------------------------------------------------ components


def _in_threads(n, fn, row=False):
    """fn(rank) in n threads of one ShardGroup (with ``row``, also one
    row of n shards); the results in rank order."""
    group = ShardGroup(n)
    out, errors = [None] * n, []

    def run(r):
        try:
            with shard_context(group, r, group if row else None, r):
                out[r] = fn(r)
        except BaseException as e:  # noqa: B036 - asserted below
            errors.append(e)
            group.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return out


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_batchnorm_is_the_whole_batch(n):
    """bn_train over n shards in their threads: outputs and the running
    stats (moved once) those of bn_train on the whole batch, where the
    conv output's mean^2 is ~1e3 its variance (a one-pass variance would
    be ~1e-4 off)."""
    rng = np.random.default_rng(0)
    y = torch.from_numpy((20.0 + rng.standard_normal((N, 6, 12, 10)))
                         .astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.1, 6).astype(np.float32))
    mean0 = torch.from_numpy(rng.normal(0, 0.1, 6).astype(np.float32))
    var0 = torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32))
    mean, var = mean0.clone(), var0.clone()
    want = bn_train(y, scale, bias, mean, var)
    got_mean, got_var = mean0.clone(), var0.clone()
    per = N // n
    parts = _in_threads(n, lambda r: bn_train(
        y[r * per:(r + 1) * per], scale, bias, got_mean, got_var))
    got = torch.cat(parts)
    for a, b in ((got, want), (got_mean, mean), (got_var, var)):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-5


def test_shard_group_stress():
    """More shards than cores, the interpreter switching threads as
    often as it can, 100 meetings each: every sum is exact, so no shard
    ever reads a part of another meeting (the two sets of slots)."""
    import sys
    n, rounds = 12, 100
    group = ShardGroup(n)
    bad, errors = [], []

    def run(r):
        try:
            for k in range(rounds):
                got, t = group.all_sum(r, r * rounds + k, torch.tensor(
                    [float(r + k)]))
                if (got != n * k + rounds * n * (n - 1) // 2
                        or t.item() != n * k + n * (n - 1) // 2):
                    bad.append((r, k, got, t.item()))
        except BaseException as e:  # noqa: B036 - asserted below
            errors.append(e)
            group.abort()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not bad, (errors, bad[:3])


@pytest.mark.parametrize("kd", [False, True])
def test_combined_loss_is_jax_loss_on_the_whole_batch(kd):
    """combine_loss_terms over 4 shards (their ignored pixels differ)
    against JAX's segmentation_loss on the whole batch, with aux heads
    and with KD."""
    rng = np.random.default_rng(1)
    b = _batch()
    logits = rng.standard_normal((N, HW // 4, HW // 4, K)).astype(np.float32)
    aux = [rng.standard_normal((N, HW // 8, HW // 8, K)).astype(np.float32)
           for _ in range(2)]
    teacher = rng.standard_normal((N, HW // 4, HW // 4, K)).astype(
        np.float32) if kd else None
    kd_coeff = 0.3 if kd else 0.0
    want = float(jax_segmentation_loss(
        jnp.asarray(logits), [jnp.asarray(a) for a in aux],
        jnp.asarray(b["label"]), num_classes=K, aux_weight=AUX_WEIGHT,
        teacher_logits=None if teacher is None else jnp.asarray(teacher),
        kd_coeff=kd_coeff))

    def nchw(x, r):
        return torch.from_numpy(np.ascontiguousarray(
            np.transpose(x[r:r + 1], (0, 3, 1, 2))))

    terms = [segmentation_loss_terms(
        nchw(logits, r), [nchw(a, r) for a in aux],
        torch.from_numpy(b["label"][r:r + 1]).long(), num_classes=K,
        aux_weight=AUX_WEIGHT,
        teacher_logits=None if teacher is None else nchw(teacher, r),
        kd_coeff=kd_coeff) for r in range(N)]
    got = float(combine_loss_terms(terms, torch.device("cpu")))
    assert abs(got - want) <= 1e-5 * abs(want)
    # the mean of the shards' means fails that tolerance (by ~10x here)
    assert abs(float(_mean_of_shard_means(terms, torch.device("cpu")))
               - want) > 1e-5 * abs(want)


# ------------------------------------------------------------------ eval


def _eval_matches_unsharded_and_jax(genotype, data, space=1):
    """Assert the eval sharded over a (data, space) mesh gives the
    unsharded eval's confusion matrix and JAX's sharded eval's on the
    same weights (JAX's init with BatchNorm perturbed, carried over by
    ``load_jax_params``)."""
    p, s = jax.tree.map(np.asarray, segmenter_init(
        jax.random.PRNGKey(0), genotype, num_classes=K, aux=True))
    p, s = perturb_bn(p, s, np.random.default_rng(0))
    model = load_jax_params(
        Segmenter(genotype, K, aux=True,
                  generator=torch.Generator().manual_seed(0)), p, s)
    params = {k: v.detach() for k, v in model.named_parameters()}
    stats = dict(model.named_buffers())
    b = _batch(seed=1)
    ev = make_eval_step(genotype, num_classes=K)
    want = ev(params, stats, b)
    got = make_sharded_eval_step(ev, make_mesh(
        data, space, devices=["cpu"] * (data * space)))(params, stats, b)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    valid = (b["label"] >= 0) & (b["label"] < K)
    assert int(got.sum()) == int(valid.sum())
    jax_cm = jax_make_sharded_eval_step(
        jax_make_eval_step(genotype, num_classes=K),
        jax_make_mesh(data, space, devices=jax.devices("cpu")))(
        p, s, {"image": jnp.asarray(b["image"]),
               "label": jnp.asarray(b["label"])})
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_cm))


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_eval_matches_unsharded_and_jax(n):
    """The sharded eval's confusion matrix equals the unsharded one's and
    JAX's sharded eval's on the same weights (JAX's init with BatchNorm
    perturbed, carried over by ``load_jax_params``)."""
    _eval_matches_unsharded_and_jax(GENOTYPE, n)


# ----------------------------------------------------------- shard_batch


def test_shard_batch_splits_along_n():
    b = dict(_batch(), teacher=torch.ones(N, K, 16, 16), name="kept")
    shards = shard_batch(make_mesh(2, devices=["cpu"] * 2), b)
    assert len(shards) == 2
    for r, s in enumerate(shards):
        np.testing.assert_array_equal(s["image"].numpy(),
                                      b["image"][2 * r:2 * r + 2])
        np.testing.assert_array_equal(s["label"].numpy(),
                                      b["label"][2 * r:2 * r + 2])
        assert s["teacher"].shape == (2, K, 16, 16) and s["name"] == "kept"
    with pytest.raises(ValueError, match="divide"):
        shard_batch(make_mesh(3, devices=["cpu"] * 3), b)


def test_sharded_step_takes_make_train_steps_only():
    with pytest.raises(TypeError, match="make_train_step"):
        make_sharded_train_step(lambda state, batch: (state, 0.0),
                                make_mesh(2, devices=["cpu"] * 2))


def test_a_failing_shard_raises_and_nobody_hangs(monkeypatch):
    """Shard 1 fails before its first BatchNorm: the step raises its
    error in the caller, and shard 0, waiting at that BatchNorm, is let
    go rather than left waiting."""
    real = trainer.images_to
    model = copy.deepcopy(_model())
    opt = create_optimisers()
    state = init_train_state(model, opt)
    step = make_sharded_train_step(
        make_train_step(GENOTYPE, opt, num_classes=K),
        make_mesh(2, devices=["cpu"] * 2))
    b = _batch()
    b["image"] = b["image"].copy()
    b["image"][2:] = np.nan

    def fail_on_nan(image, device):
        if torch.isnan(torch.as_tensor(image)).any():
            raise FloatingPointError("shard 1's images")
        return real(image, device)

    monkeypatch.setattr(trainer, "images_to", fail_on_nan)
    raised = []

    def run():
        with pytest.raises(FloatingPointError, match="shard 1"):
            step(state, b)
        raised.append(True)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and raised


# -------------------------------------------------------- run_training


def _loaders():
    ds = SyntheticDataset(n=8, hw=(32, 32), num_classes=K, seed=1)
    return tuple(BatchLoader(ds, batch_size=4, crop=(32, 32), train=train)
                 for train in (True, False))


def _run_training(tmp_path, monkeypatch, data_parallel, num_epochs,
                  **kw):
    """(best mIoU, each step's loss, state snapshot) of run_training on
    the CPU from the seeded model."""
    import segtpu_torch.train as train_mod
    losses = []
    # run_training syncs on each step's loss
    monkeypatch.setattr(train_mod, "hard_sync",
                        lambda loss: losses.append(loss.clone()))
    cfg = TrainConfig(num_classes=K, crop_size=(32, 32), batch_size=4,
                      num_epochs=num_epochs, val_every=1,
                      data_parallel=data_parallel,
                      snapshot_dir=str(tmp_path / str(data_parallel)))
    best, state = run_training(GENOTYPE, *_loaders(), cfg, device="cpu",
                               **kw)
    return best, losses, _snap(state)


def test_run_training_data_parallel_on_one_device_is_unsharded(
        tmp_path, monkeypatch):
    """On one device ``data_parallel`` trains exactly as without it, as
    the JAX package does: the same losses, weights, stats and best mIoU,
    bit for bit."""
    b0, l0, s0 = _run_training(tmp_path, monkeypatch, False, 2)
    b1, l1, s1 = _run_training(tmp_path, monkeypatch, True, 2)
    assert b0 == b1 and len(l0) == len(l1) == 4
    assert all(torch.equal(x, y) for x, y in zip(l0, l1))
    for key in ("params", "trace", "polyak", "stats"):
        assert all(torch.equal(s0[key][k], s1[key][k]) for k in s0[key]), key


@pytest.mark.parametrize("fault", [None, "ghost_bn"])
def test_run_training_shards_over_the_devices_it_is_given(
        tmp_path, monkeypatch, fault):
    """``data_parallel`` over ``devices=[cpu] * 2``: run_training builds
    the sharded step on a 2-device mesh (the branch that several cards
    take), and each of its two steps' losses is the unsharded run's at
    rtol LOSS_RTOL (measured: rel 4.0e-5 at most); under ghost BN the
    first misses it 81x (rel 1.6e-2)."""
    import segtpu_torch.train as train_mod
    meshes, real = [], train_mod.make_sharded_train_step

    def spy(step, mesh):
        meshes.append(mesh)
        return real(step, mesh)

    monkeypatch.setattr(train_mod, "make_sharded_train_step", spy)
    _, want, _ = _run_training(tmp_path, monkeypatch, False, 1)
    if fault == "ghost_bn":
        monkeypatch.setattr(layers, "_batch_moments", _local_moments)
    _, got, state = _run_training(tmp_path, monkeypatch, True, 1,
                                  devices=["cpu"] * 2)
    assert [m.shape for m in meshes] == [{"data": 2, "space": 1}]
    assert len(got) == len(want) == 2 and all(map(torch.isfinite, got))
    worst = max(abs(float(g) - float(w)) / abs(float(w))
                for g, w in zip(got, want))
    if fault is None:
        assert worst <= LOSS_RTOL, (got, want)
    else:
        assert worst > LOSS_RTOL, (got, want)
