"""segtpu_torch's training utilities vs the JAX package's, on the CPU.

* ``GroupSGD`` against optax's chain (clip_by_global_norm ->
  add_decayed_weights -> sgd) on the same parameter and gradient trees,
  three steps (so momentum shows), with each group's norm below and
  above its clip, missing gradients as optax's zeros, and without
  momentum: parameters rel 1e-6 (max|d| <= 1e-6 max|want| per leaf: f32
  sums of squares in another order move the norm by an ulp);
* ``polyak_update`` against JAX's at steps 0..3,
  ``global_norm`` against ``optax.global_norm``: rel 1e-6;
* the confusion matrix, ``compute_iu``, ``mean_iou`` and ``spearman``
  (ties included) exactly;
* checkpoints: the port's ``run_training`` checkpoint loads in
  ``segtpu.train.load_trained`` and a JAX one in the port's, bit for bit;
* ``run_training`` on tests/test_train.py's quadrant task: best mIoU >
  0.4, as the JAX package's own test asks;
* the helpers and the step timer.
"""

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from segtpu.data.datasets import BatchLoader, SyntheticDataset
from segtpu.models.segmenter import count_params, segmenter_init
from segtpu.train import load_trained as jax_load_trained
from segtpu.utils.helpers import prepare_img as jax_prepare_img
from segtpu.utils.metrics import (compute_iu as jax_compute_iu,
                                  confusion_matrix as jax_confusion_matrix,
                                  mean_iou as jax_mean_iou,
                                  spearman as jax_spearman)
from segtpu.utils.saver import save_pytree as jax_save_pytree
from segtpu.utils.solvers import (create_optimisers as jax_create_optimisers,
                                  polyak_update as jax_polyak_update)

from segtpu_torch.convert import to_jax_params
from segtpu_torch.models import ARCHS, TEMPLATE_ARCHS
from segtpu_torch.models.segmenter import Segmenter
from segtpu_torch.train import TrainConfig, load_trained, run_training
from segtpu_torch.utils.helpers import (AverageMeter, compute_params,
                                        prepare_img)
from segtpu_torch.utils.metrics import (compute_iu, confusion_matrix,
                                        mean_iou, spearman)
from segtpu_torch.utils.profiling import StepTimer, hard_sync
from segtpu_torch.utils.saver import load_pytree, save_pytree
from segtpu_torch.utils.solvers import (GroupSGD, SGDGroup, create_optimisers,
                                        global_norm, polyak_update, sgd_chain)

from test_torch_trainer import _flat

K = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread while this module runs (the suite runs six
    workers on the machine's cores), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, scale):
    """An encoder/decoder tree of a few leaves, numpy f32 times scale."""
    shapes = {"encoder": {"stem": {"w": (3, 3, 3, 8), "scale": (8,)},
                          "blocks": [{"w": (1, 1, 8, 16)}]},
              "decoder": {"clf": {"w": (1, 1, 16, 5), "b": (5,)}}}
    return jax.tree.map(
        lambda shape: (rng.standard_normal(shape) * scale).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple))


def _named(tree):
    return {k: torch.tensor(v) for k, v in _flat(tree).items()}


def _assert_close(got: dict, want, tol=1e-6):
    want = _flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), k


def _optax_steps(opt, params, grads, steps):
    state = opt.init(params)
    for g in grads[:steps]:
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return params, state


# -------------------------------------------------------------- optimizer


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_group_sgd_matches_optax(grad_scale):
    """grad_scale 1e-3: both groups' norms under their clip (gradients
    pass as they are); 10: both over it (g / norm * clip)."""
    rng = np.random.default_rng(0)
    params = _tree(rng, 1.0)
    grads = [_tree(rng, grad_scale) for _ in range(3)]
    kw = dict(enc_lr=0.1, dec_lr=0.3, enc_wd=1e-2, dec_wd=1e-3,
              enc_grad_clip=0.5, dec_grad_clip=2.0)
    want, _ = _optax_steps(jax_create_optimisers(**kw), params, grads, 3)
    opt = create_optimisers(**kw)
    got = _named(params)
    state = opt.init(got)
    for g in grads:
        norms = opt.update(_named(g), state, got)
    for group, clip in (("encoder", 0.5), ("decoder", 2.0)):
        norm = float(optax.global_norm(grads[-1][group]))
        assert (norm < clip) == (grad_scale < 1), (group, norm)
        assert abs(float(norms[group]) - norm) <= 1e-6 * norm
    _assert_close(got, jax.tree.map(np.asarray, want))


def test_single_chain_and_missing_gradients_match_optax():
    """The search's stage-1 chain over every parameter; a parameter
    without a gradient steps on zeros (weight decay and momentum)."""
    rng = np.random.default_rng(1)
    params = _tree(rng, 1.0)
    grads = [_tree(rng, 1.0) for _ in range(3)]
    for g in grads:
        g["encoder"]["stem"]["scale"] = np.zeros(8, np.float32)
    chain = optax.chain(optax.clip_by_global_norm(3.0),
                        optax.add_decayed_weights(1e-2),
                        optax.sgd(0.1, momentum=0.9))
    want, _ = _optax_steps(chain, params, grads, 3)
    opt = sgd_chain(0.1, momentum=0.9, wd=1e-2, clip=3.0)
    got = _named(params)
    state = opt.init(got)
    for g in grads:
        named = _named(g)
        named["encoder.stem.scale"] = None
        opt.update(named, state, got)
    _assert_close(got, jax.tree.map(np.asarray, want))


def test_sgd_without_momentum_matches_optax():
    """Momentum 0 and no clip in reach: optax's plain sgd(lr)."""
    rng = np.random.default_rng(2)
    params, grads = _tree(rng, 1.0), [_tree(rng, 1.0) for _ in range(2)]
    want, _ = _optax_steps(optax.sgd(0.5), params, grads, 2)
    opt = GroupSGD({"all": SGDGroup(0.5, momentum=0.0, wd=0.0, clip=1e9)})
    got = _named(params)
    state = opt.init(got)
    for g in grads:
        opt.update(_named(g), state, got)
    _assert_close(got, jax.tree.map(np.asarray, want))


def test_global_norm_matches_optax():
    tree = _tree(np.random.default_rng(3), 2.0)
    want = float(optax.global_norm(tree))
    assert abs(float(global_norm(_named(tree).values())) - want) <= 1e-6 * want


def test_polyak_matches_jax():
    rng = np.random.default_rng(4)
    avg, params = _tree(rng, 1.0), [_tree(rng, 1.0) for _ in range(4)]
    want, got = avg, _named(avg)
    for step, p in enumerate(params):
        want = jax_polyak_update(want, p, 0.9, step=step)
        polyak_update(got, _named(p), 0.9, step=step)
        _assert_close(got, jax.tree.map(np.asarray, want))


# ---------------------------------------------------------------- metrics


def test_confusion_matrix_and_miou_match_jax():
    """Labels outside [0, K) (255, 7, -1) count nowhere."""
    rng = np.random.default_rng(5)
    pred = rng.integers(0, K, (3, 17, 19))
    gt = rng.integers(0, K, (3, 17, 19))
    gt[0, :4] = 255
    gt[1, 5, :7] = 7
    gt[2, 0, :3] = -1
    want = np.asarray(jax_confusion_matrix(jnp.asarray(pred),
                                           jnp.asarray(gt), K))
    got = confusion_matrix(torch.from_numpy(pred), torch.from_numpy(gt), K)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int(((gt >= 0) & (gt < K)).sum())
    cm = got.numpy()
    cm[3] = 0                               # a class absent: IoU NaN
    cm[:, 3] = 0
    np.testing.assert_array_equal(compute_iu(cm), jax_compute_iu(cm))
    assert mean_iou(cm) == jax_mean_iou(cm)


@pytest.mark.parametrize("a,b", [
    ([1, 2, 3, 4, 5], [5, 6, 7, 8, 7]),
    ([0.3, 0.3, 0.1, 0.9, 0.3], [2, 1, 1, 3, 0]),
    ([1, 1, 1], [1, 2, 3]),                 # no variance: 0
])
def test_spearman_matches_jax_on_ties(a, b):
    assert spearman(a, b) == jax_spearman(a, b)


# ------------------------------------------------------------- checkpoints


def _quadrant_loaders(cfg):
    """tests/test_train.py's learnable task: mask = quadrant index, in
    batches of ``cfg.batch_size`` crops of ``cfg.crop_size``."""
    ds = SyntheticDataset(n=8, hw=(32, 32), num_classes=K, seed=1)
    ds.masks[:] = 0
    ds.masks[:, 16:, :16] = 1
    ds.masks[:, :16, 16:] = 2
    ds.masks[:, 16:, 16:] = 3
    return tuple(BatchLoader(ds, batch_size=cfg.batch_size,
                             crop=cfg.crop_size, train=train)
                 for train in (True, False))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """run_training on the quadrant task, as tests/test_train.py runs the
    JAX package's: arch2, 30 epochs of 2 steps, Polyak on."""
    snap = tmp_path_factory.mktemp("snap")
    cfg = TrainConfig(num_classes=K, crop_size=(32, 32), batch_size=4,
                      num_epochs=30, val_every=10, do_polyak=True,
                      dec_lr=0.05, enc_lr=0.01, snapshot_dir=str(snap))
    best, state = run_training(ARCHS["arch2"], *_quadrant_loaders(cfg), cfg,
                               device="cpu")
    return best, state, snap / "best_params.npz"


def test_run_training_learns_the_quadrant_task(trained):
    best, state, path = trained
    assert best > 0.4, f"best mIoU {best}"
    assert state.step == 60 and path.exists()


def test_port_checkpoint_loads_in_jax(trained):
    _, _, path = trained
    params, stats = jax_load_trained(str(path), ARCHS["arch2"], num_classes=K)
    want = load_pytree(str(path))
    np.testing.assert_equal(_flat(jax.tree.map(np.asarray, params)),
                            _flat(want["params"]))
    np.testing.assert_equal(_flat(jax.tree.map(np.asarray, stats)),
                            _flat(want["stats"]))


@pytest.mark.parametrize("name", ["arch0", "template0"])
def test_jax_checkpoint_loads_in_port(tmp_path, name):
    genotype = {**ARCHS, **TEMPLATE_ARCHS}[name]
    params, stats = segmenter_init(jax.random.PRNGKey(3), genotype,
                                   num_classes=K, aux=True)
    path = str(tmp_path / "best_params.npz")
    jax_save_pytree(path, {"params": params, "stats": stats})
    model = load_trained(path, genotype, K, device="cpu")
    assert not model.training
    got_p, got_s = to_jax_params(model)
    np.testing.assert_equal(_flat(got_p),
                            _flat(jax.tree.map(np.asarray, params)))
    np.testing.assert_equal(_flat(got_s),
                            _flat(jax.tree.map(np.asarray, stats)))


def test_saver_round_trip(tmp_path):
    tree = {"a": [np.arange(3.0), {"b": torch.ones(2, 2)}], "c": np.int32(7)}
    save_pytree(str(tmp_path / "t.npz"), tree)
    got = load_pytree(str(tmp_path / "t.npz"))
    np.testing.assert_equal(got, {"a": {"0": np.arange(3.0),
                                        "1": {"b": np.ones((2, 2))}},
                                  "c": np.int32(7)})


def test_data_parallel_training_is_not_ported_yet(tmp_path):
    """``data_parallel`` on one device trains unsharded, as the JAX
    package's run_training does (it shards only over more than one
    device): an epoch of the quadrant task runs its two steps and
    validates. tests/test_torch_data_parallel.py holds it to the run
    without the flag, bit for bit, and the sharded step itself."""
    cfg = TrainConfig(num_classes=K, crop_size=(32, 32), batch_size=4,
                      num_epochs=1, data_parallel=True,
                      snapshot_dir=str(tmp_path))
    best, state = run_training(ARCHS["arch2"], *_quadrant_loaders(cfg), cfg,
                               device="cpu")
    assert state.step == 2 and np.isfinite(best)
    assert (tmp_path / "best_params.npz").exists()


# ----------------------------------------------------------------- helpers


def test_prepare_img_matches_jax():
    img = np.random.default_rng(6).integers(0, 256, (5, 7, 3), np.uint8)
    np.testing.assert_array_equal(prepare_img(img), jax_prepare_img(img))


def test_compute_params_matches_jax():
    genotype = ARCHS["arch0"]
    params, _ = segmenter_init(jax.random.PRNGKey(0), genotype,
                               num_classes=K, aux=True)
    model = Segmenter(genotype, K, aux=True,
                      generator=torch.Generator().manual_seed(0))
    assert compute_params(model) == count_params(params)
    assert compute_params(dict(model.named_parameters())) == \
        count_params(params)


def test_average_meter_and_step_timer():
    meter = AverageMeter()
    meter.update(2.0, n=3)
    meter.update(4.0)
    assert meter.avg == 2.5 and meter.val == 4.0
    timer = StepTimer(warmup=1)
    for _ in range(3):
        with timer.step(n_items=4):
            hard_sync(torch.ones(3))
    assert timer._steps == 2 and timer.items_per_sec > 0
    assert hard_sync({"x": [torch.ones(2), torch.full((2,), 2.0)]}) == 6.0
