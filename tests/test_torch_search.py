"""segtpu_torch's search loop, saver and CLI against segtpu's, on the CPU.

* ``make_eval_step`` evaluates the parameters it is handed at any
  decoder width and repeat count: JAX's confusion matrix exactly, for
  arch0 at agg 48 with two repeats and at agg 32 with one, and template0
  at agg 32 with two (2x64x64, K = 5, BatchNorm perturbed).
* ``proxy_train`` from JAX's weights (the encoder by
  ``load_jax_params``, the decoder through ``search.init_decoder``, made
  to build JAX's ``fam.init``) on the same loaders' batches: arch0, crop
  32x32, batch 2, K = 4, eight synthetic images, oneDNN off as in
  ``tests/test_torch_trainer.py``. With ``num_epochs=(0, 0)`` both mIoUs
  within 1e-3 of JAX's (measured: equal). With ``(1, 1)`` each within
  ``SPREAD`` x JAX's own spread: the largest move of JAX's mIoU with the
  encoder's weights one rounding apart, the decoder's initial weights one
  rounding apart, or every batch's images in reverse order (which only
  reorders its sums); and that limit stays below JAX's own move from
  ``(0, 0)`` (measured: the port's miou2 at 0.02x the spread, miou1
  equal).
* ``compute_reward`` equals JAX's; ``run_search`` runs two iterations of
  cvpr/PPO and of wacv/REINFORCE, scores an invalid genotype
  ``invalid_reward`` and resumes; ``SearchSaver`` snapshots of either
  package load and resume in the other.
* The CLI parses and dispatches as ``tests/test_cli.py`` holds the JAX
  CLI to; ``--supernet``, ``--pop-devices`` and ``--fleet`` reach the
  population search, its mesh and the fleet (``--pop-devices 2`` on one
  card raises ``make_mesh``'s error), and a sharded ``--supernet`` round
  runs on the CPU; ``train`` hands
  ``--shorter-side`` to its loader; ``infer`` gives the engine's mask and
  ``eval`` the eval step's mIoU.
* A subprocess imports every ``segtpu_torch`` module and finds neither
  ``jax`` nor ``segtpu`` in ``sys.modules``.
"""

import functools
import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax

import segtpu.search as js
from segtpu.config import SearchConfig as JaxSearchConfig
from segtpu.data import datasets as jds
from segtpu.engine.trainer import make_eval_step as jax_make_eval_step
from segtpu.models import families as jfamilies
from segtpu.models.encoders import mbv2_init
from segtpu.models.segmenter import segmenter_init
from segtpu.rl.controller import MicroControllerSpec as JaxSpec
from segtpu.rl.controller import controller_init as jax_controller_init
from segtpu.utils.saver import SearchSaver as JaxSearchSaver

import segtpu_torch
import segtpu_torch.main_search as tmain
import segtpu_torch.search as ts
from segtpu_torch.config import SearchConfig
from segtpu_torch.convert import (controller_to_jax, load_jax_controller,
                                  load_jax_params)
from segtpu_torch.data import datasets as tds
from segtpu_torch.engine import Segmenter as Engine
from segtpu_torch.engine.trainer import make_eval_step
from segtpu_torch.models import ARCHS, TEMPLATE_ARCHS
from segtpu_torch.models.encoders import MBV2_TAP_CHANNELS, MobileNetV2
from segtpu_torch.models.families import infer_family
from segtpu_torch.models.segmenter import Segmenter as SegmenterNet
from segtpu_torch.rl.controller import MicroControllerSpec
from segtpu_torch.utils.saver import SearchSaver

from test_torch_layers import _np_tree, perturb_bn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 4
CROP = (32, 32)
PROXY = dict(num_classes=K, crop_size=CROP, batch_size=(2, 2),
             aux_cell=True, seed=3)
PROXY_GENOTYPE = ARCHS["arch0"]
PROXY_SEED = 5
# as tests/test_torch_trainer.py::SPREAD
SPREAD = 4
SPREAD_SIDES = ("encoder", "decoder", "reversed")


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


# ------------------------------------------------------------ eval step

EVAL_CASES = {"arch0_agg48_rep2": ("arch0", 48, 2),
              "arch0_agg32_rep1": ("arch0", 32, 1),
              "template0_agg32_rep2": ("template0", 32, 2)}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_eval_step_reads_any_width_and_repeats(case):
    name, agg, reps = EVAL_CASES[case]
    genotype = {**ARCHS, **TEMPLATE_ARCHS}[name]
    p, s = _np_tree(segmenter_init(jax.random.PRNGKey(2), genotype,
                                   num_classes=5, agg_size=agg,
                                   repeats=reps, aux=True))
    p, s = perturb_bn(p, s, np.random.default_rng(2))
    model = SegmenterNet(genotype, 5, agg_size=agg, repeats=reps, aux=True,
                         generator=torch.Generator().manual_seed(0))
    load_jax_params(model, p, s)
    rng = np.random.default_rng(4)
    batch = {"image": rng.standard_normal((2, 64, 64, 3), dtype=np.float32),
             "label": rng.integers(0, 5, (2, 64, 64)).astype(np.int32)}
    batch["label"][:, :5] = 255
    want = np.asarray(jax_make_eval_step(genotype, num_classes=5)(p, s, batch))
    got = make_eval_step(genotype, num_classes=5)(
        {n: t.detach() for n, t in model.named_parameters()},
        dict(model.named_buffers()), batch).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want.argmax(1))) > 1 or want.sum(0).max() < want.sum()


# ------------------------------------------------------------ proxy_train


def _memo(fn):
    """One JAX step per genotype and settings for the module: the JAX
    search makes (and compiles) new ones in every proxy_train call."""
    cache = {}

    @functools.wraps(fn)
    def wrapped(genotype, *args, **kw):
        key = (json.dumps(genotype), tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = fn(genotype, *args, **kw)
        return cache[key]
    return wrapped


@pytest.fixture(scope="module")
def jax_steps():
    mp = pytest.MonkeyPatch()
    for name in ("make_decoder_train_step", "make_train_step",
                 "make_eval_step", "_make_decoder_eval_step"):
        mp.setattr(js, name, _memo(getattr(js, name)))
    yield
    mp.undo()


def _one_rounding(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (x * (1.0 + 2.0 ** -23 * rng.choice(
        [-1.0, 1.0], x.shape))).astype(np.float32), tree)


class _Reversed:
    """A loader whose batches hold their images in reverse order."""

    def __init__(self, loader):
        self.loader, self.indices = loader, loader.indices

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for b in self.loader:
            yield {k: v[::-1] for k, v in b.items()}


def _loaders(pkg):
    """(train, val, cache train, cache val), new ones for every run: a
    loader's epoch counter moves its augmentation."""
    ds = pkg.SyntheticDataset(n=8, hw=CROP, num_classes=K, seed=3)
    tr, va = pkg.create_loaders(ds, batch_size=2, crop=CROP,
                                meta_train_prct=0.9, seed=3)
    cache = [pkg.BatchLoader(ds, batch_size=2, crop=CROP, train=False,
                             seed=3, indices=ld.indices) for ld in (tr, va)]
    return tr, va, *cache


def _jax_encoder():
    return _np_tree(mbv2_init(jax.random.PRNGKey(0)))


def _jax_proxy(epochs, side=None):
    """JAX's (miou1, miou2), or those of one spread side."""
    cfg = JaxSearchConfig(num_epochs=epochs, **PROXY)
    tr, va, ctr, cva = _loaders(jds)
    ep, es = _jax_encoder()
    if side == "encoder":
        ep, es = _one_rounding((ep, es), 11)
    cached = [js._cache_taps(ep, es, ld) for ld in (ctr, cva)]
    if side == "reversed":
        cached[0] = [{"taps": [t[::-1] for t in b["taps"]],
                      "label": b["label"][::-1]} for b in cached[0]]
        tr = _Reversed(tr)
    mp = pytest.MonkeyPatch()
    if side == "decoder":
        real = jfamilies.infer_family

        def perturbed(genotype):
            fam = real(genotype)
            return fam._replace(init=lambda *a, **kw: _one_rounding(
                _np_tree(fam.init(*a, **kw)), 12))
        mp.setattr(jfamilies, "infer_family", perturbed)
    try:
        return js.proxy_train(PROXY_GENOTYPE, ep, es, cfg, *cached, tr, va,
                              rng_seed=PROXY_SEED)
    finally:
        mp.undo()


def _jax_decoder(genotype, cfg, *, seed, device):
    """search.init_decoder building JAX's ``fam.init`` weights."""
    from segtpu.models.families import infer_family as jax_infer_family
    p, s = _np_tree(jax_infer_family(genotype).init(
        jax.random.PRNGKey(seed), genotype, MBV2_TAP_CHANNELS,
        cfg.num_classes, agg_size=cfg.agg_size, repeats=cfg.sep_repeats,
        aux=True, aux_cell=cfg.aux_cell))
    dec = infer_family(genotype).build(
        genotype, MBV2_TAP_CHANNELS, cfg.num_classes, agg_size=cfg.agg_size,
        repeats=cfg.sep_repeats, aux=True, aux_cell=cfg.aux_cell,
        generator=torch.Generator().manual_seed(0))
    return load_jax_params(dec, p, s).to(device)


def _port_proxy(epochs, monkeypatch):
    monkeypatch.setattr(ts, "init_decoder", _jax_decoder)
    cfg = SearchConfig(num_epochs=epochs, **PROXY)
    tr, va, ctr, cva = _loaders(tds)
    enc = load_jax_params(MobileNetV2(
        generator=torch.Generator().manual_seed(0)), *_jax_encoder())
    cached = [ts._cache_taps(enc, ld) for ld in (ctr, cva)]
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    timings = {}
    got = ts.proxy_train(PROXY_GENOTYPE, enc, cfg, *cached, tr, va,
                         rng_seed=PROXY_SEED, timings=timings)
    assert all(torch.equal(v, enc.state_dict()[k]) for k, v in before.items())
    assert timings["stage1_steps"] == epochs[0] * 4
    assert timings["stage2_steps"] == epochs[1] * 3
    return got


def test_proxy_train_untrained_matches_jax(jax_steps, monkeypatch):
    got = _port_proxy((0, 0), monkeypatch)
    want = _jax_proxy((0, 0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_proxy_train_one_epoch_within_jax_spread(jax_steps, monkeypatch):
    got = np.asarray(_port_proxy((1, 1), monkeypatch))
    want = np.asarray(_jax_proxy((1, 1)))
    untrained = np.asarray(_jax_proxy((0, 0)))
    spread = np.max([np.abs(np.asarray(_jax_proxy((1, 1), side)) - want)
                     for side in SPREAD_SIDES], axis=0)
    assert (SPREAD * spread < np.abs(want - untrained)).all(), (
        spread, want, untrained)
    assert (np.abs(got - want) <= SPREAD * spread).all(), (got, want, spread)


# ------------------------------------------------------------ the loop


def test_compute_reward_matches_jax():
    for m1, m2 in [(0.25, 0.25), (0.0, 0.5), (float("nan"), 0.5),
                   (0.3, float("inf")), (-0.1, 0.4), (0.81, 0.49)]:
        assert ts.compute_reward(m1, m2) == js.compute_reward(m1, m2)
    assert ts.compute_reward(0.81, 0.49) == pytest.approx(0.63)


def _search_cfg(tmp_path, **kw):
    return SearchConfig(**{**dict(
        synthetic=True, num_classes=K, crop_size=CROP, batch_size=(4, 4),
        num_epochs=(1, 1), num_iters=2, snapshot_dir=str(tmp_path / "snap"),
        aux_cell=False, seed=7), **kw})


def _dataset(cfg):
    return tds.SyntheticDataset(n=8, hw=cfg.crop_size,
                                num_classes=cfg.num_classes, seed=cfg.seed)


@pytest.mark.parametrize("version,algo", [("cvpr", "ppo"),
                                          ("wacv", "reinforce")])
def test_run_search_two_iterations_and_resume(tmp_path, version, algo):
    cfg = _search_cfg(tmp_path, ctrl_version=version, ctrl_algo=algo)
    saver = ts.run_search(cfg, dataset=_dataset(cfg), device="cpu")
    assert [r["step"] for r in saver.history] == [0, 1]
    fam = "micro" if version == "cvpr" else "template"
    for rec in saver.history:
        assert rec["status"] == "ok"
        assert 0.0 <= rec["reward"] <= 1.0 and np.isfinite(rec["reward"])
        assert infer_family(rec["genotype"]).name == fam
        assert rec["stage1_ms"] > 0 and rec["stage2_ms"] > 0
    snap = cfg.snapshot_dir
    assert os.path.exists(os.path.join(snap, "controller.npz"))
    with open(os.path.join(snap, "search_log.jsonl")) as f:
        assert len(f.read().splitlines()) == 2
    state = json.load(open(os.path.join(snap, "search_state.json")))
    assert state["step"] == 2 and len(state["history"]) == 2
    cfg2 = SearchConfig(**{**cfg.__dict__, "num_iters": 3, "resume": True})
    saver2 = ts.run_search(cfg2, dataset=_dataset(cfg), device="cpu")
    assert [r["step"] for r in saver2.history] == [0, 1, 2]
    assert saver2.history[:2] == saver.history


def test_run_search_scores_an_invalid_genotype(tmp_path, monkeypatch):
    real = ts.sample_genotype

    def invalid_first(agent, gen):
        g, a, lp, ent = real(agent, gen)
        if not invalid_first.done:
            invalid_first.done = True
            g = [[99] + g[0][1:], g[1]]
        return g, a, lp, ent
    invalid_first.done = False
    monkeypatch.setattr(ts, "sample_genotype", invalid_first)
    cfg = _search_cfg(tmp_path, invalid_reward=0.05, ctrl_algo="reinforce")
    saver = ts.run_search(cfg, dataset=_dataset(cfg), device="cpu")
    first, second = saver.history
    assert first["status"].startswith("invalid: ")
    assert first["reward"] == 0.05 and first["miou1"] == 0.0
    assert second["status"] == "ok"
    # the invalid sample still moved the baseline: 0.05 * (1 - 0.95)
    assert first["baseline"] == pytest.approx(0.05 * 0.05, rel=1e-6)


def test_run_search_distils_a_teacher(tmp_path, monkeypatch):
    """With do_kd and a teacher, every stage-1 cached batch carries the
    teacher's logits of its crops and every stage-2 batch gets them."""
    import segtpu_torch.engine.trainer as trainer
    seen = []
    real = trainer.segmentation_loss

    def spy(*args, teacher_logits=None, kd_coeff=0.0, **kw):
        seen.append((teacher_logits is not None, kd_coeff))
        return real(*args, teacher_logits=teacher_logits, kd_coeff=kd_coeff,
                    **kw)
    monkeypatch.setattr(trainer, "segmentation_loss", spy)
    teacher = SegmenterNet(ARCHS["arch2"], K,
                           generator=torch.Generator().manual_seed(1))
    cfg = _search_cfg(tmp_path, num_iters=1, do_kd=True, kd_coeff=0.5)
    saver = ts.run_search(cfg, dataset=_dataset(cfg), teacher=teacher,
                          device="cpu")
    assert saver.history[0]["status"] == "ok"
    assert len(seen) == 2 + 1 and set(seen) == {(True, 0.5)}


def _jax_ctrl_params(seed=0):
    return _np_tree(jax_controller_init(jax.random.PRNGKey(seed), JaxSpec()))


def test_saver_snapshots_load_in_both_packages(tmp_path):
    jp = _jax_ctrl_params(1)
    port = SearchSaver(str(tmp_path / "port"))
    port.record(0, ARCHS["arch0"], 0.25, {"status": "ok"})
    port.save(1, load_jax_controller(jp), 0.125)
    step, params, baseline = JaxSearchSaver(str(tmp_path / "port")).load(
        _jax_ctrl_params(2))
    assert (step, baseline) == (1, 0.125)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), b)
    ref = JaxSearchSaver(str(tmp_path / "jax"))
    ref.record(0, ARCHS["arch1"], 0.5, {"status": "ok"})
    ref.save(1, jp, 0.25)
    template = load_jax_controller(_jax_ctrl_params(3))
    back = SearchSaver(str(tmp_path / "jax"))
    step, params, baseline = back.load(template)
    assert (step, baseline) == (1, 0.25) and back.history == ref.history
    for a, b in zip(jax.tree.leaves(controller_to_jax(params)),
                    jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)
    assert params["lstm"]["wx"].dtype == torch.float32
    assert back.best(1)[0]["reward"] == 0.5


def test_search_resumes_across_packages(tmp_path):
    """A JAX snapshot at step 2 resumes in the port's run_search, and the
    port's final snapshot resumes in JAX's run_search (which has no step
    left to take and saves what it loaded)."""
    cfg = _search_cfg(tmp_path, num_iters=3, resume=True)
    ref = JaxSearchSaver(cfg.snapshot_dir)
    for step in (0, 1):
        ref.record(step, ARCHS["arch2"], 0.1 * step, {"status": "ok"})
    ref.save(2, _jax_ctrl_params(4), 0.05)
    saver = ts.run_search(cfg, dataset=_dataset(cfg), device="cpu")
    assert [r["step"] for r in saver.history] == [0, 1, 2]
    assert saver.history[:2] == ref.history
    with np.load(os.path.join(cfg.snapshot_dir, "controller.npz")) as f:
        port_final = {k: f[k] for k in f.files}
    jcfg = JaxSearchConfig(**{**cfg.__dict__, "crop_size": (32, 32)})
    jsaver = js.run_search(jcfg, dataset=jds.SyntheticDataset(
        n=4, hw=CROP, num_classes=K, seed=7))
    assert [r["step"] for r in jsaver.history] == [0, 1, 2]
    with np.load(os.path.join(cfg.snapshot_dir, "controller.npz")) as f:
        assert sorted(f.files) == sorted(port_final)
        for k in f.files:
            np.testing.assert_array_equal(f[k], port_final[k])


# ------------------------------------------------------------ the CLI


@pytest.mark.parametrize("argv,fn_name", [
    (["search", "--synthetic", "--num-iters", "1"], "cmd_search"),
    (["search", "--supernet", "4", "--ctrl-version", "wacv"], "cmd_search"),
    (["search", "--supernet", "8", "--pop-devices", "4"], "cmd_search"),
    (["search", "--fleet", "--ctrl-algo", "reinforce"], "cmd_search"),
    (["train", "--synthetic", "--num-epochs", "1"], "cmd_train"),
    (["eval", "--data-root", "d", "--val-list", "v.lst"], "cmd_eval"),
    (["infer", "--image", "x.png", "--arch", "arch1"], "cmd_infer"),
    (["bench", "--arch", "arch2"], "cmd_bench"),
])
def test_subcommands_parse(argv, fn_name, monkeypatch):
    captured = {}

    def fake(args):
        captured["fn"], captured["args"] = fn_name, args

    monkeypatch.setattr(tmain, fn_name, fake)
    tmain.main(argv)
    assert captured["fn"] == fn_name
    assert captured["args"].device == "cuda"


@pytest.mark.parametrize("argv", [
    ["fidelity", "--arch", "arch0"],       # without its required --golden
    ["explode"]])
def test_unported_and_bad_subcommands_rejected(argv):
    with pytest.raises(SystemExit):
        tmain.main(argv)


def test_search_flag_mapping():
    """The reference's flag names map into the port's SearchConfig, whose
    fields and defaults are the JAX package's."""
    import argparse
    import dataclasses
    assert ([(f.name, f.default) for f in dataclasses.fields(SearchConfig)]
            == [(f.name, f.default)
                for f in dataclasses.fields(JaxSearchConfig)])
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd")
    tmain._add_search_flags(sub.add_parser("search"))
    args = ap.parse_args([
        "search", "--dec-aux-weight", "0.4", "--ctrl-baseline-decay", "0.9",
        "--lstm-hidden-size", "64", "--meta-train-prct", "0.8",
        "--crop-size", "128", "96", "--num-epochs", "3", "2",
        "--do-kd", "--kd-coeff", "0.7", "--agg-size", "32",
        "--sep-repeats", "2"])
    cfg = tmain._cfg_from_args(args)
    assert cfg.dec_aux_weight == 0.4 and cfg.ctrl_baseline_decay == 0.9
    assert cfg.lstm_hidden_size == 64 and cfg.meta_train_prct == 0.8
    assert cfg.crop_size == (128, 96) and cfg.num_epochs == (3, 2)
    assert cfg.do_kd and cfg.kd_coeff == 0.7
    assert (cfg.agg_size, cfg.sep_repeats) == (32, 2)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flags,mode", [
    (["--supernet", "4", "--ctrl-version", "wacv"], "supernet"),
    (["--supernet", "8", "--pop-devices", "4"], "mesh"),
    (["--fleet", "--ctrl-algo", "reinforce"], "fleet")])
def test_search_modes_dispatch(monkeypatch, flags, mode):
    """--supernet reaches run_supernet_search with K and no mesh,
    --pop-devices a (D, 1) mesh of D logical CPU devices, --fleet
    run_fleet_search on one CPU worker; each with the flags' config."""
    import segtpu_torch.parallel.fleet as tfleet
    import segtpu_torch.supernet as tsn
    seen = {}

    def supernet(cfg, *, population, mesh, device):
        seen.update(cfg=cfg, k=population, mesh=mesh, device=device)
        raise _Stop

    def fleet(cfg, *, devices):
        seen.update(cfg=cfg, devices=devices)
        raise _Stop

    monkeypatch.setattr(tsn, "run_supernet_search", supernet)
    monkeypatch.setattr(tfleet, "run_fleet_search", fleet)
    with pytest.raises(_Stop):
        tmain.main(["search", "--synthetic", "--device", "cpu"] + flags)
    if mode == "fleet":
        assert seen["devices"] == [torch.device("cpu")]
        assert seen["cfg"].ctrl_algo == "reinforce"
        return
    assert seen["k"] == int(flags[1]) and seen["device"] == "cpu"
    if mode == "supernet":
        assert seen["mesh"] is None and seen["cfg"].ctrl_version == "wacv"
    else:
        assert seen["mesh"].shape == {"data": 4, "space": 1}
        assert seen["mesh"].devices == [torch.device("cpu")] * 4


def test_pop_devices_on_one_card_raises(monkeypatch):
    """--pop-devices 2 on a machine with one card: make_mesh's
    ValueError, naming the counts, before any search work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        tmain.main(["search", "--synthetic", "--supernet", "8",
                    "--pop-devices", "2"])


def test_supernet_cli_runs_on_the_cpu(tmp_path, capsys):
    """search --supernet 2 --pop-devices 2 --device cpu: one sharded
    round end to end, its snapshot written and its best printed."""
    tmain.main(["search", "--synthetic", "--supernet", "2", "--pop-devices",
                "2", "--num-iters", "1", "--crop-size", "32", "32",
                "--batch-size", "8", "8", "--num-epochs", "1", "0",
                "--num-classes", "4", "--agg-size", "8", "--device", "cpu",
                "--snapshot-dir", str(tmp_path)])
    assert "best reward" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "controller.npz")


def test_search_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main(["search", "--synthetic", "--num-iters", "1"])


def test_train_passes_shorter_side(monkeypatch, tmp_path):
    import segtpu_torch.train as ttrain
    from segtpu_torch.data.transforms import ResizeShorterScale
    captured = {}

    def fake(genotype, train_loader, val_loader, cfg, *, device):
        captured.update(genotype=genotype, train=train_loader,
                        val=val_loader, cfg=cfg, device=device)
        return 0.5, None

    monkeypatch.setattr(ttrain, "run_training", fake)
    tmain.main(["train", "--synthetic", "--crop-size", "32", "32",
                "--shorter-side", "40", "--batch-size", "2",
                "--snapshot-dir", str(tmp_path), "--device", "cpu"])
    cfg = captured["cfg"]
    assert cfg.shorter_side == 40 and cfg.crop_size == (32, 32)
    jitter = [t for t in captured["train"].transform.transforms
              if isinstance(t, ResizeShorterScale)]
    assert [t.shorter_side for t in jitter] == [40]
    assert captured["genotype"] == ARCHS["arch0"]
    assert captured["device"] == "cpu"


def test_infer_and_eval_on_the_cpu(tmp_path, capsys):
    """infer: the mask of a torch checkpoint's weights equals the
    engine's predict on them; eval over a .lst of .npy pairs: the mIoU
    of make_eval_step on the same weights."""
    from segtpu_torch.utils.metrics import mean_iou
    genotype, k = ARCHS["arch0"], 5
    p, s = _np_tree(segmenter_init(jax.random.PRNGKey(1), genotype,
                                   num_classes=k))
    p, s = perturb_bn(p, s, np.random.default_rng(1))
    model = load_jax_params(SegmenterNet(
        genotype, k, generator=torch.Generator().manual_seed(0)), p, s)
    ckpt = str(tmp_path / "arch0.ckpt")
    torch.save(model.state_dict(), ckpt)
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
    np.save(tmp_path / "frame.npy", img)
    out = str(tmp_path / "mask.npy")
    tmain.main(["infer", "--image", str(tmp_path / "frame.npy"), "--ckpt",
                ckpt, "--num-classes", str(k), "--output", out,
                "--device", "cpu"])
    want = Engine(model, device="cpu").predict(img)
    np.testing.assert_array_equal(np.load(out), want)
    lines = []
    for i in range(3):
        np.save(tmp_path / f"i{i}.npy", rng.integers(0, 256, (32, 32, 3))
                .astype(np.uint8))
        np.save(tmp_path / f"m{i}.npy", rng.integers(0, k, (32, 32))
                .astype(np.uint8))
        lines.append(f"i{i}.npy m{i}.npy")
    (tmp_path / "val.lst").write_text("\n".join(lines))
    capsys.readouterr()
    tmain.main(["eval", "--data-root", str(tmp_path), "--val-list",
                str(tmp_path / "val.lst"), "--ckpt", ckpt, "--num-classes",
                str(k), "--batch-size", "2", "--crop-size", "32", "32",
                "--device", "cpu"])
    printed = capsys.readouterr().out
    ds = tds.SegmentationDataset(str(tmp_path), str(tmp_path / "val.lst"))
    loader = tds.BatchLoader(ds, batch_size=2, crop=(32, 32), train=False)
    step = make_eval_step(genotype, num_classes=k)
    cm = sum(step({n: t.detach() for n, t in model.named_parameters()},
                  dict(model.named_buffers()), b).numpy() for b in loader)
    assert f"mIoU: {mean_iou(cm):.4f}" in printed


def test_port_imports_no_jax():
    """Every segtpu_torch module, and chip_smoke.py, imports without jax,
    optax or segtpu."""
    names = [m.name for m in pkgutil.walk_packages(
        segtpu_torch.__path__, "segtpu_torch.")]
    assert {"segtpu_torch.search", "segtpu_torch.main_search",
            "segtpu_torch.rl.agent", "segtpu_torch.data.datasets",
            "segtpu_torch.supernet", "segtpu_torch.parallel.fleet",
            "segtpu_torch.parallel.mesh"} <= set(names)
    code = ("import importlib, sys\n"
            f"for n in {names + ['chip_smoke']!r}:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'segtpu'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
