"""segtpu_torch's population search loops on the CPU: the supernet
search (micro, template, K-sharded over a mesh of logical CPU devices),
the mesh's population steps, the fleet and ``measure_proxy_fidelity``.

* The sharded population step and eval on ``[cpu] * 2`` equal the
  unsharded ones (losses, every state leaf, confusion matrices) over two
  steps; a K the ``data`` axis does not divide raises.
* One round of ``run_supernet_search`` for cvpr/REINFORCE and
  wacv/REINFORCE and one sharded round: K records, ``mode`` supernet,
  rewards in [0, 1], the round's seconds and stage-1 ms, the snapshot
  loads; the sharded round's rewards equal the unsharded round's.
* ``run_fleet_search`` on ``[cpu] * 2`` (two worker threads): its
  rewards equal ``search.proxy_train`` run one genotype after another on
  fresh loaders with the same genotypes and seeds.
* ``measure_proxy_fidelity`` at a small size, sampled and fixed
  genotypes, with and without the supernet.

Shapes are the JAX tests' (SearchConfig at 32x32 crops, batch 4, 4
classes, agg_size 8 or 16), one torch thread.
"""

import dataclasses

import numpy as np
import pytest
import torch

from segtpu_torch import search as S
from segtpu_torch import supernet as sn
from segtpu_torch.config import SearchConfig
from segtpu_torch.data.datasets import SyntheticDataset
from segtpu_torch.models.encoders import MBV2_TAP_CHANNELS
from segtpu_torch.parallel.fleet import run_fleet_search
from segtpu_torch.parallel.mesh import (gather_population, make_mesh,
                                        make_sharded_population_eval,
                                        make_sharded_population_step,
                                        shard_population)
from segtpu_torch.rl import controller as ctrl
from segtpu_torch.utils.saver import SearchSaver
from segtpu_torch.utils.solvers import PopulationSGD

CPU2 = [torch.device("cpu")] * 2
# eight synthetic 32x32 images: two cached train batches and one val
DATA = dict(n=8, hw=(32, 32), num_classes=4, seed=5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread while this module runs, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _exact_convolutions():
    was = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = was


def _cfg(tmp_path, name, **kw):
    return SearchConfig(**{**dict(
        synthetic=True, num_classes=4, crop_size=(32, 32), batch_size=(4, 4),
        num_epochs=(1, 0), num_iters=1, ctrl_algo="reinforce", agg_size=8,
        snapshot_dir=str(tmp_path / name), seed=5), **kw})


def test_sharded_population_step_matches_unsharded():
    spec = sn.SupernetSpec(num_classes=4, agg_size=8)
    k = 4
    pop = sn.population_init(torch.Generator().manual_seed(0), spec,
                             MBV2_TAP_CHANNELS, k, do_polyak=True,
                             device="cpu")
    cspec = ctrl.MicroControllerSpec()
    cp = ctrl.controller_init(torch.Generator().manual_seed(1), cspec)
    masks = sn.masks_from_actions(torch.stack([
        ctrl.sample(cp, cspec, torch.Generator().manual_seed(i))[0]
        for i in range(k)]), spec)
    rng = np.random.RandomState(0)
    batch = {"taps": [torch.from_numpy(rng.randn(2, c, 16 // s, 16 // s)
                                       .astype(np.float32))
                      for s, c in zip((1, 2, 4, 8), MBV2_TAP_CHANNELS)],
             "label": torch.from_numpy(rng.randint(0, 4, (2, 64, 64)))}
    step = sn.make_population_train_step(
        spec, PopulationSGD(0.05, momentum=0.9, clip=3.0))
    ev = sn.make_population_eval_step(spec)

    def run(pop, masks, step_fn, ev_fn):
        for _ in range(2):
            pop, losses = step_fn(pop, masks, batch)
        return pop, losses, ev_fn(pop.eval_params(), pop.stats, masks, batch)

    want_pop, want_losses, want_cms = run(pop, masks, step, ev)
    mesh = make_mesh(2, 1, devices=CPU2)
    shards, mshards = shard_population(mesh, pop, masks)
    assert len(shards) == 2 and shards[0].k == 2
    got_pop, got_losses, got_cms = run(
        shards, mshards, make_sharded_population_step(step, mesh),
        make_sharded_population_eval(ev, mesh))
    # measured: every value equal (a sample's sums do not depend on K)
    torch.testing.assert_close(got_losses, want_losses, rtol=1e-6, atol=0)
    assert (got_cms - want_cms).abs().sum() <= 0.002 * want_cms.sum()
    got_pop = gather_population(got_pop)
    assert got_pop.step == want_pop.step == 2
    for field in ("params", "stats", "opt_state", "polyak"):
        for n, t in getattr(want_pop, field).items():
            torch.testing.assert_close(getattr(got_pop, field)[n], t,
                                       rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="not divisible"):
        shard_population(make_mesh(3, 1, devices=CPU2 * 2), pop, masks)


def _check_round(saver, k, snapshot_dir):
    recs = saver.history
    assert len(recs) == k
    assert [r["step"] for r in recs] == list(range(k))
    assert all(r["mode"] == "supernet" and r["round"] == 0 for r in recs)
    assert all(0.0 <= r["reward"] <= 1.0 for r in recs)
    assert all(r["seconds"] > 0 and r["stage1_ms"] > 0 for r in recs)
    restored = SearchSaver(snapshot_dir).load(
        ctrl.controller_init(torch.Generator().manual_seed(0),
                             ctrl.MicroControllerSpec()
                             if "wacv" not in snapshot_dir else
                             ctrl.TemplateControllerSpec()))
    assert restored is not None and restored[0] == k


@pytest.mark.parametrize("version", ["cvpr", "wacv"])
def test_supernet_search_round(tmp_path, version):
    cfg = _cfg(tmp_path, version, ctrl_version=version)
    k = 3 if version == "cvpr" else 2
    saver = sn.run_supernet_search(cfg, population=k, device="cpu",
                                   dataset=SyntheticDataset(**DATA))
    _check_round(saver, k, cfg.snapshot_dir)
    family = "micro" if version == "cvpr" else "template"
    for r in saver.history:
        assert S.infer_family(r["genotype"]).name == family


def test_supernet_search_round_mesh_sharded(tmp_path):
    """Two epochs, K = 4 over two logical CPU devices: the rewards equal
    the unsharded search's on the same seeds."""
    cfg = _cfg(tmp_path, "mesh", num_epochs=(2, 0))
    saver = sn.run_supernet_search(cfg, population=4, device="cpu",
                                   dataset=SyntheticDataset(**DATA),
                                   mesh=make_mesh(2, 1, devices=CPU2))
    _check_round(saver, 4, cfg.snapshot_dir)
    plain = sn.run_supernet_search(
        dataclasses.replace(cfg, snapshot_dir=str(tmp_path / "plain")),
        population=4, device="cpu", dataset=SyntheticDataset(**DATA))
    assert ([r["genotype"] for r in saver.history]
            == [r["genotype"] for r in plain.history])
    np.testing.assert_allclose([r["reward"] for r in saver.history],
                               [r["reward"] for r in plain.history],
                               rtol=0, atol=1e-6)


def test_fleet_rewards_equal_sequential_proxy_train(tmp_path):
    """One round on two logical CPU workers (threads): every record ok,
    and each reward equal to ``proxy_train`` run alone, on fresh loaders,
    with the record's genotype and the worker's seed."""
    cfg = _cfg(tmp_path, "fleet", num_epochs=(1, 1), do_polyak=False,
               aux_cell=False, seed=3)
    data = SyntheticDataset(**DATA)
    saver = run_fleet_search(cfg, devices=CPU2, dataset=data)
    recs = saver.history
    assert len(recs) == 2
    assert [r["device"] for r in recs] == [0, 1]
    assert all(r["status"] == "ok" for r in recs)
    assert all(0.0 <= r["reward"] <= 1.0 for r in recs)
    _, enc, loaders = S.search_setup(cfg, data, None, "cpu")
    c_train = S._cache_taps(enc, loaders["cache_train"])
    c_val = S._cache_taps(enc, loaders["cache_val"])
    for i, r in enumerate(recs):
        fresh = S.search_loaders(cfg, data)
        m1, m2 = S.proxy_train(r["genotype"], enc, cfg, c_train, c_val,
                               fresh["train"], fresh["val"],
                               rng_seed=cfg.seed + i)
        assert (m1, m2) == (r["miou1"], r["miou2"])
        assert S.compute_reward(m1, m2) == r["reward"]


def test_measure_proxy_fidelity_small():
    cfg = SearchConfig(synthetic=True, num_classes=4, crop_size=(32, 32),
                       batch_size=(4, 4), num_epochs=(1, 0), agg_size=8,
                       seed=0)
    data = SyntheticDataset(**DATA)
    rho, r_pg, r_sn, genos = sn.measure_proxy_fidelity(
        cfg, k=3, dataset=data, device="cpu")
    assert len(genos) == len({repr(g) for g in genos}) == 3
    assert len(r_pg) == len(r_sn) == 3 and -1.0 <= rho <= 1.0
    assert all(0.0 <= r <= 1.0 for r in r_pg + r_sn)
    _, only, none, same = sn.measure_proxy_fidelity(
        cfg, genotypes=genos[:2], discrete_only=True, dataset=data,
        device="cpu")
    assert none is None and same == genos[:2]
    np.testing.assert_allclose(only, r_pg[:2], rtol=0, atol=0)
