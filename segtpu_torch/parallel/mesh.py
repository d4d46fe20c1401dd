"""Device meshes and sharded inference in one process (counterpart:
segtpu/parallel/mesh.py::make_mesh, make_sharded_infer_fn and
make_sharded_pallas_infer_fn).

The JAX package shards with ``shard_map`` over a ``jax.sharding.Mesh``.
PyTorch's idiom here is explicit: one process holds every device, a
mesh is a (data, space) grid of ``torch.device``s, and a sharded
function loops over them (``parallel.collectives``). A device may appear
several times in the grid: n logical shards on one card, the
counterpart of the JAX tests' virtual CPU mesh, which runs every halo
exchange, crop and per-shard band for real, one shard after another.
There is no ``torch.distributed`` here; sharded training is not ported
yet.

The supernet's population steps shard the population: each device of
the mesh's ``data`` axis holds K/data samples (``shard_population``)
and runs the unsharded step on its slice, with no collectives; the
per-sample outputs are gathered onto the mesh's first device in K
order (``make_sharded_population_step``/``_eval``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


class DeviceMesh:
    """A (data, space) grid of devices, row-major."""

    def __init__(self, grid: List[List[torch.device]]):
        self.grid = grid
        self.shape = {"data": len(grid), "space": len(grid[0])}
        self.size = self.shape["data"] * self.shape["space"]

    @property
    def devices(self) -> List[torch.device]:
        """Every device of the grid in row-major order."""
        return [d for row in self.grid for d in row]


def make_mesh(data: int, space: int = 1, *,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A (data, space) mesh of the first ``data * space`` of ``devices``
    (default: every CUDA device). Too few devices raise ``ValueError``.
    A caller may repeat a device (``[torch.device("cuda:0")] * 4``) or
    pass CPU devices, as the tests do."""
    if data < 1 or space < 1:
        raise ValueError(f"mesh axes must be >= 1, got {(data, space)}")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    need = data * space
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return DeviceMesh([devices[r * space:(r + 1) * space]
                       for r in range(data)])


def make_sharded_infer_fn(seg, mesh: DeviceMesh, *, mode: str = "data"):
    """Shard the serving engine ``seg`` (``engine.Segmenter``) over the
    mesh. Returns ``run(imgs_u8)``: uint8 [N, H, W, 3] -> uint8 masks
    [N, H, W]; numpy in gives numpy out, a tensor in gives a tensor on
    the mesh's first device.

    mode='data' — the batch is cut into ``mesh.size`` equal parts and
      every device runs the whole engine on its part; N must divide by
      the mesh size. Masks are those of the unsharded engine bit for bit.
    mode='space' — every frame is cut along H over the mesh's 'space'
      axis and the batch is not split (a mesh with data = 1): the
      counterpart of ``make_sharded_pallas_infer_fn``, see
      ``engine.ShardedSegmenter``. The JAX package's other 'space' mode
      hands an unsharded program to XLA's GSPMD partitioner; PyTorch has
      no partitioner, so that mode has no counterpart here.
    """
    if mode == "data":
        devices = mesh.devices
        replicas = [seg.replica(d) for d in devices]

        def run(img_u8):
            as_numpy = not isinstance(img_u8, torch.Tensor)
            imgs = torch.from_numpy(np.ascontiguousarray(
                img_u8, dtype=np.uint8)) if as_numpy else img_u8
            if imgs.ndim != 4:
                raise ValueError(f"sharded inference takes [N, H, W, 3], "
                                 f"got {tuple(imgs.shape)}")
            if imgs.shape[0] % mesh.size:
                raise ValueError(f"batch {imgs.shape[0]} must divide mesh "
                                 f"size {mesh.size}")
            per = imgs.shape[0] // mesh.size
            parts = [rep.infer(imgs[i * per:(i + 1) * per].to(dev))
                     for i, (rep, dev) in enumerate(zip(replicas, devices))]
            out = torch.cat([p.to(devices[0]) for p in parts], dim=0)
            return out.cpu().numpy() if as_numpy else out

        return run

    if mode == "space":
        if mesh.shape["data"] != 1:
            raise ValueError(
                f"mode='space' does not split the batch: it takes a "
                f"(1, n) mesh, got {mesh.shape}")
        from segtpu_torch.engine.inference import ShardedSegmenter
        return ShardedSegmenter(seg, mesh.grid[0]).predict

    raise ValueError(f"unknown mode {mode!r} (use 'data' or 'space')")


class PopShards(list):
    """A supernet population split over a mesh's ``data`` axis: one
    ``supernet.PopState`` a device, in K order. ``eval_params()`` and
    ``stats`` give the shards' maps, as the sharded eval takes them."""

    def eval_params(self):
        return [p.eval_params() for p in self]

    @property
    def stats(self):
        return [p.stats for p in self]

    @property
    def step(self) -> int:
        return self[0].step


def _data_devices(mesh: DeviceMesh) -> List[torch.device]:
    """One device a row of the ``data`` axis (the row's first)."""
    return [row[0] for row in mesh.grid]


def shard_population(mesh: DeviceMesh, pop, masks):
    """-> (``PopShards``, one mask map a shard): sample k of the
    population (a ``supernet.PopState``) and of its K-stacked masks goes
    to the data row k // (K / data); the shared step is replicated. Every
    leaf's K must divide by the ``data`` axis, else ``ValueError``."""
    devices = _data_devices(mesh)
    data = len(devices)
    trees = [t for t in (pop.params, pop.stats, pop.opt_state, pop.polyak,
                         masks) if t is not None]
    for t in trees:
        for name, x in t.items():
            if x.shape[0] % data:
                raise ValueError(f"population {x.shape[0]} ({name}) not "
                                 f"divisible by data={data}")
    per = pop.k // data

    def part(tree, r):
        return None if tree is None else {
            n: x[r * per:(r + 1) * per].to(devices[r])
            for n, x in tree.items()}

    return (PopShards(pop._replace(params=part(pop.params, r),
                                   stats=part(pop.stats, r),
                                   opt_state=part(pop.opt_state, r),
                                   polyak=part(pop.polyak, r))
                      for r in range(data)),
            [part(masks, r) for r in range(data)])


def gather_population(shards):
    """The shards of ``shard_population`` as one ``PopState`` on the
    first shard's device."""
    dev = shards[0].params[next(iter(shards[0].params))].device

    def cat(trees):
        return None if trees[0] is None else {
            n: torch.cat([t[n].to(dev) for t in trees]) for n in trees[0]}

    return shards[0]._replace(
        **{f: cat([getattr(p, f) for p in shards])
           for f in ("params", "stats", "opt_state", "polyak")})


def make_sharded_population_step(step_fn, mesh: DeviceMesh):
    """-> ``step(shards, masks, batch) -> (shards, losses [K])``: the
    unsharded population step ``step_fn(pop, masks, batch)`` on each
    shard of ``shard_population`` in turn (each moves the shared batch to
    its device), no collectives; the losses gathered onto the mesh's
    first device in K order. Logical shards on one device run one after
    another, as every sharded path here does."""
    dev0 = mesh.devices[0]

    def step(shards, masks, batch):
        outs = [step_fn(p, m, batch) for p, m in zip(shards, masks)]
        return (PopShards(o[0] for o in outs),
                torch.cat([o[1].to(dev0) for o in outs]))

    return step


def make_sharded_population_eval(eval_fn, mesh: DeviceMesh):
    """-> ``eval(params, stats, masks, batch) -> [K, C, C]``: the
    unsharded population eval on each shard's maps (lists, as
    ``PopShards.eval_params()`` and ``.stats`` give them), the confusion
    matrices gathered onto the mesh's first device in K order."""
    dev0 = mesh.devices[0]

    def run(params, stats, masks, batch):
        return torch.cat([eval_fn(p, s, m, batch).to(dev0)
                          for p, s, m in zip(params, stats, masks)])

    return run
