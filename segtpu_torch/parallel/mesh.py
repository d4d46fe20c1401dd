"""Device meshes, sharded inference and data-parallel training in one
process (counterpart: segtpu/parallel/mesh.py).

The JAX package shards with ``shard_map`` over a ``jax.sharding.Mesh``.
PyTorch's idiom here is explicit: one process holds every device, a
mesh is a (data, space) grid of ``torch.device``s, and a sharded
function loops over them (``parallel.collectives``). A device may appear
several times in the grid: n logical shards on one card, the
counterpart of the JAX tests' virtual CPU mesh, which runs every halo
exchange, crop and per-shard band for real, one shard after another.
There is no ``torch.distributed`` here.

Data-parallel training splits the batch over the ``data`` axis
(``shard_batch``) and keeps one set of weights. Its step
(``make_sharded_train_step``) is the unsharded step on the whole batch
up to rounding, as the JAX package's is: BatchNorm's moments, the loss
and the gradients are the whole batch's. The ``space`` axis of training
is not ported.

The supernet's population steps shard the population: each device of
the mesh's ``data`` axis holds K/data samples (``shard_population``)
and runs the unsharded step on its slice, with no collectives; the
per-sample outputs are gathered onto the mesh's first device in K
order (``make_sharded_population_step``/``_eval``).
"""

from __future__ import annotations

import contextlib
import copy
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np
import torch

from segtpu_torch.core.layers import ShardGroup, shard_context


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


def _data_only(mesh: DeviceMesh) -> List[torch.device]:
    """The ``data`` axis's devices of a mesh whose ``space`` axis is 1."""
    if mesh.shape["space"] != 1:
        raise ValueError(
            f"sharded training splits the batch over the 'data' axis only; "
            f"a mesh with space = {mesh.shape['space']} is not ported (see "
            f"ROADMAP.md Queue A, the space axis of sharded training)")
    return _data_devices(mesh)


def shard_batch(mesh: DeviceMesh, batch) -> List[dict]:
    """A batch dict cut along N over the mesh's ``data`` axis: one dict a
    device, in row order, with its rows of ``image``, ``label`` and the
    optional ``teacher`` on that device (numpy or tensors in, tensors
    out; other entries as they are). N must divide by the ``data`` axis,
    else ``ValueError``; a mesh with ``space`` > 1 raises too. The JAX
    package returns one array sharded over the mesh; here the shards are
    a list, as PyTorch has no sharded tensor."""
    devices = _data_only(mesh)
    n = len(batch["image"])
    if n % len(devices):
        raise ValueError(f"batch {n} must divide the data axis "
                         f"{len(devices)}")
    per = n // len(devices)
    out = []
    for r, dev in enumerate(devices):
        part = dict(batch)
        for key in ("image", "label", "teacher"):
            if key in batch:
                part[key] = torch.as_tensor(
                    batch[key])[r * per:(r + 1) * per].to(dev)
        out.append(part)
    return out


def make_sharded_train_step(step_fn, mesh: DeviceMesh):
    """-> ``step(state, batch) -> (state, loss)``: ``step_fn`` (a
    ``make_train_step`` step, whose ``StepParts`` it reads) with the
    batch (the unsharded step's dict) split over the mesh's ``data`` axis
    by ``shard_batch``: up to rounding, the unsharded step on the whole
    batch.

    The state keeps one set of weights (``TrainState`` holds the module;
    the JAX package replicates a pytree). Each shard runs a skeleton of
    the model (a copy on the meta device) by ``torch.func.functional_call``
    on the state's weights moved to its device, in a thread of its own
    (the step keeps one a shard, shut down when the step is collected);
    the shards meet at each train BatchNorm (``core.layers.shard_context``),
    which normalizes with the whole batch's moments and moves the running
    stats once. The loss is every shard's NLL sums over the global counts
    (``combine_loss_terms``). All of it is one autograd graph: one
    backward of that loss gives the whole batch's gradients on the state's
    weights, the optimizer's clip reads their norm, and the update and
    Polyak run once. Nothing waits inside the backward, so logical shards
    on one card (``[cuda:0] * n``) do not deadlock in autograd's one
    worker thread for that card. A mesh with ``space`` > 1 raises
    ``ValueError``."""
    from segtpu_torch.engine.trainer import (_check_genotype,
                                             combine_loss_terms)
    parts = getattr(step_fn, "parts", None)
    if parts is None:
        raise TypeError("make_sharded_train_step shards a make_train_step "
                        "step (one that carries its StepParts)")
    devices = _data_only(mesh)
    skeletons = []     # [model, its skeleton for each shard]
    # one long-lived thread a shard: PyTorch keeps cuDNN's convolution
    # plans per thread, and a new thread each step would plan them anew
    workers = ThreadPoolExecutor(max_workers=len(devices),
                                 thread_name_prefix="segtpu-shard")

    def skeleton(model):
        if not skeletons or skeletons[0] is not model:
            skeletons[:] = [model, [copy.deepcopy(model).to("meta")
                                    for _ in devices]]
        return skeletons[1]

    def step(state, batch):
        model = state.model
        _check_genotype(model, parts.genotype)
        shards = shard_batch(mesh, batch)
        model.train()
        params = dict(model.named_parameters())
        buffers = dict(model.named_buffers())
        # rank 0 moves the running stats: into the state's own buffers,
        # or copies of them on its device, written back below
        buffers0 = {k: b.to(devices[0]) for k, b in buffers.items()}
        group = ShardGroup(len(devices))

        def run(r, skel, dev, shard):
            try:
                tensors = {k: p.to(dev) for k, p in params.items()}
                tensors.update(buffers0 if r == 0 else
                               {k: b.to(dev) for k, b in buffers.items()})
                skel.train()

                def forward(*args, **kwargs):
                    return torch.func.functional_call(skel, tensors, args,
                                                      kwargs)

                on_dev = (torch.cuda.device(dev) if dev.type == "cuda"
                          else contextlib.nullcontext())
                with on_dev, shard_context(group, r):
                    return parts.terms(forward, shard, dev)
            except BaseException:
                # the other shards' waits raise instead of hanging
                group.abort()
                raise

        futures = [workers.submit(run, *a) for a in zip(
            range(len(devices)), skeleton(model), devices, shards)]
        failed = [e for e in (f.exception() for f in futures)
                  if e is not None]
        if failed:
            # the first failure, not the others' broken barriers
            raise next((e for e in failed
                        if not isinstance(e, threading.BrokenBarrierError)),
                       failed[0])
        terms = [f.result() for f in futures]
        with torch.no_grad():
            for k, b in buffers.items():
                if buffers0[k] is not b:
                    b.copy_(buffers0[k])
        loss = combine_loss_terms(terms, devices[0])
        return parts.update(state, loss), loss.detach()

    weakref.finalize(step, workers.shutdown, wait=False)
    return step


def make_sharded_eval_step(eval_step, mesh: DeviceMesh):
    """-> ``eval(params, stats, batch) -> [K, K]``: ``eval_step`` (a
    ``make_eval_step`` step) on each shard of ``shard_batch`` with the
    maps moved to the shard's device, the confusion matrices summed in
    shard order onto the mesh's first device: the unsharded matrix,
    exactly. A mesh with ``space`` > 1 raises ``ValueError``."""
    devices = _data_only(mesh)

    def run(params, stats, batch):
        total = None
        for dev, shard in zip(devices, shard_batch(mesh, batch)):
            cm = eval_step({k: p.to(dev) for k, p in params.items()},
                           {k: s.to(dev) for k, s in stats.items()},
                           shard).to(devices[0])
            total = cm if total is None else total + cm
        return total

    return run
