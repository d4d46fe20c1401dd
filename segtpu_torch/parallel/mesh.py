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
There is no ``torch.distributed`` here; sharded training and the
population steps are not ported yet.
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
