"""Sharded serving over several devices in one process (counterpart:
segtpu/parallel). ``mesh`` builds the device grid and the sharded
inference functions; ``collectives`` holds the halo exchange, gather
and sum over the list of per-shard tensors."""

from segtpu_torch.parallel.collectives import (  # noqa: F401
    gather_h, halo_exchange, per_device, sum_shards)
from segtpu_torch.parallel.mesh import (  # noqa: F401
    DeviceMesh, make_mesh, make_sharded_infer_fn)
