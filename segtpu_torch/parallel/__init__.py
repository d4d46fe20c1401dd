"""Sharded serving, data-parallel training and the population search
over several devices in one process (counterpart: segtpu/parallel).
``mesh`` builds the device grid, the sharded inference functions, the
data-parallel train and eval steps and the supernet population's
sharded steps; ``collectives`` holds the halo exchange, gather and sum
over the list of per-shard tensors; ``fleet`` proxy-trains one genotype
a device."""

from segtpu_torch.parallel.collectives import (  # noqa: F401
    gather_h, halo_exchange, per_device, sum_shards)
from segtpu_torch.parallel.mesh import (  # noqa: F401
    DeviceMesh, make_mesh, make_sharded_eval_step, make_sharded_infer_fn,
    make_sharded_population_eval, make_sharded_population_step,
    make_sharded_train_step, shard_batch, shard_population)
