"""segtpu_torch's H-sharded tail (plain version) vs the JAX package's.

The JAX side is ``upsample_argmax_sharded`` in interpret mode under
``shard_map`` on the virtual CPU mesh, with ``tile_h=32`` as the JAX
sharded engine passes it in interpret mode. The port's side takes each
shard's logit rows between one halo row of each neighbour
(``parallel.halo_exchange``) through ``upsample_argmax_sharded_plain``.
Masks must agree on >= 99.99 % of pixels and every pixel that differs
must be a near-tie (the rule of test_torch_upsample_argmax.py: the two
sides round the same values, but the JAX dot may fuse a multiply-add).
Without JAX, every shard's rows are the bits of the unsharded plain
tail's rows.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from segtpu.core.resize import resize_bilinear as jax_resize
from segtpu.kernels.upsample_argmax import (
    upsample_argmax_sharded as jax_sharded_tail)
from segtpu.parallel.mesh import make_mesh as jax_make_mesh

from segtpu_torch.kernels.upsample_argmax import (
    upsample_argmax_plain, upsample_argmax_sharded,
    upsample_argmax_sharded_plain)
from segtpu_torch.parallel import halo_exchange

from test_torch_upsample_argmax import assert_masks_agree


def _logits(shape, dtype, seed):
    """(values both sides see as f32 numpy, the port's tensor)."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    xt = torch.from_numpy(x)
    if dtype == "bfloat16":
        xt = xt.to(torch.bfloat16)
        x = xt.float().numpy()
    return x, xt


def _port_sharded(xt, out_hw, n, align_corners, fn=upsample_argmax_sharded_plain):
    ext = halo_exchange(list(xt.chunk(n, dim=2)), 1, 1)
    return torch.cat([fn(e, out_hw, shard=s, n_shards=n,
                         align_corners=align_corners)
                      for s, e in enumerate(ext)], dim=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("n,k", [(2, 5), (4, 19)])
def test_sharded_tail_matches_pallas_kernel(dtype, align_corners, n, k):
    shape, out_hw = (2, k, 16, 24), (64, 96)
    x, xt = _logits(shape, dtype, seed=n + k)
    mesh = jax_make_mesh(1, n)
    local = functools.partial(
        jax_sharded_tail, out_hw=out_hw, axis_name="space", n_shards=n,
        align_corners=align_corners, tile_h=32, interpret=True)
    mapped = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(None, None, "space", None),
        out_specs=P(None, "space", None), check_vma=False))
    want = np.asarray(mapped(jnp.asarray(x, getattr(jnp, dtype))))
    got = _port_sharded(xt, out_hw, n, align_corners).numpy()
    assert got.dtype == np.uint8 and got.shape == (2, *out_hw)
    up = np.asarray(jax_resize(jnp.asarray(np.transpose(x, (0, 2, 3, 1))),
                               out_hw, align_corners=align_corners))
    assert_masks_agree(got, want, np.transpose(up, (0, 3, 1, 2)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("shape,out_hw,n", [
    ((2, 5, 16, 24), (64, 96), 2),
    ((1, 19, 16, 24), (64, 96), 4),
    ((1, 7, 8, 12), (64, 40), 8),        # one logit row per shard
    ((1, 3, 12, 10), (30, 33), 3),       # non-integer scale
])
def test_shard_rows_are_the_unsharded_rows(dtype, align_corners, shape,
                                           out_hw, n):
    _, xt = _logits(shape, dtype, seed=7)
    want = upsample_argmax_plain(xt, out_hw, align_corners=align_corners)
    before = upsample_argmax_sharded.launches
    # through the wrapper: on a CPU tensor it runs the plain version
    got = _port_sharded(xt, out_hw, n, align_corners,
                        fn=upsample_argmax_sharded)
    assert upsample_argmax_sharded.launches == before
    assert torch.equal(got, want)


def test_mesh_end_halo_is_never_read():
    """NaN in place of the mesh ends' zero halo rows changes nothing."""
    _, xt = _logits((1, 5, 16, 24), "float32", seed=3)
    ext = halo_exchange(list(xt.chunk(4, dim=2)), 1, 1)
    ext[0][:, :, 0] = float("nan")
    ext[-1][:, :, -1] = float("nan")
    got = torch.cat([upsample_argmax_sharded_plain(e, (64, 96), shard=s,
                                                   n_shards=4)
                     for s, e in enumerate(ext)], dim=1)
    assert torch.equal(got, upsample_argmax_plain(xt, (64, 96)))


def test_sharded_tail_rejects_bad_calls():
    x = torch.zeros(1, 4, 6, 8)                    # 4 local rows + 2 halo
    with pytest.raises(ValueError, match="divide"):
        upsample_argmax_sharded(x, (66, 32), shard=0, n_shards=4)
    with pytest.raises(ValueError, match="shard"):
        upsample_argmax_sharded(x, (64, 32), shard=4, n_shards=4)
    with pytest.raises(ValueError):
        upsample_argmax_sharded(x.half(), (64, 32), shard=0, n_shards=4)
    with pytest.raises(ValueError, match="local row"):
        upsample_argmax_sharded(torch.zeros(1, 4, 2, 8), (64, 32), shard=0,
                                n_shards=4)
