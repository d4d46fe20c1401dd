"""Collectives of the single-process sharded path, as plain functions
over the list of per-shard tensors (shard order = mesh order).

The JAX package runs these inside ``shard_map`` as ``ppermute``,
``all_gather`` and ``psum``. Here one process holds every shard, so a
collective is a loop of ``.to(device)`` copies: PyTorch orders a copy
between two devices after the work queued on both current streams, and
each shard's kernels then launch on its own device's current stream.
Several logical shards may share one device; what every shard of a
device would hold alike (a gathered tensor, a sum) is built once per
device and shared.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch


def per_device(devices: Sequence[torch.device], fn: Callable) -> List:
    """``fn(device)`` once per distinct device, listed per shard."""
    done = {}
    for dev in devices:
        if dev not in done:
            done[dev] = fn(dev)
    return [done[dev] for dev in devices]


def _neighbour_rows(xs, s: int, rows: int, above: bool):
    """``rows`` rows of shard s's neighbour on s's device: the last rows
    of shard s-1 (``above``) or the first of shard s+1; zeros past the
    ends of the mesh."""
    x, nb = xs[s], s - 1 if above else s + 1
    if not 0 <= nb < len(xs):
        return x.new_zeros((*x.shape[:-2], rows, x.shape[-1]))
    if xs[nb].shape[-2] < rows:
        raise ValueError(f"a halo of {rows} rows reaches past shard {nb}, "
                         f"which holds {xs[nb].shape[-2]}")
    piece = xs[nb][..., -rows:, :] if above else xs[nb][..., :rows, :]
    return piece.to(x.device)


def halo_exchange(xs: Sequence[torch.Tensor], up: int, dn: int, *,
                  ends: bool = True):
    """Extend each shard of an H-sharded [..., h_s, W] tensor with ``up``
    rows of the shard above (the last rows of shard s-1) and ``dn`` rows
    of the shard below (the first rows of shard s+1). The first shard's
    upper and the last shard's lower halo are zeros, the zero padding an
    unsharded convolution would read there (counterpart:
    segtpu/models/fast_encoder.py::_halo_exchange). The result is
    contiguous. A halo reaches one neighbour only: more rows than a
    neighbour holds raises.

    ``ends=False`` leaves those zero rows out: the first shard gets no
    upper and the last no lower halo, so a kernel's own edge handling
    falls on the edge of the image. That is what a kernel needs which
    pads an intermediate and not its input (the inverted residual pads
    its expanded tensor: an input row of zeros would expand to
    relu6(bias), not to padding)."""
    if up < 0 or dn < 0:
        raise ValueError(f"halo rows must be >= 0, got {up}, {dn}")
    if not (up or dn):
        return list(xs)
    out = []
    for s, x in enumerate(xs):
        parts = [_neighbour_rows(xs, s, up, True)] \
            if up and (ends or s > 0) else []
        parts.append(x)
        if dn and (ends or s < len(xs) - 1):
            parts.append(_neighbour_rows(xs, s, dn, False))
        out.append(torch.cat(parts, dim=-2) if len(parts) > 1 else x)
    return out


def gather_h(xs: Sequence[torch.Tensor]):
    """All-gather along H: every shard gets the shards' rows
    concatenated in shard order, on its own device."""
    return per_device([x.device for x in xs], lambda dev: torch.cat(
        [x.to(dev) for x in xs], dim=-2))


def sum_shards(xs: Sequence[torch.Tensor]):
    """All-reduce: the shards' tensors (f32 partials) added in shard
    order, one rounded add each, on every shard's device."""
    def total(dev):
        acc = xs[0].to(dev)
        for x in xs[1:]:
            acc = acc + x.to(dev)
        return acc
    return per_device([x.device for x in xs], total)
