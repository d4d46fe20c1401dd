"""Shard groups and row bands: the meetings of sharded training
(``parallel.mesh.make_sharded_train_step`` and ``make_sharded_eval_step``;
counterpart: the reductions, halo exchanges and gathers that XLA's SPMD
partitioner inserts for the JAX package's ``P("data", "space", None,
None)`` placement in segtpu/parallel/mesh.py).

A sharded step runs each shard of its mesh in a thread of its own under
``shard_context``, which names the shard's two groups: the whole mesh,
where train BatchNorm meets for the whole batch's moments
(``core.layers.bn_train``), and its row, the shards of its data row along
the ``space`` axis. Inside a row of more than one shard every activation
[..., H, W] is banded by one rule: shard s of n holds the global rows
[s*H//n, (s+1)*H//n) (a band is empty where H < n). PyTorch has no
partitioner, so each op that reads across rows is band-aware here:

* ``conv2d``: a convolution with k > 1 or a stride computes its own
  output band from the global height and gathers the input rows that
  band reads (``Bands.rows``: from any shard, zeros outside the image),
  then convolves them with padding on W only;
* ``mean_hw``: the global average pool, the row's f32 sums over the
  global H*W, the same on every shard of the row (``replicated`` marks
  what is computed from it for BatchNorm);
* ``core.resize.resize_bilinear`` takes the rows of the global
  interpolation matrix that its band needs (``Bands``, ``band``);
* ``global_hw``: the global (H, W) of a banded tensor, for the callers
  that size a resize from ``.shape``.

A meeting is a barrier, and the tensors it exchanges are read by
``narrow``, ``.to`` and ``torch.cat``, which autograd differentiates: one
backward on the caller's thread gives every shard its gradients, and
nothing waits inside it. Every shard of a row meets at every op in the
same order, one whose band is empty too. Outside a context, or in a row
of one shard, every function here is the unsharded code, bit for bit.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F


class ShardGroup:
    """The shards of one sharded forward, one thread each, meeting where
    an op needs the others' parts. ``all_gather(rank, x)`` returns every
    shard's ``x`` in rank order; ``all_sum(rank, *xs)`` returns, for each
    of ``xs``, the sum of every shard's in rank order, on that shard's
    device (tensors moved by ``.to``, which autograd differentiates, or
    Python numbers): a shard waits there until every shard has brought
    its parts. A shard that fails calls ``abort()``, and the others'
    waits raise ``threading.BrokenBarrierError`` instead of hanging."""

    def __init__(self, n: int):
        self.n = n
        # two sets of slots, used in turn: a shard writes call k + 2's
        # parts only after every shard has reached call k + 1, by then
        # done reading call k's, so one wait a meeting is enough
        self._slots = ([None] * n, [None] * n)
        self._calls = [0] * n
        self._barrier = threading.Barrier(n)

    def all_gather(self, rank: int, x) -> list:
        slots = self._slots[self._calls[rank] % 2]
        self._calls[rank] += 1
        slots[rank] = x
        self._barrier.wait()
        return list(slots)

    def all_sum(self, rank: int, *xs):
        parts = self.all_gather(rank, xs)
        sums = []
        for i, x in enumerate(xs):
            if isinstance(x, torch.Tensor):
                total = parts[0][i].to(x.device)
                for p in parts[1:]:
                    total = total + p[i].to(x.device)
            else:
                total = sum(p[i] for p in parts)
            sums.append(total)
        return sums[0] if len(sums) == 1 else tuple(sums)

    def abort(self):
        self._barrier.abort()


_SHARD = threading.local()


@contextlib.contextmanager
def shard_context(group: ShardGroup, rank: int, row: ShardGroup = None,
                  row_rank: int = 0):
    """This thread runs shard ``rank`` of ``group`` (the whole mesh):
    its train BatchNorms normalize with the group's moments, and only
    rank 0 moves the running buffers. ``row`` (the shards of its data
    row, this one at ``row_rank``): with more than one shard its
    activations are bands of rows, and the ops of this module meet the
    row."""
    _SHARD.member = (group, rank)
    _SHARD.row = (row, row_rank) if row is not None and row.n > 1 else None
    try:
        yield
    finally:
        _SHARD.member = _SHARD.row = None


def mesh_member():
    """(the whole mesh's group, this shard's rank) in a shard context,
    else None."""
    return getattr(_SHARD, "member", None)


def row_member():
    """(the row's group, this shard's position in it) in a row of more
    than one shard, else None."""
    return getattr(_SHARD, "row", None)


@contextlib.contextmanager
def replicated():
    """What runs inside is the same on every shard of a row (computed
    from ``mean_hw``): a train BatchNorm counts it once, the row's first
    shard's copy (``is_replica``)."""
    was = getattr(_SHARD, "replicated", False)
    _SHARD.replicated = True
    try:
        yield
    finally:
        _SHARD.replicated = was


def is_replica() -> bool:
    """Inside ``replicated`` on a row's shard other than its first."""
    row = row_member()
    return (row is not None and row[1] != 0
            and getattr(_SHARD, "replicated", False))


def band(h: int, n: int, s: int):
    """[lo, hi): shard s of n's global rows of a tensor of height h."""
    return s * h // n, (s + 1) * h // n


class Bands:
    """Every shard's band of one banded tensor ``x`` of this shard's row,
    met once: ``h`` its global height, ``band(h)`` this shard's rows of a
    tensor of global height h, ``rows(lo, hi)`` any of its global rows on
    ``x``'s device."""

    def __init__(self, x, row: ShardGroup, rank: int):
        self.x, self.n, self.rank = x, row.n, rank
        self.parts = row.all_gather(rank, x)
        self.starts = [0]
        for p in self.parts:
            self.starts.append(self.starts[-1] + p.shape[-2])
        self.h = self.starts[-1]

    def band(self, h: int):
        return band(h, self.n, self.rank)

    def rows(self, lo: int, hi: int):
        """Global rows [lo, hi) of the tensor, each from the shard that
        holds it, zeros for rows outside [0, h)."""
        x = self.x
        if hi <= lo:
            return x.narrow(-2, 0, 0)

        def zeros(k):
            return x.new_zeros((*x.shape[:-2], k, x.shape[-1]))

        pieces = [zeros(min(hi, 0) - lo)] if lo < 0 else []
        for p, a, b in zip(self.parts, self.starts, self.starts[1:]):
            if max(lo, a) < min(hi, b):
                pieces.append(p.narrow(-2, max(lo, a) - a,
                                       min(hi, b) - max(lo, a)).to(x.device))
        if hi > self.h:
            pieces.append(zeros(hi - max(lo, self.h)))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, -2)


def gather(x):
    """``Bands`` of ``x`` (a meeting of its row), or None outside a row."""
    row = row_member()
    return None if row is None else Bands(x, *row)


def global_hw(x):
    """The global (H, W) of a banded tensor [..., H, W] (its row's
    heights summed, a meeting); outside a row, its own."""
    row = row_member()
    if row is None:
        return x.shape[-2], x.shape[-1]
    return row[0].all_sum(row[1], x.shape[-2]), x.shape[-1]


def conv2d(x, w, *, stride: int = 1, padding=0, dilation: int = 1,
           groups: int = 1):
    """``F.conv2d`` with zero ``padding``: an int on every side, or
    (left, right, top, bottom) as ``F.pad`` takes it. On a band, this
    shard's band of the global convolution's output: the input rows it
    reads gathered from the row (one meeting; none for a 1x1 at stride
    1, which reads its own rows), padded on W only."""
    row = row_member()
    if row is None:
        if isinstance(padding, int):
            return F.conv2d(x, w, stride=stride, padding=padding,
                            dilation=dilation, groups=groups)
        return F.conv2d(F.pad(x, padding), w, stride=stride,
                        dilation=dilation, groups=groups)
    left, right, top, bottom = ((padding,) * 4 if isinstance(padding, int)
                                else padding)
    reach = dilation * (w.shape[-2] - 1) + 1
    w_out = (x.shape[-1] + left + right
             - dilation * (w.shape[-1] - 1) - 1) // stride + 1
    if reach == 1 and stride == 1 and top == bottom == 0:
        lo, hi, xs = 0, x.shape[-2], x
    else:
        view = Bands(x, *row)
        lo, hi = view.band((view.h + top + bottom - reach) // stride + 1)
        xs = view.rows(lo * stride - top, (hi - 1) * stride - top + reach)
    if hi == lo:
        return x.new_zeros((x.shape[0], w.shape[0], 0, w_out))
    if left == right:
        return F.conv2d(xs, w, stride=stride, padding=(0, left),
                        dilation=dilation, groups=groups)
    return F.conv2d(F.pad(xs, (left, right)), w, stride=stride,
                    dilation=dilation, groups=groups)


def mean_hw(x):
    """The f32 mean of [N, C, H, W] over H and W, [N, C, 1, 1]; on a
    band, over the global H*W: the row's f32 sums (one meeting) over the
    global count, the same on every shard of the row."""
    row = row_member()
    if row is None:
        return x.float().mean((-2, -1), keepdim=True)
    total, h = row[0].all_sum(row[1], x.float().sum((-2, -1), keepdim=True),
                              x.shape[-2])
    return total / (h * x.shape[-1])
