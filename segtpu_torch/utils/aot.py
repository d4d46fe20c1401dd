"""Per-shape programs as CUDA graphs (counterpart: segtpu/utils/aot.py).

The JAX package compiles one program per shape bucket and stores it on
disk (``jax.export``), so that a warm process start skips tracing. The
port's counterpart of that compiled program is a CUDA graph of the
engine's call at one shape: the 30-odd kernel launches the Python issues
per call, captured once and replayed by one ``cudaGraphLaunch``. The
counterpart of the on-disk store is the kernel build directory
(``utils.cache``, ``kernels._build``): the ``nvcc`` build is the cost a
warm process skips. A CUDA graph cannot be serialized, so nothing more
persists from one process to the next.

``aot_graph(fn, key, *example_args)`` returns a program for ``fn(*args)``
at the example arguments' shapes, dtypes and device:

* on a CUDA device, ``fn`` runs once eagerly as a warm-up (it loads the
  libraries, makes the plans and uploads the tap tables), then is
  captured as a ``torch.cuda.CUDAGraph`` on static copies of the
  arguments. A call copies its arguments into the static buffers,
  replays the graph and returns a clone of the static output, which a
  later call does not touch. A capture that fails raises: nothing falls
  back to running eagerly;
* on the CPU, and anywhere under ``SEGTPU_NO_AOT=1`` (the JAX knob, the
  same name and meaning), the program runs ``fn`` eagerly.

The kernels are bound through ``ctypes`` and receive raw pointers, so a
graph keeps no tensor alive by itself. While capturing, every tensor
whose ``data_ptr()`` is taken (what a launch reads or writes) and that
was made before the capture (weights, tap tables of the kernels' bounded
caches, the static inputs) is held by the program, whose replays then
never read memory the caching allocator has handed to another tensor.
Tensors made during the capture live in the graph's private pool.

Under ``utils.profiling.tracing()`` a program is made apart from the
untraced one (the tracing state is part of its key): the device spans
its capture opened are the graph's event-record nodes, kept as
``spans``, and each replay records them anew under the caller's open
span. A replay first waits for the previous replay's spans to be read,
since it re-records their events; untraced, a program holds no event
node and waits for nothing.

A program carries ``launches`` (the kernel launches its graph holds,
``kernels._build.launch_count()`` over the capture; 0 when eager),
``aot_hit`` (no library it loaded was compiled by
this process: a warm start; False under ``SEGTPU_NO_AOT=1``, as in the
JAX package), ``build_s`` (the ``nvcc`` seconds spent while making it)
and ``capture_s`` (the warm-up and the capture, less ``build_s``).
The same key on the same device gives the same program while it lives:
the key must name everything that shapes the program, the weights a
graph reads included.
"""

from __future__ import annotations

import gc
import os
import time
import weakref

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten

from segtpu_torch.kernels import _build
from segtpu_torch.utils import profiling

_PROGRAMS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def graphs_enabled() -> bool:
    return os.environ.get("SEGTPU_NO_AOT", "") != "1"


def _warm() -> bool:
    """No library this process has loaded was compiled by it."""
    return not _build.built() & set(_build.loaded())


def _storages(tree) -> dict:
    return {t.untyped_storage().data_ptr(): t.untyped_storage()
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)}


class _HoldLaunchInputs(TorchFunctionMode):
    """While active: ``held``, the storage of every tensor whose
    ``data_ptr()`` is taken, unless an op inside this mode made it (an
    op's output whose storage none of its inputs has: a view, an
    in-place op or a no-op cast of an older tensor makes nothing)."""

    def __init__(self):
        super().__init__()
        self.made = set()      # storage addresses of tensors made here
        self.held = {}         # storage address -> storage

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is torch.Tensor.data_ptr:
            st = args[0].untyped_storage()
            if st.data_ptr() not in self.made:
                self.held.setdefault(st.data_ptr(), st)
        else:
            self.made.update(_storages(out).keys()
                             - _storages((args, kwargs)).keys())
        return out


class _Program:
    """A callable of one shape: the eager ``fn``, or a CUDA graph of it on
    static buffers (``graph``, ``static_in``, ``static_out``) with the
    tensors its launches read (``held``), the kernel launches it holds
    (``launches``) and the spans its capture kept (``spans``)."""

    def __init__(self, fn, *, graph=None, static_in=(), static_out=None,
                 held=(), aot_hit: bool, build_s: float = 0.0,
                 capture_s: float = 0.0, launches: int = 0, spans=()):
        self._fn = fn
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.held = held
        self.aot_hit = aot_hit
        self.build_s = build_s
        self.capture_s = capture_s
        self.launches = launches
        self.spans = spans
        self._unread = None    # the last replay's spans

    def __call__(self, *args):
        if self.graph is None:
            return self._fn(*args)
        if self._unread:
            profiling.resolve(self._unread)
        for dst, src in zip(self.static_in, args):
            dst.copy_(src)
        self.graph.replay()
        self._unread = profiling.replayed(self.spans)
        return self.static_out.clone()


def _capture(fn, example_args, key) -> _Program:
    dev = example_args[0].device
    t0, b0 = time.perf_counter(), _build.build_seconds()
    with torch.cuda.device(dev):
        static_in = tuple(a.detach().clone() for a in example_args)
        fn(*static_in)                          # the warm-up, eager
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        hold = _HoldLaunchInputs()
        # a dead graph that the cyclic collector destroys mid-capture
        # (cudaGraphExecDestroy) would invalidate the capture: collect
        # first, and not during it
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        n0 = _build.launch_count()
        try:
            with torch.cuda.graph(graph):
                with hold, profiling.captured_spans() as spans:
                    static_out = fn(*static_in)
        except Exception as e:
            raise RuntimeError(f"aot_graph: capturing {key!r} on {dev} "
                               f"failed: {e}") from e
        finally:
            if collecting:
                gc.enable()
    build_s = _build.build_seconds() - b0
    return _Program(fn, graph=graph, static_in=static_in,
                    static_out=static_out, held=tuple(hold.held.values()),
                    aot_hit=_warm(), launches=_build.launch_count() - n0,
                    spans=tuple(spans),
                    build_s=build_s,
                    capture_s=time.perf_counter() - t0 - build_s)


def aot_graph(fn, key, *example_args) -> _Program:
    """-> the program of ``fn(*args)`` (a tensor) at the shapes, dtypes and
    device of ``example_args`` (tensors, all on one device): a CUDA graph on a
    card, eager on the CPU or under ``SEGTPU_NO_AOT=1``. ``key`` names
    everything that shapes the program; the same key on the same device,
    with tracing on or off alike, returns the same program while it
    lives."""
    dev = example_args[0].device
    graphed = dev.type == "cuda" and graphs_enabled()
    rkey = (key, str(dev), graphs_enabled())
    if profiling.enabled():
        rkey += ("traced",)
    prog = _PROGRAMS.get(rkey)
    if prog is not None:
        return prog
    if graphed:
        prog = _capture(fn, example_args, key)
    else:
        prog = _Program(fn, aot_hit=graphs_enabled() and _warm())
    _PROGRAMS[rkey] = prog
    return prog
