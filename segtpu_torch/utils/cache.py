"""Where the kernel libraries are built and looked for (counterpart:
segtpu/utils/cache.py).

The JAX package keeps XLA's compiled programs in a persistent cache so
that they compile once per machine. The port's counterpart is the
kernel build cache of ``kernels._build``: one shared library per CUDA
source, named by a hash of the source, built by ``nvcc`` on first use
and reused while the source is unchanged. Every entry point
(``segtpu_torch.main_search``, the ``engine.Segmenter``) calls
:func:`enable_compilation_cache` first.

Knobs (read at call time):
  SEGTPU_CACHE_DIR  — the build directory (default: segtpu_torch/_build,
                      which .gitignore lists)
  SEGTPU_NO_CACHE=1 — build into a fresh temporary directory in each
                      process (e.g. to time a cold build)
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path

from segtpu_torch.kernels import _build

_ENABLED_DIR = None   # the directory the first call chose
_FRESH_DIR = None     # this process's SEGTPU_NO_CACHE directory


def enable_compilation_cache(cache_dir: str | None = None) -> str | None:
    """Point the kernel build at a directory, once per process (a later
    call keeps the first call's choice, as the JAX package's does).
    Returns the directory in use, or None under ``SEGTPU_NO_CACHE=1``,
    which builds into a fresh temporary directory made for this process
    (a run without any cache), removed when the process exits. Otherwise
    the directory is ``cache_dir``, else ``SEGTPU_CACHE_DIR``, else the
    package's own ``_build/``.

    A library already loaded in this process stays loaded: the knobs
    decide only where libraries are looked for and built from then on."""
    global _ENABLED_DIR, _FRESH_DIR
    if os.environ.get("SEGTPU_NO_CACHE", "") == "1":
        if _FRESH_DIR is None:
            _FRESH_DIR = Path(tempfile.mkdtemp(prefix="segtpu_torch_build_"))
            atexit.register(shutil.rmtree, _FRESH_DIR, ignore_errors=True)
        _build.BUILD_DIR = _FRESH_DIR
        return None
    if _ENABLED_DIR is None:
        _ENABLED_DIR = Path(cache_dir or os.environ.get("SEGTPU_CACHE_DIR")
                            or _build.DEFAULT_BUILD_DIR)
    _build.BUILD_DIR = _ENABLED_DIR
    return str(_ENABLED_DIR)
