"""Build the CUDA sources under ``segtpu_torch/csrc`` on first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``. A
plain C interface keeps PyTorch's headers out of the compile: a source
builds in seconds instead of the minutes an extension that includes
``torch/extension.h`` takes. Libraries go to ``BUILD_DIR``, by default
``segtpu_torch/_build/`` (git-ignored; ``utils.cache`` moves it),
named by a hash of their source, so an edited source is rebuilt and an
unchanged one is reused. ``build()`` starts one ``nvcc``
per missing library, all at once, and waits for them together.

``launch_count()`` is the number of kernel launches this thread has
issued through the libraries' C entries (each entry launches one
kernel); ``count_launch()`` is called after each.

``BUILDS`` records, for this process, each ``build()`` call that ran
``nvcc``: the sources it compiled and its wall seconds. It stays empty
in a process that found every library it loaded already built (a warm
start).

There is no fallback: a missing ``nvcc`` or a failed compile raises.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
DEFAULT_BUILD_DIR = PKG_DIR / "_build"
BUILD_DIR = DEFAULT_BUILD_DIR   # set by utils.cache.enable_compilation_cache
KERNEL_SOURCES = ("front", "upsample_argmax", "conv_chw", "inv_res",
                  "pointwise", "cell", "resize",
                  # the DeepLab-v3 head's dense products (kernels/aspp.py)
                  "aspp",
                  # train-mode BatchNorm (kernels/bn_train.py)
                  "bn_train",
                  # the experiments' kernels (segtpu_torch.scripts)
                  "vpu_floor", "front_ab", "tail_flat")

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
BUILDS: List[Tuple[Tuple[str, ...], float]] = []   # (sources, seconds)
_THREAD = threading.local()


def count_launch() -> None:
    """One more kernel launched by this thread."""
    _THREAD.launches = getattr(_THREAD, "launches", 0) + 1


def launch_count() -> int:
    """Kernel launches this thread has issued through the C entries."""
    return getattr(_THREAD, "launches", 0)


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, torch's CUDA_HOME, or PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME, "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("segtpu_torch kernels need nvcc (CUDA toolkit); "
                           "none found in CUDA_HOME or on PATH")
    return found


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    the shared headers (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Compile every listed source whose library is missing, in parallel.
    Returns {name: library path}. The compiler's report (registers,
    spills) is kept beside each library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    paths = {n: library_path(n) for n in names}
    nvcc = nvcc_path() if any(not p.exists() for p in paths.values()) else None
    jobs = []
    for name, lib in paths.items():
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        log = open(f"{lib}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
        jobs.append((name, lib, tmp, log,
                     subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, lib, tmp, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            os.unlink(tmp)
            failed.append(f"{name} (nvcc rc {rc}):\n"
                          + Path(f"{lib}.log").read_text()[-4000:])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    if jobs:
        BUILDS.append((tuple(name for name, *_ in jobs),
                       time.perf_counter() - t0))
    return paths


def built() -> set:
    """The sources ``nvcc`` compiled in this process."""
    return {name for names, _ in BUILDS for name in names}


def build_seconds() -> float:
    """Wall seconds this process spent in ``build()`` calls that compiled
    something."""
    return sum(seconds for _, seconds in BUILDS)


def loaded() -> tuple:
    """The sources whose libraries this process has loaded."""
    return tuple(_LOADED)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
    return _LOADED[name]
