"""The program under test, built from a configuration and the seed's
weights: the only module of the harness's set-up that reaches into
``segtpu_torch`` (the loops call the objects it returns).
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
# the kernel libraries a served call loads (the experiments' three are
# not on any served path)
SERVED_LIBRARIES = ("front", "upsample_argmax", "conv_chw", "inv_res",
                    "pointwise", "cell", "resize")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_kernels(device) -> dict:
    """Every served kernel library built at once (one ``nvcc`` a source,
    in parallel), into the program's build directory inside the
    checkout, before anything loads one. Returns {"build_s",
    "built"}: the seconds, and the sources compiled (none when warm)."""
    from segtpu_torch.kernels import _build
    from segtpu_torch.utils.cache import enable_compilation_cache
    os.environ.pop("SEGTPU_NO_CACHE", None)
    enable_compilation_cache(str(ROOT / "segtpu_torch" / "_build"))
    if torch.device(device).type != "cuda":
        return {"build_s": 0.0, "built": []}
    t0 = time.perf_counter()
    _build.build(SERVED_LIBRARIES)
    return {"build_s": time.perf_counter() - t0, "built": sorted(_build.built())}


def init_device(device):
    """The device's context, made before anything is timed apart."""
    if torch.device(device).type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)


def build_model(cfg: dict, weights: dict, device, *, aux: bool = False):
    """The program's ``models.Segmenter`` of ``cfg`` on ``device``, holding
    ``weights`` (every parameter and statistic, checked by name)."""
    from segtpu_torch.models import create_segmenter
    family = {"micro": "micro", "template": "template"}[cfg["family"]]
    model = create_segmenter(cfg["genotype"], int(cfg["num_classes"]),
                             agg_size=int(cfg["agg_size"]),
                             repeats=int(cfg.get("repeats", 1)), aux=aux,
                             family=family, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    model = model.to(device)
    model.load_state_dict(weights, strict=True)
    return model


def build_engine(cfg: dict, weights: dict, device):
    """The served engine (``engine.Segmenter``) over the model."""
    from segtpu_torch.engine import Segmenter
    model = build_model(cfg, weights, device)
    return Segmenter(model, align_corners=bool(cfg.get("align_corners", True)),
                     compute_dtype=DTYPES[cfg["compute_dtype"]], device=device)
