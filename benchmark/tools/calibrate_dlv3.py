"""The readings that the DeepLab-v3 cell's limit is set from, on the card,
in one process (the kernels built once):

    python3 benchmark/tools/calibrate_dlv3.py --mode sound \
        --seeds 3000000001 ... --seconds 2

``tools/calibrate.py`` reads the NAS configurations' reference, whose
model knows only their families; this tool does the same for
``serve_dlv3mnv2_city_b8`` with its loop's reference
(``loops/serve_closed_dlv3.py``). Modes:

* ``sound``: the program as the cell runs it: set-up, a short window at
  the cell's load, the check (``calibrate.one``);
* ``control``: the reference with every convolution's input and weight
  in float8 e4m3 (one step below the bf16 the configuration states)
  gives the masks, in the program's place (``control_checks``).

Prints one JSON line a seed: {"seed", "mode", "checks": {number: value}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.tools.calibrate import one  # noqa: E402

CELL = "serve_dlv3mnv2_city_b8"


def control(seed: int, device, overrides) -> dict:
    run = harness.Run(harness.manifest(), CELL, seed, device, overrides)
    t0 = time.perf_counter()
    checks = run.loop.control_checks(run)
    return {"workload": CELL, "seed": seed, "mode": "control",
            "seconds": time.perf_counter() - t0,
            "checks": {k: v for k, (v, _) in checks.items()},
            "notes": run.notes}


def main(argv=None):
    ap = argparse.ArgumentParser("benchmark/tools/calibrate_dlv3.py")
    ap.add_argument("--mode", choices=("sound", "control"), default="sound")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--overrides", type=json.loads, default={},
                    help="traffic parameters to replace (a JSON object), "
                         "for a rehearsal at a small size")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        rec = (control(seed, args.device, args.overrides)
               if args.mode == "control" else
               one(CELL, seed, "sound", args.seconds, args.device,
                   args.overrides))
        print(json.dumps(rec), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
