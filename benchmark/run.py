"""Run one cell of the benchmark once, from the checkout's root:

    python3 benchmark/run.py --workload serve_arch0_city_b8 --seed 7 \
        --seconds 15 --trace 0

Prints earlier lines (``# {...}``) on standard error, then each number
the check compared beside its limit, and as the last line of standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``. Exits non-zero and prints no result without enough CUDA
cards, or when ``jax``, ``jaxlib``, ``flax`` or ``segtpu`` is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / "_cache"
def main(argv=None) -> int:
    ap = argparse.ArgumentParser("benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness

    man = harness.manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = harness.execute(args.workload, args.seed, args.seconds,
                             bool(args.trace), device="cuda:0",
                             t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    harness.print_checks(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
