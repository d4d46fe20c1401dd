"""A cell is data: a throwaway cell added to a copy of the benchmark, by
new files and new entries in ``BENCHMARK.json`` alone, runs end to end
on the CPU at a small size, with no existing file edited.

    python -m pytest benchmark/tests -q
"""

import hashlib
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_as_data_runs(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    before = digest(tmp_path)
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "benchmark"
    arch1 = json.loads((bench / "configs" / "arch0.json").read_text())
    arch1["genotype"] = [[0, [1, 0, 9, 2], [0, 2, 2, 4], [3, 1, 0, 9]],
                         [[3, 2], [2, 4], [1, 0]]]
    (bench / "configs" / "arch1.json").write_text(json.dumps(arch1))
    traffic = json.loads((bench / "traffic" / "city_b8.json").read_text())
    traffic.update(batch=1, height=64, width=128, ring=2, trace_seconds=0.1)
    (bench / "traffic" / "tiny_b1.json").write_text(json.dumps(traffic))
    (bench / "limits" / "serve_arch1_tiny.json").write_text(
        json.dumps({"widest_gap": 0.5}))
    (bench / "metrics" / "probe_ms.tiny.py").write_text(
        "def read(run):\n    return 1.5\n")
    (bench / "metrics" / "silent.tiny.py").write_text(
        "def read(run):\n    return None\n")
    man["configs"].append({"name": "arch1", "source": "x",
                           "file": "benchmark/configs/arch1.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "serve_arch1_tiny", "config": "arch1",
                             "traffic": "tiny_b1", "chips": 1, "why": "t"})
    for m in man["end_to_end"]:
        if m["name"] == "images_per_s":
            m["workloads"].append("serve_arch1_tiny")
    for name in ("probe_ms.tiny", "silent.tiny"):
        man["per_layer"].append({"name": name, "unit": "ms",
                                 "better": "lower", "source": "host_clock",
                                 "layer": "engine", "moves": "images_per_s",
                                 "workloads": ["serve_arch1_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    after = digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before

    plain = harness.execute("serve_arch1_tiny", 2**31 + 7, 0.2, False,
                            device="cpu", root=tmp_path)
    assert plain["correct"]
    assert set(plain["metrics"]) == {"images_per_s", "setup_s"}
    traced = harness.execute("serve_arch1_tiny", 2**31 + 7, 0.2, True,
                             device="cpu", root=tmp_path)
    assert traced["correct"]
    assert traced["metrics"]["probe_ms.tiny"]["value"] == 1.5
    assert "silent.tiny" not in traced["metrics"]
    assert list(traced)[-1] == "checks"


def test_each_cell_finds_its_metrics():
    man = harness.manifest()
    for cell in man["workloads"]:
        e2e = harness.metrics_of(man, cell["name"], "end_to_end")
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        per = harness.metrics_of(man, cell["name"], "per_layer")
        assert per and all(m["moves"] in names for m in per)
        for m in per:
            assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        traffic = json.loads((ROOT / "benchmark" / "traffic"
                              / f"{cell['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "loops" / f"{traffic['kind']}.py").is_file()
