"""The DeepLab-v3 cell (``serve_dlv3mnv2_city_b8``): its counts term by
term against the convolutions its reference runs at 1024x2048, the cell
end to end on the CPU at a small size, and the files the harness finds
for it by name.

    python -m pytest benchmark/tests/test_benchmark_dlv3.py -q
"""

import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.counts import dlv3  # noqa: E402
from benchmark.reference import deeplabv3_mnv2 as ref  # noqa: E402

CELL = "serve_dlv3mnv2_city_b8"
# the per-layer metrics this cell brings (it may report others beside them)
OWN = {"atrous_ms.serve", "aspp_ms.serve", "aspp_launches.serve",
       "aspp_roofline", "atrous_roofline", "mfu.serve_dlv3"}

def config():
    man = harness.manifest()
    path = {c["name"]: c["file"] for c in man["configs"]}
    return json.loads((ROOT / path["deeplabv3_mnv2_os16"]).read_text())


def recorded_convs(cfg, h, w, monkeypatch):
    """[(parameter name, FLOPs, output)] of every convolution of the
    reference's forward on an n=1 h x w frame, on meta tensors."""
    names, out = [], []

    def P(name, shape, kind, fan_in=0):
        if kind == "conv":
            names.append(name[:-2])
        return torch.ones(shape, device="meta")

    real = F.conv2d

    def conv2d(x, wt, *a, **kw):
        y = real(x, wt, *a, **kw)
        fan_in = wt.shape[1] * wt.shape[2] * wt.shape[3]
        out.append((names[-1], 2.0 * y.numel() * fan_in, y))
        return y
    monkeypatch.setattr(F, "conv2d", conv2d)
    hp, wp = dlv3.padded(h, w)
    ref.Net(P, cfg)(torch.ones((1, 3, hp, wp), device="meta"))
    return out


def test_counts_term_by_term(monkeypatch):
    cfg = config()
    h, w = 1024, 2048
    convs = recorded_convs(cfg, h, w, monkeypatch)
    enc = sum(f for n, f, _ in convs if n.startswith("encoder."))
    assert dlv3.encoder_flop(cfg, h, w) == enc
    blocks = dlv3.atrous_blocks(cfg, h, w)
    assert blocks == [13, 14, 15, 16]
    atrous = sum(f for n, f, _ in convs
                 if n.startswith("encoder.blocks.")
                 and int(n.split(".")[2]) in blocks)
    assert dlv3.atrous_flop(cfg, h, w) == atrous
    # the head: the reference's convolutions, less the pooled branch's
    # slice of the projection at every pixel but one (the count takes it
    # once a frame: the pooled map is constant)
    head = sum(f for n, f, _ in convs if n.startswith("decoder."))
    npx = (h // 16) * (w // 16)
    ch = cfg["aspp_channels"]
    assert dlv3.head_flop(cfg, h, w) == head - 2.0 * ch * ch * (npx - 1)
    # bytes: the map the head reads and the logits it writes
    f = [y for n, _, y in convs if n == "encoder.blocks.16.project"][0]
    logits = convs[-1][2]
    e = 2
    layers = dlv3.served_layers(cfg, 8, h, w)
    weights = sum(int(torch.Size(s).numel()) for _, s, k, _ in
                  ref.param_spec(cfg) if k == "conv")
    enc_w = dlv3.weight_elements(cfg, "encoder.")
    assert enc_w + dlv3.weight_elements(cfg, "decoder.") == weights
    assert layers["head"]["bytes"] == 8 * e * (f.numel() + logits.numel()) \
        + e * (weights - enc_w)
    assert layers["tail"]["bytes"] == 8 * (e * logits.numel() + h * w)
    assert tuple(logits.shape) == (1, 19, 64, 128)
    assert layers["encoder"]["bytes"] == 8 * e * (3 * h * w + f.numel()) \
        + e * enc_w
    # 4.5 M parameters (arXiv:1801.04381 Table 7)
    assert 4.4e6 < sum(int(torch.Size(s).numel())
                       for _, s, k, _ in ref.param_spec(cfg)
                       if k in ("conv", "bn_scale", "bn_bias",
                                "clf_bias")) < 4.6e6
    # the tail upsamples 1/16 logits in the cheaper order (W first here)
    assert dlv3.tail_flop(cfg, h, w) == 19 * w * (3 * 64 + 4 * h)


def test_the_cell_runs_on_the_cpu():
    """The cell end to end on the CPU at b1 64x128, untraced and traced:
    correct, its end-to-end metrics, and off the card only the readers
    that need none (``mfu.serve_dlv3``)."""
    torch.set_num_threads(4)
    ov = dict(batch=1, height=64, width=128, ring=2, trace_seconds=0.1)
    plain = harness.execute(CELL, 2**31 + 11, 0.2, False, device="cpu",
                            overrides=ov)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"images_per_s", "setup_s"}
    traced = harness.execute(CELL, 2**31 + 13, 0.2, True, device="cpu",
                             overrides=ov)
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == {"mfu.serve_dlv3"}
    man = harness.manifest()
    names = {m["name"] for m in harness.metrics_of(man, CELL, "per_layer")}
    assert OWN <= names


def test_the_cell_finds_its_files_by_name():
    """The harness finds the cell's files by name: its config, its
    traffic's loop, its limits and each of its own metrics' readers; the
    reference it is held to is the port's plain reference, byte for
    byte."""
    man = harness.manifest()
    cell = {w["name"]: w for w in man["workloads"]}[CELL]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    assert conf["reduced"] == [] and (ROOT / conf["file"]).is_file()
    bench = ROOT / "benchmark"
    traffic = json.loads((bench / "traffic" /
                          f"{cell['traffic']}.json").read_text())
    assert (bench / "loops" / f"{traffic['kind']}.py").is_file()
    assert "widest_gap" in json.loads(
        (bench / "limits" / f"{CELL}.json").read_text())
    for name in OWN:
        assert (bench / "metrics" / f"{name}.py").is_file(), name
    port = ROOT / "segtpu_torch" / "reference" / "deeplabv3_mnv2.py"
    assert (bench / "reference" / "deeplabv3_mnv2.py").read_bytes() \
        == port.read_bytes()
