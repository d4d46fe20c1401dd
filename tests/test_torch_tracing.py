"""The program's spans and counters (``segtpu_torch.utils.profiling``):
``tracing()`` on and off, the span trees of a served call and of a train
step, parents per thread, the buffer's bound, the engine's counters, the
replay of a captured graph's spans, and the benchmark's grouping of
spans by request.

    python -m pytest tests/test_torch_tracing.py -q

Tests marked ``card`` need a CUDA card and skip without one; on the card:
``python -m pytest tests/test_torch_tracing.py -q -m card``.
"""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from segtpu_torch.core import layers
from segtpu_torch.engine import Segmenter, ShardedSegmenter
from segtpu_torch.engine.trainer import init_train_state, make_train_step
from segtpu_torch.models import ARCHS, TEMPLATE_ARCHS, create_segmenter
from segtpu_torch.parallel.mesh import make_mesh, make_sharded_train_step
from segtpu_torch.utils import aot, profiling
from segtpu_torch.utils.solvers import create_optimisers

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmark.spans import by_request, device_ms  # noqa: E402

K = 19
CPU = torch.device("cpu")
LAYERS = ["segtpu.engine.front", "segtpu.engine.encoder",
          "segtpu.engine.decoder", "segtpu.engine.tail"]
TRAIN_PARTS = ["segtpu.train.forward", "segtpu.train.loss",
               "segtpu.train.backward", "segtpu.train.optimizer",
               "segtpu.train.polyak"]


def _model(family="micro", aux=False, device="cpu"):
    genotype = (ARCHS["arch0"] if family == "micro"
                else TEMPLATE_ARCHS["template0"])
    return create_segmenter(genotype, K, family=family, aux=aux,
                            generator=torch.Generator().manual_seed(0),
                            device=device)


@pytest.fixture(scope="module")
def seg():
    return Segmenter(_model(), device="cpu")


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.collect()
    yield
    profiling.collect()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _imgs(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _children(spans, parent):
    return [s["name"] for s in spans if s["parent"] == parent["id"]]


def _one(spans, name):
    found = [s for s in spans if s["name"] == name]
    assert len(found) == 1, (name, found)
    return found[0]


# ------------------------------------------------------------ off is off


def test_off_records_nothing_and_opens_no_range(seg, monkeypatch):
    opened = []

    def record_function(*args, **kwargs):
        opened.append(args)
        raise AssertionError("a range opened while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    assert not profiling.enabled()
    assert profiling.span("segtpu.x") is profiling.span("segtpu.y")
    with profiling.span("segtpu.x", request=3, device=CPU) as s:
        assert s is None
    seg.predict(_imgs((1, 64, 64, 3)))
    assert opened == [] and profiling.collect() == []


def test_off_serves_the_untraced_program(seg):
    shape = (1, 64, 64, 3)
    untraced = seg._compiled((64, 64), False, shape)
    assert untraced.spans == () and untraced.launches == 0
    with profiling.tracing():
        traced = seg._compiled((64, 64), False, shape)
        seg.predict(_imgs(shape))
    assert traced is not untraced
    assert seg._compiled((64, 64), False, shape) is untraced
    assert ((64, 64), False, shape, "cpu") in seg._cache
    assert ((64, 64), False, shape, "cpu", "traced") in seg._cache


# ------------------------------------------------------- the span trees


def test_eager_predict_span_tree(seg):
    with profiling.tracing():
        seg.predict(_imgs((2, 64, 64, 3), 1))
    spans = profiling.collect()
    root = _one(spans, "segtpu.engine.predict")
    assert root["parent"] is None
    assert _children(spans, root) == ["segtpu.engine.stage",
                                      "segtpu.engine.replay",
                                      "segtpu.engine.fetch"]
    assert _children(spans, _one(spans, "segtpu.engine.replay")) == LAYERS
    assert len(spans) == 8
    assert {s["request"] for s in spans} == {root["request"]}
    for s in spans:
        assert s["host_ms"] > 0 and s["device_ms"] is None   # no card here
    assert root["host_ms"] >= sum(
        s["host_ms"] for s in spans if s["parent"] == root["id"])


def test_tensor_predict_has_no_staging(seg):
    with profiling.tracing():
        seg.predict(torch.from_numpy(_imgs((1, 64, 64, 3))))
        seg.predict(torch.from_numpy(_imgs((1, 64, 64, 3))))
    spans = profiling.collect()
    roots = [s for s in spans if s["name"] == "segtpu.engine.predict"]
    assert len(roots) == 2 and roots[0]["request"] != roots[1]["request"]
    for root in roots:
        assert _children(spans, root) == ["segtpu.engine.replay"]


def test_stream_spans_share_their_frame_request(seg):
    frames = [_imgs((64, 64, 3), i) for i in range(3)]
    with profiling.tracing():
        masks = list(seg.predict_stream(frames))
    assert len(masks) == 3
    spans = profiling.collect()
    by_req = {}
    for s in spans:
        if s["parent"] is None:
            by_req.setdefault(s["request"], []).append(s["name"])
    assert sorted(by_req.values()) == [["segtpu.engine.stream.stage",
                                        "segtpu.engine.replay",
                                        "segtpu.engine.stream.fetch"]] * 3


def test_train_step_span_tree(monkeypatch):
    model = _model(aux=True)
    opt = create_optimisers()
    state = init_train_state(model, opt, do_polyak=True)
    step = make_train_step(ARCHS["arch0"], opt, num_classes=K)
    rng = np.random.default_rng(0)
    batch = {"image": rng.standard_normal((2, 64, 64, 3), np.float32),
             "label": rng.integers(0, K, (2, 64, 64))}
    calls = []
    bn_train = layers.bn_train

    def counted(*args):
        calls.append(1)
        return bn_train(*args)

    monkeypatch.setattr(layers, "bn_train", counted)
    state.step = 7
    with profiling.tracing():
        state, loss = step(state, batch)
    spans = profiling.collect()
    root = _one(spans, "segtpu.train.step")
    assert root["parent"] is None and root["request"] == 7
    assert _children(spans, root) == TRAIN_PARTS
    forward = _one(spans, "segtpu.train.forward")
    bns = [s for s in spans if s["name"] == "segtpu.train.bn"]
    assert len(bns) == len(calls) > 50
    assert {s["parent"] for s in bns} == {forward["id"]}
    assert _children(spans, forward) == ["segtpu.train.bn"] * len(calls)
    assert {s["request"] for s in spans} == {7}
    assert state.step == 8 and torch.isfinite(loss)


def test_sharded_train_step_spans_per_thread():
    model = _model(aux=True)
    opt = create_optimisers()
    state = init_train_state(model, opt, do_polyak=True)
    step = make_sharded_train_step(
        make_train_step(ARCHS["arch0"], opt, num_classes=K),
        make_mesh(2, devices=[CPU] * 2))
    rng = np.random.default_rng(1)
    batch = {"image": rng.standard_normal((2, 32, 32, 3), np.float32),
             "label": rng.integers(0, K, (2, 32, 32))}
    with profiling.tracing():
        step(state, batch)
    spans = profiling.collect()
    ids = {s["id"]: s for s in spans}
    assert {s["request"] for s in spans} == {0}
    root = _one(spans, "segtpu.train.step")
    assert _children(spans, root) == ["segtpu.train.loss",
                                      "segtpu.train.backward",
                                      "segtpu.train.optimizer",
                                      "segtpu.train.polyak"]
    shards = [s for s in spans if s["name"] == "segtpu.train.shard"]
    assert len(shards) == 2 and all(s["parent"] is None for s in shards)
    assert len({s["thread"] for s in shards} | {root["thread"]}) == 3
    for sh in shards:
        assert _children(spans, sh) == ["segtpu.train.forward",
                                        "segtpu.train.loss"]
    for s in spans:
        if s["parent"] is not None:
            assert ids[s["parent"]]["thread"] == s["thread"]


def test_parents_stay_per_thread_under_sharded_segmenter():
    sh = ShardedSegmenter(Segmenter(_model(), device="cpu"), [CPU] * 2)
    imgs = [_imgs((1, 64, 64, 3), i) for i in range(2)]
    start = threading.Barrier(2)

    def call(i):
        start.wait()
        for _ in range(2):
            sh.predict(imgs[i])

    with profiling.tracing():
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    spans = profiling.collect()
    ids = {s["id"]: s for s in spans}
    roots = [s for s in spans if s["name"] == "segtpu.engine.predict"]
    assert len(roots) == 4 and len({r["request"] for r in roots}) == 4
    assert len({r["thread"] for r in roots}) == 2
    for root in roots:
        assert root["parent"] is None
        assert _children(spans, root) == LAYERS + ["segtpu.engine.fetch"]
    for s in spans:
        if s["parent"] is not None:
            parent = ids[s["parent"]]
            assert parent["thread"] == s["thread"]
            assert parent["request"] == s["request"]


# ------------------------------------------------- recorder's mechanics


def test_buffer_keeps_the_newest_within_its_bound(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 10)
    with profiling.tracing():
        for i in range(25):
            with profiling.span("segtpu.test.leaf", request=i):
                pass
    spans = profiling.collect()
    assert [s["request"] for s in spans] == list(range(15, 25))
    with profiling.tracing():
        for i in range(3):
            with profiling.span("segtpu.test.leaf"):
                pass
    assert len(profiling.collect()) == 3


def test_tracing_nests_and_requests_pass_to_children():
    with profiling.tracing():
        with profiling.tracing():
            with profiling.span("segtpu.test.outer", request="r1"):
                with profiling.span("segtpu.test.inner") as inner:
                    assert inner.request == "r1"
        assert profiling.enabled()
        with profiling.span("segtpu.test.other") as other:
            assert other.request not in (None, "r1")
    assert not profiling.enabled()
    names = [s["name"] for s in profiling.collect()]
    assert names == ["segtpu.test.outer", "segtpu.test.inner",
                     "segtpu.test.other"]


def test_host_spans_are_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile
    with profiling.tracing(), profile(activities=[ProfilerActivity.CPU]) as p:
        with profiling.span("segtpu.test.outer"):
            with profiling.span("segtpu.test.inner"):
                torch.ones(3).sum()
    names = {e.name for e in p.events()}
    assert {"segtpu.test.outer", "segtpu.test.inner"} <= names


class _Event:
    """A CUDA event's stand-in: the time a replay recorded it at."""

    def __init__(self, clock):
        self.clock = clock
        self.synced = 0

    def synchronize(self):
        self.synced += 1

    def elapsed_time(self, end):
        return end.clock.at[end] - self.clock.at[self]


class _Graph:
    """A captured graph's stand-in: each replay records its spans' events
    at new times."""

    def __init__(self):
        self.at = {}
        self.replays = 0
        self.events = []

    def replay(self):
        self.replays += 1
        for i, ev in enumerate(self.events):
            self.at[ev] = self.replays * 10.0 + i * self.replays


def test_every_replay_records_and_reads_the_captured_spans():
    graph = _Graph()
    captured = []
    with profiling.tracing(), profiling.captured_spans() as kept:
        for name in ("segtpu.test.a", "segtpu.test.b"):
            with profiling.span(name):
                pass
    assert profiling.collect() == []      # a capture's spans are the graph's
    for s in kept:
        s.events = (_Event(graph), _Event(graph))
        graph.events += s.events
        captured.append(s)
    prog = aot._Program(lambda x: x, graph=graph, static_in=(torch.zeros(1),),
                        static_out=torch.zeros(1), aot_hit=True, launches=5,
                        spans=tuple(captured))
    with profiling.tracing():
        for _ in range(3):
            with profiling.span("segtpu.test.call"):
                prog(torch.ones(1))
    spans = profiling.collect()
    calls = [s for s in spans if s["name"] == "segtpu.test.call"]
    assert len(calls) == 3
    for k, call in enumerate(calls, 1):
        kids = [s for s in spans if s["parent"] == call["id"]]
        assert [s["name"] for s in kids] == ["segtpu.test.a", "segtpu.test.b"]
        # replay k records event i at 10 k + i k: each span reads k
        assert [s["device_ms"] for s in kids] == [k, k]
        assert all(s["host_ms"] is None and s["request"] == call["request"]
                   for s in kids)
    # untraced, a replay records nothing
    prog(torch.ones(1))
    assert profiling.collect() == [] and graph.replays == 4


# ------------------------------------------------------------- counters


def test_eager_calls_and_launches_count_on_the_cpu():
    seg = Segmenter(_model(), device="cpu")
    assert (seg.replays, seg.eager_calls, seg.captures, seg.launches) == (
        0, 0, 0, 0)
    seg.predict(_imgs((1, 64, 64, 3)))
    seg.predict_batch(torch.from_numpy(_imgs((2, 64, 64, 3))))
    list(seg.predict_stream([_imgs((64, 64, 3))] * 2))
    seg.infer(torch.from_numpy(_imgs((1, 64, 64, 3))))
    # the CPU runs the plain versions: no kernel, no graph
    assert (seg.replays, seg.eager_calls, seg.captures, seg.launches) == (
        0, 5, 0, 0)


# -------------------------------------------- the benchmark's grouping


def test_benchmark_groups_spans_by_request():
    spans = [
        {"id": 1, "name": "segtpu.train.step", "request": 4, "parent": None,
         "host_ms": 9.0, "device_ms": 8.0},
        {"id": 2, "name": "segtpu.train.forward", "request": 4, "parent": 1,
         "host_ms": 3.0, "device_ms": 5.0},
        {"id": 3, "name": "segtpu.train.bn", "request": 4, "parent": 2,
         "host_ms": 1.0, "device_ms": 1.5},
        {"id": 4, "name": "segtpu.train.bn", "request": 4, "parent": 2,
         "host_ms": 1.0, "device_ms": 0.5},
        {"id": 5, "name": "segtpu.train.step", "request": 5, "parent": None,
         "host_ms": 7.0, "device_ms": 6.0},
        {"id": 6, "name": "segtpu.train.shard", "request": 5, "parent": None,
         "host_ms": 1.0, "device_ms": 1.0}]
    groups = by_request(spans, "segtpu.train.step")
    assert [r["request"] for r, _ in groups] == [4, 5]
    assert device_ms(groups[0][1], "bn") == 2.0
    assert device_ms(groups[0][1], "forward") == 5.0
    assert device_ms(groups[1][1], "bn") == 0
    assert {k: len(v) for k, v in groups[1][1].items()} == {"step": 1,
                                                              "shard": 1}


# ------------------------------------------------------------- the card


def _card_engine(family, dev):
    return Segmenter(_model(family, device=dev), device=dev)


def _frames(dev, n=8, h=1024, w=2048, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, (n, h, w, 3), generator=g, device=dev,
                         dtype=torch.uint8)


@pytest.mark.card
def test_card_graph_spans_are_read_for_every_replay(card):
    seg = _card_engine("micro", card)
    imgs = _frames(card, 2, 256, 512)
    with profiling.tracing():
        for _ in range(5):
            seg.predict_batch(imgs)
        torch.cuda.synchronize(card)
    spans = profiling.collect()
    assert seg.captures == 1 and seg.replays == 5
    calls = [s for s in spans if s["name"] == "segtpu.engine.replay"]
    assert len(calls) == 5
    for call in calls:
        kids = [s for s in spans if s["parent"] == call["id"]]
        names = [s["name"] for s in kids]
        # the first call's warm-up ran eagerly before the capture
        assert names[-4:] == LAYERS
        assert all(s["device_ms"] is not None and s["device_ms"] > 0
                   for s in kids)
    # five replays, each with its own readings of the graph's four spans
    replayed = [s for s in spans if s["name"] in LAYERS
                and s["host_ms"] is None]
    assert len(replayed) == 20


@pytest.mark.card
@pytest.mark.parametrize("family", ["micro", "template"])
def test_card_layers_add_up_to_the_replay(card, family):
    seg = _card_engine(family, card)
    imgs = _frames(card)
    with profiling.tracing():
        seg.predict_batch(imgs)
        prog = seg._cache[((1024, 2048), False, tuple(imgs.shape),
                           str(seg.device), "traced")]
        assert [s.name for s in prog.spans] == LAYERS
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(3):
            prog.graph.replay()
        torch.cuda.synchronize(card)
        totals, sums = [], []
        for _ in range(10):
            start.record()
            prog.graph.replay()
            end.record()
            end.synchronize()
            totals.append(start.elapsed_time(end))
            sums.append(sum(s.events[0].elapsed_time(s.events[1])
                            for s in prog.spans))
    total, layers_ms = float(np.median(totals)), float(np.median(sums))
    assert abs(layers_ms - total) <= 0.02 * total, (layers_ms, total)


# one b8 1024x2048 call's kernel launches: arch0's 33 wrapper calls with
# its 3 cell_op_chw calls as 9 node launches (each collects one node, so
# no collect launch); template0's 34
CARD_LAUNCHES = {"micro": 39, "template": 34}


@pytest.mark.card
@pytest.mark.parametrize("family", ["micro", "template"])
def test_card_launches_match_the_kernel_table(card, family):
    seg = _card_engine(family, card)
    imgs = _frames(card)
    seg.infer(imgs)
    assert seg.launches == CARD_LAUNCHES[family] and seg.eager_calls == 1
    seg.predict_batch(imgs)        # warm-up (eager) and capture
    assert seg.captures == 1
    assert seg.launches == 3 * CARD_LAUNCHES[family]
    prog = seg._cache[((1024, 2048), False, tuple(imgs.shape),
                       str(seg.device))]
    assert prog.launches == CARD_LAUNCHES[family]
    for _ in range(4):
        seg.predict_batch(imgs)
    assert seg.replays == 5
    assert seg.launches == 7 * CARD_LAUNCHES[family]


@pytest.mark.card
def test_card_profiler_ranges_nest_as_the_spans(card):
    from torch.profiler import ProfilerActivity, profile
    seg = _card_engine("micro", card)
    imgs = _frames(card, 2, 256, 512)
    with profiling.tracing():
        seg.predict_batch(imgs)
        torch.cuda.synchronize(card)
        profiling.collect()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            for _ in range(3):
                seg.predict_batch(imgs)
            torch.cuda.synchronize(card)
    spans = profiling.collect()
    host = [(e.time_range.start, e.time_range.end, e.name)
            for e in p.events() if e.device_type == torch.autograd.DeviceType.CPU]
    replays = [r for r in host if r[2] == "segtpu.engine.replay"]
    predicts = [r for r in host if r[2] == "segtpu.engine.predict"]
    launches = [r for r in host if r[2] == "cudaGraphLaunch"]
    assert len(replays) == len(predicts) == 3
    assert len([s for s in spans if s["name"] == "segtpu.engine.replay"]) == 3
    for a, b, _ in replays:
        assert sum(a <= s and e <= b for s, e, _ in launches) == 1
        assert sum(pa <= a and b <= pb for pa, pb, _ in predicts) == 1
