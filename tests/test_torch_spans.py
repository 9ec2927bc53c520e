"""The port's spans (``rayzath_tpu_torch/utils/timing.py``): the ``rz::``
ranges of a render under ``torch.profiler`` and their nesting, the span
totals, the renderer's ``TimeTable`` entries fed by the spans, no profiler
range while the profiler is off, totals from many threads, and the
capture spans of the render cycle and the training step (their graphs
replaced by recorders: the CPU has none)."""
from __future__ import annotations

import contextlib
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rayzath_tpu_torch as rt
from rayzath_tpu_torch.engine import cycle as tcycle
from rayzath_tpu_torch.parallel import train
from rayzath_tpu_torch.utils import timing

RES = 12

#: span -> the span it opens in, in a render of a moved camera and its image
PARENT = {"render": None, "compile_world": "render", "geometry": "compile_world",
          "atlas": "compile_world", "upload": "compile_world",
          "reset": "render", "reproject": "render", "cycle": "render",
          "capture": "cycle", "replay": "cycle", "image": None,
          "tonemap": "image", "readback": "image"}


def ranges(prof) -> list:
    """The ``rz::`` ranges of a trace: (name without prefix, start, end)."""
    return [(e.name[len(timing.PREFIX):], e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith(timing.PREFIX)]


def parent_of(r, spans) -> str | None:
    """The innermost other span that holds ``r``."""
    name, a, b = r
    holders = [(e - s, n) for n, s, e in spans
               if (n, s, e) != r and s <= a and b <= e]
    return min(holders)[1] if holders else None


def delta(before: dict, name: str) -> tuple:
    """(count, total ms) that ``name`` gained since ``before``."""
    now = timing.totals().get(name, {"count": 0, "total_ms": 0.0})
    was = before.get(name, {"count": 0, "total_ms": 0.0})
    return now["count"] - was["count"], now["total_ms"] - was["total_ms"]


def move(cam) -> None:
    cam.position = cam.position + np.asarray([0.02, 0.0, 0.0], np.float32)
    cam.touch()


class FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def graphed(monkeypatch):
    """The render cycle's graph route on the CPU: the capture returns a
    recorder that a replay advances, and ``torch.cuda``'s device and
    synchronize do nothing."""
    graphs = []

    def capture(warm_up, body, what, counted=tcycle.COUNTED):
        graphs.append(FakeGraph())
        return graphs[-1], ()

    monkeypatch.setattr(tcycle, "capture", capture)
    monkeypatch.setattr(tcycle.RenderCycle, "captures_passes",
                        lambda self, scene, cfg: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    return graphs


def render_moved(r):
    """Render, move the camera (``temporal_blend`` > 0), render, image."""
    cam = r.world.cameras[0]
    assert cam.temporal_blend > 0
    r.render(rpp=1)
    move(cam)
    r.render(rpp=1)
    return r.image()


@pytest.mark.parametrize("route", ["eager", "graph"])
def test_render_spans_nest_under_the_profiler(route, request):
    graphs = request.getfixturevalue("graphed") if route == "graph" else None
    r = rt.Renderer(rt.scenes.textured_room(RES, RES), device="cpu")
    before = timing.totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render_moved(r)
    spans = ranges(prof)
    names = [n for n, _, _ in spans]
    want = {"render": 2, "compile_world": 1, "geometry": 1, "atlas": 1,
            "upload": 1, "reset": 2, "reproject": 1, "cycle": 2, "replay": 2,
            "capture": int(route == "graph"), "image": 1, "tonemap": 1,
            "readback": 1}
    assert {n: names.count(n) for n in want} == want
    assert set(names) <= set(want)          # no wait: the CPU does not sync
    for s in spans:
        assert parent_of(s, spans) == PARENT[s[0]], s
    for name, n in want.items():
        assert delta(before, name)[0] == n, name
    if graphs is not None:
        assert len(graphs) == 1 and graphs[0].replays == 2


def test_time_table_entries_are_their_spans():
    r = rt.Renderer(rt.scenes.textured_room(RES, RES), device="cpu")
    entries = {"compile_world": "update world", "reproject": "temporal reproject",
               "cycle": "trace", "image": "tone mapping"}
    before = timing.totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render_moved(r)
    table = r.time_table.entries()
    assert list(table) == ["update world", "trace", "temporal reproject",
                           "tone mapping"]
    spans = ranges(prof)
    for name, entry in entries.items():
        last = table[entry][0]
        # the entry is the span's last duration, inside its profiler range
        last_range = [b - a for n, a, b in spans if n == name][-1]
        assert 0 < last <= last_range / 1e3 + 0.01, name
        count, total = delta(before, name)
        if count == 1:
            assert last == pytest.approx(total, rel=1e-9, abs=1e-6), name
    assert r.debug_info().splitlines()[0].startswith("update world")


def test_no_profiler_range_while_the_profiler_is_off(monkeypatch):
    entered = []

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with the profiler off")

    monkeypatch.setattr(timing, "record_function", refuse)
    r = rt.Renderer(rt.scenes.textured_room(RES, RES), device="cpu")
    before = timing.totals()
    render_moved(r)
    assert delta(before, "render")[0] == 2 and delta(before, "image")[0] == 1

    # while it records, each span is entered as one
    def count(name):
        entered.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(timing, "record_function", count)
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("outer"):
            with timing.span("inner"):
                pass
    assert entered == ["rz::outer", "rz::inner"]


def test_spans_from_many_threads_add_up():
    """The viewer renders on one thread and serves images on others: no
    span of any thread is lost from the totals."""
    threads, per = 8, 2000
    table = timing.TimeTable()
    before = timing.totals()
    start = threading.Barrier(threads)
    interval = sys.getswitchinterval()

    def work(k):
        start.wait(timeout=30)
        for _ in range(per):
            with timing.span("test_threads", table, f"thread {k}"):
                pass

    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    count, total = delta(before, "test_threads")
    assert count == threads * per
    got = timing.totals()["test_threads"]
    assert 0 <= got["max_ms"] <= total
    assert sorted(table.entries()) == sorted(f"thread {k}" for k in range(threads))


def test_a_span_times_a_block_that_raises():
    table = timing.TimeTable()
    before = timing.totals()
    with pytest.raises(KeyError):
        with timing.span("test_raises", table, "raised"):
            raise KeyError("x")
    assert delta(before, "test_raises")[0] == 1
    assert "raised" not in table.entries()      # only a finished block sets it


def test_training_step_capture_ms_is_its_span(monkeypatch):
    monkeypatch.setattr(train, "capture", lambda *a: (FakeGraph(), ()))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    step = train._Step("cpu")
    before = timing.totals()
    graph = step._captured()
    count, total = delta(before, "capture")
    assert isinstance(graph, FakeGraph) and step.captures == 1 and count == 1
    assert step.capture_ms == pytest.approx(total, rel=1e-9, abs=1e-6)
    assert step._captured() is graph and delta(before, "capture")[0] == 1
