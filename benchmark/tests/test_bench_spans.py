"""The readers of the renderer's spans (``metrics/*.py``), each fed a
hand-built trace with known ranges, operations and gaps, and a trace
without its spans."""
from __future__ import annotations

import pytest

from _tiny import ROOT  # noqa: F401  (sets sys.path)

from benchmark.lib import cells  # noqa: E402
from benchmark.lib.trace import Trace  # noqa: E402
from rayzath_tpu_torch.utils import timing  # noqa: E402

SPAN_METRICS = ("compile_s.setup", "capture_s.setup", "launch_gap_ms.render",
                "reproject_device_ms.interactive", "reset_ms.interactive",
                "readback_ms.interactive")


def read(metric: str, trace):
    return cells.reader(metric)(trace)


def progressive_trace() -> Trace:
    """Two cycles, 3,000 us apart: the first's first operation 2,300 us
    after its ``rz::render`` opens, of which the profiler's buffer request
    took 2,000; the second's 1,100 us after (an operation of the harness's
    record before it, launched earlier, is not the cycle's)."""
    tr = Trace("progressive", units=16, wall_s=0.004)
    tr.host = [("bench::render", 0.0, 2900.0), ("rz::render", 10.0, 2890.0),
               ("rz::cycle", 20.0, 2880.0),
               ("Activity Buffer Request", 25.0, 2025.0),
               ("bench::record", 2900.0, 2990.0),
               ("bench::render", 3000.0, 5000.0), ("rz::render", 3005.0, 4990.0)]
    tr.device = [("closest_kernel", 2310.0, 2500.0), ("add", 2500.0, 2800.0),
                 ("index_select", 2995.0, 3002.0),
                 ("closest_kernel", 4105.0, 4500.0)]
    return tr


def interactive_trace() -> Trace:
    """Two frames. Frame 1: reset 100-300 us, a reprojection 300-1,300 us
    holding operations at 400-600 and 500-700 (union 300 us) and one at
    1,250-1,350 that ends after it, readback 2,000-2,250. Frame 2: reset
    3,000-3,100, a reprojection 3,100-3,600 holding 3,200-3,300, readback
    3,900-3,950. An operation before the first range is no one's."""
    tr = Trace("interactive", units=2, wall_s=0.004)
    tr.host = [("bench::frame", 0.0, 2500.0), ("rz::reset", 100.0, 300.0),
               ("rz::render", 300.0, 1900.0), ("rz::reproject", 300.0, 1300.0),
               ("rz::image", 1950.0, 2300.0), ("rz::readback", 2000.0, 2250.0),
               ("bench::frame", 2900.0, 4000.0), ("rz::reset", 3000.0, 3100.0),
               ("rz::reproject", 3100.0, 3600.0),
               ("rz::readback", 3900.0, 3950.0)]
    tr.device = [("fill", 50.0, 350.0), ("closest_kernel", 400.0, 600.0),
                 ("sort", 500.0, 700.0), ("copy", 1250.0, 1350.0),
                 ("closest_kernel", 3200.0, 3300.0)]
    return tr


def test_launch_gap_is_the_mean_wait_for_a_cycles_first_operation():
    # (2310 - 10 - 2000) and (4105 - 3005): the record's operation began
    # before the second
    assert read("launch_gap_ms.render", progressive_trace()) == \
        pytest.approx((300.0 + 1100.0) / 2 / 1e3)


def test_reprojection_device_time_is_the_union_inside_its_ranges():
    # frame 1: 400-700 (the 1,250-1,350 copy ends outside); frame 2: 100
    assert read("reproject_device_ms.interactive", interactive_trace()) == \
        pytest.approx((300.0 + 100.0) / 2 / 1e3)


@pytest.mark.parametrize("metric, want_us", [
    ("reset_ms.interactive", (200.0 + 100.0) / 2),
    ("readback_ms.interactive", (250.0 + 50.0) / 2)])
def test_host_ms_a_frame_in_a_span(metric, want_us):
    assert read(metric, interactive_trace()) == pytest.approx(want_us / 1e3)


@pytest.mark.parametrize("metric, span", [("compile_s.setup", "compile_world"),
                                          ("capture_s.setup", "capture")])
def test_setup_readers_sum_the_runs_spans(metric, span, monkeypatch):
    totals = {span: {"count": 2, "total_ms": 2345.0, "max_ms": 2000.0},
              "render": {"count": 9, "total_ms": 1.0, "max_ms": 0.5}}
    monkeypatch.setattr(timing, "totals", lambda: totals)
    for kind in ("progressive", "interactive"):
        assert read(metric, Trace(kind)) == pytest.approx(2.345)
    assert read(metric, Trace("train")) is None
    del totals[span]
    assert read(metric, Trace("progressive")) is None


def test_setup_readers_read_nothing_from_a_program_without_totals(monkeypatch):
    monkeypatch.delattr(timing, "totals")
    for metric in ("compile_s.setup", "capture_s.setup"):
        assert read(metric, Trace("progressive")) is None


@pytest.mark.parametrize("metric", SPAN_METRICS[2:])
def test_span_readers_read_nothing_without_their_spans(metric):
    for tr in (progressive_trace(), interactive_trace()):
        tr.host = [r for r in tr.host if not r[0].startswith("rz::")]
        assert read(metric, tr) is None
    assert read(metric, Trace("none")) is None


def test_each_span_metric_is_in_the_manifest_for_the_cells_it_reads():
    entries = {m["name"]: m for m in cells.manifest()["per_layer"]}
    for metric in SPAN_METRICS:
        m = entries[metric]
        assert m["source"] == "program_span" and m["workloads"]
        kind = {"compile_s.setup": None, "capture_s.setup": None,
                "launch_gap_ms.render": "progressive"}.get(metric, "interactive")
        for cell in m["workloads"]:
            assert kind is None or cells.load(cell).traffic["kind"] == kind
