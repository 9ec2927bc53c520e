"""Per-stage timing with EMA smoothing, and the port's spans.

TPU-native equivalent of the reference ``TimeTable`` (RayZath/engine_parts.hpp:50-74):
named stage entries with exponentially smoothed durations (avg factor 0.05) plus a
separately tracked wait time, surfaced as a debug string.

:class:`span` marks a layer boundary of the render path (``rz::render``,
``rz::compile_world``, ``rz::cycle``, ...; ``README.md`` lists them). While
``torch.profiler`` records, a span is a ``record_function`` range
``rz::<name>``, on the trace's timeline beside the device's kernels and
nested in the span that encloses it. Always, its host duration is added to a
process-wide table of every span name (:func:`totals`), and, given a
``TimeTable`` and an entry, set as that entry. Spans stay in memory; nothing
is written to disk.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

AVG_FACTOR = 0.05
#: the prefix of a span's profiler range
PREFIX = "rz::"


class TimeTable:
    def __init__(self):
        self._entries: "OrderedDict[str, tuple[float, float]]" = OrderedDict()

    def set(self, name: str, dt_ms: float) -> None:
        last, avg = self._entries.get(name, (dt_ms, dt_ms))
        avg = avg + (dt_ms - avg) * AVG_FACTOR
        self._entries[name] = (dt_ms, avg)

    def entries(self):
        return {k: v for k, v in self._entries.items()}

    def __str__(self) -> str:
        width = max((len(k) for k in self._entries), default=0)
        lines = [
            f"{name:<{width}} : {last:8.3f} ms (avg {avg:8.3f} ms)"
            for name, (last, avg) in self._entries.items()
        ]
        return "\n".join(lines)


_LOCK = threading.Lock()
#: span name -> [count, total ns, largest ns]
_TOTALS: dict = {}


class span:
    """``with span(name, table=None, entry=None) as s:`` times the block on
    the host clock (``s.ms`` once it exits). A profiler range
    ``rz::<name>`` is opened only while ``torch.profiler`` records; with
    the profiler off a span costs two clock reads and one locked update of
    :func:`totals`. ``table.set(entry, ms)`` when the block did not
    raise."""

    __slots__ = ("name", "table", "entry", "ms", "_t0", "_range")

    def __init__(self, name: str, table: "TimeTable | None" = None,
                 entry: "str | None" = None):
        self.name, self.table, self.entry = name, table, entry
        self.ms = 0.0
        self._range = None

    def __enter__(self) -> "span":
        if _profiler._is_profiler_enabled:
            self._range = record_function(PREFIX + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, kind, value, tb) -> None:
        dt = time.perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(kind, value, tb)
            self._range = None
        with _LOCK:
            t = _TOTALS.get(self.name)
            if t is None:
                _TOTALS[self.name] = [1, dt, dt]
            else:
                t[0] += 1
                t[1] += dt
                if dt > t[2]:
                    t[2] = dt
        self.ms = dt / 1e6
        if self.table is not None and kind is None:
            self.table.set(self.entry, self.ms)


def totals() -> dict:
    """A copy of every span's record since the process started: name (no
    prefix) -> ``{"count", "total_ms", "max_ms"}``."""
    with _LOCK:
        return {name: {"count": n, "total_ms": total / 1e6, "max_ms": top / 1e6}
                for name, (n, total, top) in _TOTALS.items()}
