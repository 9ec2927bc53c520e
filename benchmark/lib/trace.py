"""Device time from a ``torch.profiler`` trace of part of a run's window.

Busy time is the union of the device-side intervals (kernels, copies,
fills): the host-side ``aten::*`` rows of a trace carry the time of the
kernels they launched, so only device-side events are read. Kernels are
grouped by name (:data:`GROUPS`); whatever no group names is the
elementwise rest, ``other``. The arithmetic is that of the renderer's
``utils/profiling.py`` (its ``union_us`` and ``GROUPS``), frozen here with
the training step's backward kernels added, so that a change to the
renderer cannot change the yardstick.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

#: device-time groups by kernel function name (whole words of the name)
GROUPS = (
    ("traversal", ("closest_kernel", "shadow_kernel", "closest_inst_kernel",
                   "shadow_inst_kernel")),
    ("shadow_backward", ("shadow_grad_kernel", "shadow_inst_grad_kernel")),
    ("gather", ("gather_kernel", "gather_vec_kernel")),
    ("gather_backward", ("grad_block_kernel", "grad_sum_kernel",
                         "grad_atomic_kernel", "round_kernel")),
    ("draw", ("uniform_kernel", "uniform_keyed_kernel")),
)
#: the ray sort's kernels (torch's top-k and sorts): parts of names
SORT = ("topk", "TopK", "Sort", "sort")
_WORDS = [(g, re.compile(r"\b(" + "|".join(names) + r")\b"))
          for g, names in GROUPS]


def group_of(name: str) -> str:
    for group, pattern in _WORDS:
        if pattern.search(name):
            return group
    if any(k in name for k in SORT):
        return "sort"
    return "other"


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals, in microseconds."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


@dataclass
class Trace:
    """The traced part of a window: its device events (name, start us, end
    us), host ranges (name, start us, end us), wall seconds, and how many
    units of work (passes, steps or frames) it holds."""
    kind: str
    units: int = 0
    wall_s: float = 0.0
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    #: the program's own timers over the whole window, name -> [ms, ...]
    timers: dict = field(default_factory=dict)

    def busy_us(self) -> float:
        return union_us([(a, b) for _, a, b in self.device])

    def group_us(self, group: str) -> float:
        return sum(b - a for n, a, b in self.device if group_of(n) == group)

    def has(self, group: str) -> bool:
        return any(group_of(n) == group for n, _, _ in self.device)

    def idle_share(self) -> float:
        return 1.0 - self.busy_us() / 1e6 / self.wall_s

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (by group and kernel
        name) and the longest idle gaps, each named by the innermost host
        range open at its middle."""
        ops: dict = {}
        for n, a, b in self.device:
            key = f"{group_of(n)}: {n[:120]}"
            ops[key] = ops.get(key, 0.0) + (b - a) / 1e6
        spans = sorted((a, b) for _, a, b in self.device)
        gaps, end = [], None
        for a, b in spans:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in gaps[:top]:
            mid = 0.5 * (a + b)
            inner = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            named.append([min(inner)[1] if inner else "host", (b - a) / 1e6])
        return {"device_ops": sorted(([k, v] for k, v in ops.items()),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": named}


def traced(kind: str, body, units_of, device) -> Trace:
    """Run ``body()`` under ``torch.profiler`` (CPU and, on a card, CUDA
    activity), synchronised at both ends; ``units_of(result)`` counts its
    units."""
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = body()
        sync()
        wall = time.perf_counter() - t0
    tr = Trace(kind, units=units_of(out), wall_s=wall)
    for e in prof.events():
        rng = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # a host range (``span``) is mirrored on the device's timeline
            # as an annotation: no operation ran for it
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(SPAN)):
                tr.device.append(rng)
        elif e.device_type == DeviceType.CPU:
            tr.host.append(rng)
    return tr


#: the prefix of the harness's own host ranges
SPAN = "bench::"


def span(name: str):
    """A host range ``bench::<name>`` in a trace."""
    return record_function(SPAN + name)
