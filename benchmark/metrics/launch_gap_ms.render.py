"""Mean ms from the start of a traced cycle's ``rz::render`` range (the
renderer's ``Renderer.render``) to the start of the first device operation
at or after it: the host's time before the cycle's first launch reaches
the device. The profiler's own host work in that time (its buffer
requests and flushes, which open a trace) is left out: it is no
program's."""
import bisect

from benchmark.lib.trace import union_us

#: the profiler's own host events (kineto's overhead rows)
PROFILER = ("Activity Buffer Request", "Buffer Flush")


def read(trace):
    if trace.kind != "progressive" or not trace.device:
        return None
    starts = sorted(a for _, a, _ in trace.device)
    own = [(a, b) for n, a, b in trace.host if n in PROFILER]
    gaps = []
    for name, a, _ in trace.host:
        if name == "rz::render":
            i = bisect.bisect_left(starts, a)
            if i < len(starts):
                b = starts[i]
                held = union_us([(max(s, a), min(e, b)) for s, e in own
                                 if s < b and e > a])
                gaps.append(b - a - held)
    return sum(gaps) / len(gaps) / 1e3 if gaps else None
