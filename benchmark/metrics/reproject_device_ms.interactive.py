"""Device ms of a reprojection: per ``rz::reproject`` range (the
renderer's reprojection after a camera move, ending in a synchronise, so
every operation it launched ends inside it), the union of the device
operations that lie inside the range, averaged over the ranges."""
from benchmark.lib.trace import union_us


def read(trace):
    if trace.kind != "interactive" or not trace.device:
        return None
    ranges = [(a, b) for n, a, b in trace.host if n == "rz::reproject"]
    if not ranges:
        return None
    busy = sum(union_us([(a, b) for _, a, b in trace.device
                         if s <= a and b <= e]) for s, e in ranges)
    return busy / len(ranges) / 1e3
