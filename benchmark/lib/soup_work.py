"""The work of the flat cluster walk (B1 ``closest_kernel``, B2
``shadow_kernel``) from the program's own counters, and its operation
bound, for the per-layer metrics of ``metrics/``.

The program's B1 and B2 wrappers (``rayzath_tpu_torch.ops.traverse_cluster``
``cluster_closest`` and ``cluster_shadow``) keep, over the whole run,
``launches`` and ``rays`` on the host (a replayed graph advances them as it
advances the launches) and ``work`` on the device: the cluster tests (one
ray against one cluster), the triangle tests (one ray against one real
triangle of a cluster it tests: a cluster of ``cnt`` triangles is tested
in its slots ``j < cnt`` only, and its padding slots cost nothing but
idle lanes) and the slab tests (one ray's gate against one box of the
cluster or group table) that the kernel made, on the flat and the grouped
walk alike. Every function here returns None where the program keeps no
such counter (a program older than them) or the trace holds no launch of
the kernel.

The bound of one launch is its operations over the card's float32 peak
outside the tensor cores (``inst_work.F32_OPS_S``, 67 TFLOP/s): a
triangle test costs ``inst_work.TEST_OPS`` (49) operations, as on the
instanced walk, and a slab test is what ``csrc/rz_cluster.cuh`` ``slab``
and its caller's gate compute:

* per axis, the two plane distances ``(box - o) * inv``: a subtraction
  and a multiplication each, 12 operations over the three axes;
* ``tmin``, the largest of the three per-axis smaller distances: three
  mins and two maxes, 5; ``tmax`` likewise, 5;
* the gate's three compares (``tmax >= near``, ``tmin <= tmax``, ``tmin
  <= reach``), 3; B1's widened reach (``gate_t``) is left out, so the
  count holds for B2 too:

25 operations. So a launch of mean ``t`` triangle tests and ``s`` slab
tests needs at least (49 * t + 25 * s) / 67e12 seconds. The means are the
counters' totals over the launches; times the launches of the traced
window per pass they give the bound a pass, which the share holds against
the kernels' device time a pass in the same window. The work is what the
kernels made, not what the rays needed (the gates are conservative), so
the share reads the arithmetic's efficiency on the walk the kernels
chose: the lanes that idle on a cluster's padding slots, the ranking, the
votes and the staging all count as time and as no operation.
"""
from __future__ import annotations

import re

from .inst_work import F32_OPS_S, TEST_OPS

#: the kernels by their device function names (whole words)
KERNELS = {"closest": re.compile(r"\bclosest_kernel\b"),
           "shadow": re.compile(r"\bshadow_kernel\b")}
#: their wrappers in ``rayzath_tpu_torch.ops.traverse_cluster``
WRAPPERS = {"closest": "cluster_closest", "shadow": "cluster_shadow"}
SLAB_OPS = 25               # f32 operations of one slab test and its gate
#: the counts that the readers need of a kernel's ``work``
WORK = ("cluster_tests", "triangle_tests", "slab_tests")


def counts(kernel: str):
    """``{"launches", "rays", "cluster_tests", "triangle_tests",
    "slab_tests"}`` of ``kernel`` (a key of :data:`KERNELS`) over the run
    so far, or None."""
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    f = getattr(tc, WRAPPERS[kernel], None)
    work = getattr(f, "work", None)
    if work is None or not getattr(f, "launches", 0) or not getattr(f, "rays", 0):
        return None
    c = dict(work.read(), launches=f.launches, rays=f.rays)
    return c if all(k in c for k in WORK) else None


def device_ms(trace, kernel: str) -> tuple:
    """(device ms, launches) of ``kernel``'s events in ``trace``."""
    pat = KERNELS[kernel]
    spans = [b - a for n, a, b in trace.device if pat.search(n)]
    return sum(spans) / 1e3, len(spans)


def traced_counts(trace):
    """[(kernel, device ms, traced launches, counts)] of the kernels that
    the progressive ``trace`` launched, or None where it launched neither
    or the program counts nothing for one of them."""
    if trace.kind != "progressive" or not trace.units:
        return None
    out = []
    for kernel in KERNELS:
        ms, launches = device_ms(trace, kernel)
        if not launches:
            continue
        c = counts(kernel)
        if c is None:
            return None
        out.append((kernel, ms, launches, c))
    return out or None


def ops_per_launch(c: dict) -> float:
    """f32 operations of a mean launch with the counts ``c``."""
    return (TEST_OPS * c["triangle_tests"]
            + SLAB_OPS * c["slab_tests"]) / c["launches"]


def tests_per_ray(trace):
    """B1 + B2's cluster tests over the rays launched into them, or None."""
    found = traced_counts(trace)
    if found is None:
        return None
    return (sum(c["cluster_tests"] for *_, c in found)
            / sum(c["rays"] for *_, c in found))


def bound_share(trace):
    """The bound of B1 + B2 a pass over their device ms a pass, in %, or
    None."""
    found = traced_counts(trace)
    if found is None:
        return None
    bound_ms = sum(n * ops_per_launch(c) / F32_OPS_S * 1e3
                   for _, _, n, c in found)
    busy_ms = sum(ms for _, ms, _, _ in found)
    return 100.0 * bound_ms / busy_ms if busy_ms > 0.0 else None
