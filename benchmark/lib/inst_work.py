"""The work of the instanced walk (B3 ``closest_inst_kernel``, B4
``shadow_inst_kernel``) from the program's own counters, and its operation
bound, for the per-layer metrics of ``metrics/``.

The program's B3 and B4 wrappers (``rayzath_tpu_torch.ops.traverse_cluster``
``cluster_closest_inst`` and ``cluster_shadow_inst``) keep, over the whole
run, ``launches`` and ``rays`` on the host (a replayed graph advances them
as it advances the launches) and ``work`` on the device: the instance
visits (a ray moved into an instance's object space, ``to_object``) and the
(instance, cluster) tests its kernel made. Every function here returns None
where the program keeps no such counter (a program older than them) or
never launched the kernel.

The bound of one launch is its operations over the card's float32 peak
outside the tensor cores, 67 TFLOP/s (NVIDIA's H100 SXM data sheet): the
work the kernel made, at the constants its header (``csrc/rz_cluster.cuh``,
``cluster_closest_inst.cu``) states:

* a cluster test is one ray against one cluster of CT = 128 triangle
  slots, dealt one slot per lane to a warp of 32 (``test_ray``,
  ``shadow_test_ray``); a lane past the cluster's triangle count idles but
  holds its issue slot, so a test costs 128 ray-triangle tests;
* a ray-triangle test is the projection ``project`` and its caller's
  compares: six dot products (3 x (3 mul + 3 add) + 3 x (3 mul + 2 add) =
  33), the DET_EPS nudge (3), the negation and the division (2), b1 and b2
  (4), the inside test (5) and the two t compares (2): 49 operations;
* an instance visit is ``to_object``: o' 3 x (3 mul + 3 add) and d'
  3 x (3 mul + 2 add), 33 operations.

So a launch of mean ``v`` instance visits and ``c`` cluster tests needs at
least (128 * 49 * c + 33 * v) / 67e12 seconds. The means are the counters'
totals over the launches; times the launches of the traced window per
pass they give the bound a pass, which the share holds against the
kernels' device time a pass in the same window. The work is what the
kernels made, not what the rays needed (culling is conservative), so the
share reads the arithmetic's efficiency on the walk the kernels chose.
"""
from __future__ import annotations

import re

#: the kernels by their device function names (whole words)
KERNELS = {"closest_inst": re.compile(r"\bclosest_inst_kernel\b"),
           "shadow_inst": re.compile(r"\bshadow_inst_kernel\b")}
#: their wrappers in ``rayzath_tpu_torch.ops.traverse_cluster``
WRAPPERS = {"closest_inst": "cluster_closest_inst",
            "shadow_inst": "cluster_shadow_inst"}
SLOTS = 128                 # triangle slots a cluster test takes (CT)
TEST_OPS = 49               # f32 operations of one ray-triangle test
TO_OBJECT_OPS = 33          # f32 operations of one instance visit
F32_OPS_S = 67e12           # H100 SXM float32 outside the tensor cores


def counts(kernel: str):
    """``{"launches", "rays", "instance_visits", "cluster_tests"}`` of
    ``kernel`` (a key of :data:`KERNELS`) over the run so far, or None."""
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    f = getattr(tc, WRAPPERS[kernel], None)
    work = getattr(f, "work", None)
    if work is None or not getattr(f, "launches", 0) or not getattr(f, "rays", 0):
        return None
    return dict(work.read(), launches=f.launches, rays=f.rays)


def device_ms(trace, kernel: str) -> tuple:
    """(device ms, launches) of ``kernel``'s events in ``trace``."""
    pat = KERNELS[kernel]
    spans = [b - a for n, a, b in trace.device if pat.search(n)]
    return sum(spans) / 1e3, len(spans)


def ops_per_launch(c: dict) -> float:
    """f32 operations of a mean launch with the counts ``c``."""
    return (SLOTS * TEST_OPS * c["cluster_tests"]
            + TO_OBJECT_OPS * c["instance_visits"]) / c["launches"]


def bound_share(trace):
    """The bound of B3 + B4 a pass over their device ms a pass, in %, or
    None where the trace holds neither kernel or the program counts
    nothing."""
    if trace.kind != "progressive" or not trace.units:
        return None
    bound_ms = busy_ms = 0.0
    for kernel in KERNELS:
        ms, launches = device_ms(trace, kernel)
        if not launches:
            continue
        c = counts(kernel)
        if c is None:
            return None
        bound_ms += launches * ops_per_launch(c) / F32_OPS_S * 1e3
        busy_ms += ms
    if busy_ms <= 0.0:
        return None
    return 100.0 * bound_ms / busy_ms
