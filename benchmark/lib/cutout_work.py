"""B2's cutout variant (``shadow_kernel<GROUPED, MIN, true>``, the shadow
walk that fetches a texel at each hit of a texture-alpha cutout) from the
program's own counters, and its roofline bound, for the per-layer metrics
of ``metrics/``.

The program's B2 wrapper (``rayzath_tpu_torch.ops.traverse_cluster``
``cluster_shadow``) keeps ``launches`` and ``rays`` on the host, ``work``
on the device (cluster, triangle and slab tests: ``lib/soup_work.py``) and,
beside it, ``fetches``, a device counter of one key, ``cutout_fetches``:
the texels the cutout variant fetched, added once per block. Every
function here returns None where the program keeps no such counter (a
program older than the variant) or the trace holds no launch of the
variant, whose device name carries its third template argument, ``true``.
B2's counters cover all its launches; in a cell whose every B2 launch is
the cutout variant (``cutout_world``: every shadow ray of a soup scene with
cutouts takes it on the card) their means are the variant's.

The bound of one launch is the larger of its operations over the card's
float32 peak outside the tensor cores (``inst_work.F32_OPS_S``, 67
TFLOP/s) and its bytes over HBM's 3.35 TB/s (NVIDIA's H100 SXM data
sheet). A triangle test costs ``inst_work.TEST_OPS`` (49) operations and a
slab test ``soup_work.SLAB_OPS`` (25), as for B2 without cutouts. A fetch
(``csrc/cluster_shadow.cu`` ``cutout_factor`` and ``csrc/rz_texture.cuh``
``fetch<true>``, at a clamp-addressed bilinear colour map) costs these
float32 operations:

* the texture coordinates t0 + b1 (t1 - t0) + b2 (t2 - t0): two
  multiplications and two additions a coordinate, 8;
* the map's transform: u0 = u + tx, v0 = v + ty (2), the rotation u0 c -
  v0 s and u0 s + v0 c (6) and the scales (2), 10;
* the addressing: a clamp to [0, 1 - 1e-6] a coordinate (a max and a min),
  4, and the v flip 1 - v, 1;
* the texel coordinates fx = u w - 0.5 and fy (a multiplication and a
  subtraction each), 4; their floors, 2; the weights ax = fx - floor(fx),
  ay (a subtraction each), 2;
* the bilinear blend: 1 - ax and 1 - ay (2), then per channel (v00 bx +
  v10 ax) by + (v01 bx + v11 ax) ay, six multiplications and three
  additions, 36 over four channels;
* the factor: rgb times the texel's rgb (3), alpha times 1 - its alpha (2),
  5;

76 operations. Left out, so that the bound stays a lower bound: the
integer addressing (the map id's clamp, the texel's cell and the corners'
clamps), the compares of the address mode and of the weights' edge case,
and the sine and cosine of the map's rotation (library calls). Its bytes
are those the fetch reads per texel: the 2x2 block's row of four int32
indices (16 B) and the four RGBA float32 texels (64 B), 80 B; the slot's
map id and texture coordinates and the map's table rows are left out.

So a launch of mean ``t`` triangle tests, ``s`` slab tests and ``f``
fetches needs at least max((49 t + 25 s + 76 f) / 67e12, 80 f / 3.35e12)
seconds. Times the traced launches of the variant a pass, that is the
bound a pass, which the share holds against the variant's traced device
ms a pass. The work is what the kernel made, not what the rays needed
(the slab gates are conservative): the share reads the arithmetic's
efficiency on the walk the kernel chose. So a change that removes wasted
tests (a shadow ray of the leaf canopy makes some 5.5 cluster tests and
up to 210 slab tests through overlapping boxes) lowers the bound with
the time, and the share can fall while ``cutout_shadow_ms_per_pass``
falls: read the two together.
"""
from __future__ import annotations

import re

from .inst_work import F32_OPS_S, TEST_OPS
from .soup_work import SLAB_OPS, WORK

#: the cutout variant by its device name: shadow_kernel<GROUPED, MIN, true>
KERNEL = re.compile(r"\bshadow_kernel<\s*\w+\s*,\s*\d+\s*,\s*true\s*>")
FETCH_OPS = 76              # f32 operations of one texel fetch and factor
FETCH_BYTES = 80            # bytes of one fetch: the block row, four texels
HBM_BYTES_S = 3.35e12       # H100 SXM HBM3 bandwidth


def counts():
    """``{"launches", "rays", "cluster_tests", "triangle_tests",
    "slab_tests", "cutout_fetches"}`` of B2 over the run so far, or None
    where the program keeps no fetch counter or B2 never launched."""
    from rayzath_tpu_torch.ops import traverse_cluster as tc
    f = getattr(tc, "cluster_shadow", None)
    work, fetches = getattr(f, "work", None), getattr(f, "fetches", None)
    if (work is None or fetches is None or not getattr(f, "launches", 0)
            or not getattr(f, "rays", 0)):
        return None
    c = dict(work.read(), **fetches.read(), launches=f.launches, rays=f.rays)
    return c if all(k in c for k in WORK + ("cutout_fetches",)) else None


def device_ms(trace) -> tuple:
    """(device ms, launches) of the cutout variant's events in ``trace``."""
    spans = [b - a for n, a, b in trace.device if KERNEL.search(n)]
    return sum(spans) / 1e3, len(spans)


def traced(trace):
    """(device ms, traced launches, counts) of the cutout variant in the
    progressive ``trace``, or None."""
    if trace.kind != "progressive" or not trace.units:
        return None
    ms, launches = device_ms(trace)
    if not launches:
        return None
    c = counts()
    return None if c is None else (ms, launches, c)


def bound_s(c: dict) -> float:
    """The bound of a mean launch with the counts ``c``, in seconds."""
    n = c["launches"]
    ops = (TEST_OPS * c["triangle_tests"] + SLAB_OPS * c["slab_tests"]
           + FETCH_OPS * c["cutout_fetches"]) / n
    return max(ops / F32_OPS_S, FETCH_BYTES * c["cutout_fetches"] / n
               / HBM_BYTES_S)


def fetches_per_ray(trace):
    """B2's texel fetches over the rays launched into it, or None."""
    found = traced(trace)
    if found is None:
        return None
    c = found[2]
    return c["cutout_fetches"] / c["rays"]


def ms_per_pass(trace):
    """The cutout variant's device ms a pass, or None."""
    found = traced(trace)
    return None if found is None else found[0] / trace.units


def bound_share(trace):
    """The cutout variant's bound a pass over its device ms a pass, in %,
    or None."""
    found = traced(trace)
    if found is None or found[0] <= 0.0:
        return None
    ms, launches, c = found
    return 100.0 * launches * bound_s(c) * 1e3 / ms
