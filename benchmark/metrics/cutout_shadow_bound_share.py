"""Share of B2's cutout variant's device time a pass that its roofline
bound would take, in %: the larger of its operations (49 a triangle test,
25 a slab test, 76 a texel fetch) over 67 TFLOP/s and its fetches' bytes
(80 each) over 3.35 TB/s, from the program's counters, times the traced
launches, against their traced device ms (``benchmark/lib/cutout_work.py``
derives it). The work priced is what the kernel made, so removing wasted
slab and triangle tests lowers this share with the time: read it beside
``cutout_shadow_ms_per_pass``. None where the program keeps no fetch
counter or the traced cycles launch no cutout variant."""
from benchmark.lib.cutout_work import bound_share


def read(trace):
    return bound_share(trace)
