"""Device ms per render pass of B2's cutout variant
(``shadow_kernel<..., true>``, ``benchmark/lib/cutout_work.py``). None
where the traced cycles launch no cutout variant or the program keeps no
fetch counter."""
from benchmark.lib.cutout_work import ms_per_pass


def read(trace):
    return ms_per_pass(trace)
