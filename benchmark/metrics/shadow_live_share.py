"""The share of the shadow rays that B2 (``shadow_kernel``, its cutout
variant included) and B4 (``shadow_inst_kernel``) walk at all, in %: their
``live`` counts (the rays handed in with dist > 0) over their ``rays``
(every ray launched), from the program's counters over the whole run
(``benchmark/lib/soup_work.py``, ``benchmark/lib/inst_work.py``). The
bounce hands a light sample's shadow ray in with dist 0 where the sample
weighs exactly zero whatever its visibility (a lane that hit nothing, or a
radiance of exactly 0), and a walk takes such a ray as inactive: no vote,
no test. None where the program keeps no ``live`` count (a program older
than it) or the traced cycles launch neither kernel."""
from benchmark.lib import inst_work, soup_work

KERNELS = ((soup_work, "shadow"), (inst_work, "shadow_inst"))


def read(trace):
    if trace.kind != "progressive" or not trace.units:
        return None
    live = rays = 0
    for lib, kernel in KERNELS:
        if not lib.device_ms(trace, kernel)[1]:
            continue
        c = lib.counts(kernel)
        if c is None or "live" not in c:
            return None
        live += c["live"]
        rays += c["rays"]
    return 100.0 * live / rays if rays else None
