"""(Instance, cluster) tests per ray of the instanced walk: B3's and B4's
tests over the rays launched into them, from the program's counters over
the whole run (``benchmark/lib/inst_work.py``). None where the program
keeps no such counter or the traced cycles launch neither kernel."""
from benchmark.lib.inst_work import KERNELS, counts, device_ms


def read(trace):
    if trace.kind != "progressive":
        return None
    tests = rays = 0
    for kernel in KERNELS:
        if not device_ms(trace, kernel)[1]:
            continue
        c = counts(kernel)
        if c is None:
            return None
        tests += c["cluster_tests"]
        rays += c["rays"]
    return tests / rays if rays else None
