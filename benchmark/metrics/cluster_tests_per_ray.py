"""Cluster tests per ray of the flat walk: B1's and B2's tests over the
rays launched into them, from the program's counters over the whole run
(``benchmark/lib/soup_work.py``). None where the program keeps no such
counter or the traced cycles launch neither kernel."""
from benchmark.lib.soup_work import tests_per_ray


def read(trace):
    return tests_per_ray(trace)
