"""Texels fetched per ray by B2's cutout variant: its ``cutout_fetches``
over B2's ``rays``, from the program's counters over the whole run
(``benchmark/lib/cutout_work.py``). None where the program keeps no such
counter or the traced cycles launch no cutout variant."""
from benchmark.lib.cutout_work import fetches_per_ray


def read(trace):
    return fetches_per_ray(trace)
