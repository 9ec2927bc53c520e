"""Share of B1 + B2's device time a pass that their operation bound would
take, in %: the work their counters say a launch made (128 ray-triangle
tests of 49 f32 operations a cluster test, 25 a slab test) times the
traced launches, over 67 TFLOP/s, against their traced device ms
(``benchmark/lib/soup_work.py`` derives it). None where the program keeps
no such counter or the traced cycles launch neither kernel."""
from benchmark.lib.soup_work import bound_share


def read(trace):
    return bound_share(trace)
