"""Device ms per render pass of B3, the instanced closest-hit walk
(``closest_inst_kernel``). None where the traced cycles launch no B3."""
from benchmark.lib.inst_work import device_ms


def read(trace):
    if trace.kind != "progressive" or not trace.units:
        return None
    ms, launches = device_ms(trace, "closest_inst")
    return ms / trace.units if launches else None
