"""Device ms per render pass of B4, the instanced shadow walk
(``shadow_inst_kernel``). None where the traced cycles launch no B4."""
from benchmark.lib.inst_work import device_ms


def read(trace):
    if trace.kind != "progressive" or not trace.units:
        return None
    ms, launches = device_ms(trace, "shadow_inst")
    return ms / trace.units if launches else None
