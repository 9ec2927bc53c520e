"""Device busy ms per render pass: the union of the traced cycles'
device-side intervals over the passes they ran."""


def read(trace):
    if trace.kind != "progressive" or not trace.device:
        return None
    return trace.busy_us() / 1e3 / trace.units
