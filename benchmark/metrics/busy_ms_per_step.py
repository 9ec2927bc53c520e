"""Device busy ms per training step: the union of the traced steps'
device-side intervals over the steps they ran."""


def read(trace):
    if trace.kind != "train" or not trace.device:
        return None
    return trace.busy_us() / 1e3 / trace.units
