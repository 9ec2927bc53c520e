"""Share of the traced render cycles' wall time in which the device ran
no operation, in %: 100 * (1 - busy / wall), busy the union of the
device-side intervals."""


def read(trace):
    if trace.kind != "progressive" or not trace.device:
        return None
    return 100.0 * trace.idle_share()
