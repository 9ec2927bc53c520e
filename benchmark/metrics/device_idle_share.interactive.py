"""Share of the traced frames' wall time in which the device ran no
operation, in %: 100 * (1 - busy / wall)."""


def read(trace):
    if trace.kind != "interactive" or not trace.device:
        return None
    return 100.0 * trace.idle_share()
