"""Host ms a traced frame spends in the camera view's reset after a move
(``rz::reset``: the snapshots for the reprojection, the camera's compile,
the fresh state loaded into the render cycle's static buffers), over the
traced frames."""


def read(trace):
    if trace.kind != "interactive" or not trace.units:
        return None
    ms = [(b - a) / 1e3 for n, a, b in trace.host if n == "rz::reset"]
    return sum(ms) / trace.units if ms else None
