"""Host ms a traced frame spends reading the tone-mapped image back to the
host (``rz::readback`` in ``Renderer.image``), over the traced frames."""


def read(trace):
    if trace.kind != "interactive" or not trace.units:
        return None
    ms = [(b - a) / 1e3 for n, a, b in trace.host if n == "rz::readback"]
    return sum(ms) / trace.units if ms else None
