"""Mean ms per frame of the renderer's own "temporal reproject" timer
(``Renderer.time_table``: host clock around the reprojection after a
camera move, ending in a synchronise), over the window's frames."""


def read(trace):
    ms = trace.timers.get("temporal reproject") if trace.kind == "interactive" else None
    return sum(ms) / len(ms) if ms else None
