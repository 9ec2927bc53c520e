"""Mean ms per frame of the renderer's own "tone mapping" timer
(``Renderer.time_table``: host clock around the tone map and the image's
copy to the host), over the window's frames."""


def read(trace):
    ms = trace.timers.get("tone mapping") if trace.kind == "interactive" else None
    return sum(ms) / len(ms) if ms else None
