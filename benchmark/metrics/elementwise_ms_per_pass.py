"""Device ms per render pass of every operation no kernel group names:
the bounce's elementwise code (integrator, vector ops, camera, texture
arithmetic), copies and fills."""


def read(trace):
    if trace.kind != "progressive" or not trace.has("other"):
        return None
    return trace.group_us("other") / 1e3 / trace.units
