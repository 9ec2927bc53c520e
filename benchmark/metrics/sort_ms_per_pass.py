"""Device ms per render pass of the ray order: torch's top-k and sort
kernels that ``integrator._run_coherent`` runs before the traversal."""


def read(trace):
    if trace.kind != "progressive" or not trace.has("sort"):
        return None
    return trace.group_us("sort") / 1e3 / trace.units
