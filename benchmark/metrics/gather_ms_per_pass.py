"""Device ms per render pass of the table gathers G1 (``gather_kernel``,
``gather_vec_kernel``): the material and texture lookups."""


def read(trace):
    if trace.kind != "progressive" or not trace.has("gather"):
        return None
    return trace.group_us("gather") / 1e3 / trace.units
