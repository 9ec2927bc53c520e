"""Device ms per render pass of the traversal kernels B1-B4
(``closest_kernel``, ``shadow_kernel``, ``closest_inst_kernel``,
``shadow_inst_kernel``)."""


def read(trace):
    if trace.kind != "progressive" or not trace.has("traversal"):
        return None
    return trace.group_us("traversal") / 1e3 / trace.units
