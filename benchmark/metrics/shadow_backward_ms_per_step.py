"""Device ms per training step of the shadow backward kernels B2-grad and
B4-grad (``shadow_grad_kernel``, ``shadow_inst_grad_kernel``)."""


def read(trace):
    if trace.kind != "train" or not trace.has("shadow_backward"):
        return None
    return trace.group_us("shadow_backward") / 1e3 / trace.units
