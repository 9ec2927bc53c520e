"""Device ms per training step of the gathers' backward G2
(``grad_block_kernel``, ``grad_sum_kernel``, ``grad_atomic_kernel``,
``round_kernel``)."""


def read(trace):
    if trace.kind != "train" or not trace.has("gather_backward"):
        return None
    return trace.group_us("gather_backward") / 1e3 / trace.units
