"""Seconds the renderer spent capturing its pass into a CUDA graph over
the whole run, each capture's warm-up pass included: the total of its
``rz::capture`` spans (``rayzath_tpu_torch.utils.timing.totals``). None
where the program keeps no span totals."""


def read(trace):
    if trace.kind not in ("progressive", "interactive"):
        return None
    from rayzath_tpu_torch.utils import timing
    totals = getattr(timing, "totals", None)
    span = totals().get("capture") if totals else None
    return None if span is None else span["total_ms"] / 1e3
