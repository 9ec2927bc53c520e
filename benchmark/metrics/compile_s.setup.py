"""Seconds the renderer spent compiling the world on the host over the
whole run: the total of its ``rz::compile_world`` spans
(``rayzath_tpu_torch.utils.timing.totals``: flattening, BVH builds,
atlases, the upload). Set-up's compile; a recompile in the window shows as
a rise. None where the program keeps no span totals."""


def read(trace):
    if trace.kind not in ("progressive", "interactive"):
        return None
    from rayzath_tpu_torch.utils import timing
    totals = getattr(timing, "totals", None)
    span = totals().get("compile_world") if totals else None
    return None if span is None else span["total_ms"] / 1e3
