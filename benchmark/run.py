#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s``) builds the cell's scene and renderer or
training step on the card and warms every shape the window uses; the
window then runs the cell's traffic for ``--seconds``. With ``--trace 0``
the result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a ``torch.profiler`` trace of part of the
window. After the window the program's state is released and what the
window produced is compared with the plain reference of ``reference/``;
each number compared is printed beside its limit (``limits/<cell>.json``),
last on standard error and under ``checks`` at the end of the result
line, the last line of standard output.

The run exits non-zero without a result when there is no CUDA device or
fewer than the cell asks for, or when the JAX package, ``jax``,
``jaxlib`` or ``flax`` is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "rayzath_tpu")


def forbidden_modules(modules=None) -> list:
    """The names of :data:`FORBIDDEN` among the top-level names (the part
    before the first dot) of ``modules`` (``sys.modules``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def limits(cell: str) -> dict:
    """The limits of the numbers that ``cell``'s check compares."""
    with open(ROOT / "benchmark" / "limits" / f"{cell}.json") as f:
        return json.load(f)


def run_cell(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of ``cell`` (``lib.cells.Cell``) on ``device``: the result
    line's keys, with ``checks`` last."""
    import torch

    from benchmark.lib import cells, mixes

    dev = torch.device(device)
    if dev.type == "cuda":
        # set-up is timed from a process that holds a CUDA context
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    mix = mixes.KINDS[cell.traffic["kind"]](cell.config, cell.traffic, seed, dev)
    mix.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    out = mix.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    mix.release()
    lim = limits(cell.name)
    checks = {name: {"value": value, "limit": lim[key]}
              for name, value, key in mix.check()}
    checks["failed_units"] = {"value": out["failed"], "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                           else "cpu"),
                  "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"]}
    if trace:
        tr = out["trace"]
        result["metrics"] = cells.read_metrics(cell.per_layer, tr)
        device_rec.update(busy_s=tr.busy_us() / 1e6, window_s=tr.wall_s)
        result["device"] = device_rec
        result["breakdown"] = tr.breakdown()
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = device_rec
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every cache the program or torch may write stays in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.lib import cells

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = forbidden_modules()
    if found:
        print(f"loaded in the run's process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
