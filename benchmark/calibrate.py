#!/usr/bin/env python3
"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 \\
        --seconds 2 [--control] [--fault half_batch] [--out file.jsonl]

For each seed, one run of the cell as ``run.py`` makes it (set-up, a window
of ``--seconds``, the program released), then the numbers its check
compares: the program's, and with ``--control`` those of the reference in
bfloat16 put in the program's place, with ``--fault`` those of the planted
fault (``half_batch``: the training loss over half the rows). One JSON
line per seed and reading. Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.lib import cells, mixes

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        mix = mixes.KINDS[cell.traffic["kind"]](cell.config, cell.traffic,
                                                seed, "cuda:0")
        mix.setup()
        w = mix.window(args.seconds, False)
        mix.release()
        runs = [("program", {})]
        if args.control:
            runs.append(("control", {"produce": torch.bfloat16}))
        if args.fault:
            runs.append((args.fault, {"fault": args.fault}))
        for what, kw in runs:
            t0 = time.perf_counter()
            nums = {n: v for n, v, _ in mix.check(**kw)}
            rec = {"cell": cell.name, "seed": seed, "reading": what,
                   "units": w["attempted"], "numbers": nums,
                   "check_s": time.perf_counter() - t0,
                   "device": torch.cuda.get_device_name(0)}
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        del mix
    return 0


if __name__ == "__main__":
    sys.exit(main())
