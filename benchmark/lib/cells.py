"""What a cell is made of, found by the names in ``BENCHMARK.json``.

A workload names a configuration (``configs[].file``, a JSON file of the
scene and render settings) and a traffic mix (``traffic/<name>.json``, the
parameters that :mod:`.mixes` reads); a per-layer metric is the module
``metrics/<name>.py``, whose ``read(trace)`` returns the value or None.
Nothing here names a cell, a mix or a metric: a later change adds them as
files and entries of ``BENCHMARK.json``.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file's contents
    traffic: dict           # the traffic file's contents, with its "name"
    end_to_end: list        # manifest entries reported with --trace 0
    per_layer: list         # manifest entries reported with --trace 1


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s manifest; KeyError if none."""
    man = manifest(root)
    work = {w["name"]: w for w in man["workloads"]}[name]
    conf = {c["name"]: c for c in man["configs"]}[work["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{work['traffic']}.json") as f:
        traffic = dict(json.load(f), name=work["traffic"])
    return Cell(name, int(work["chips"]), config, traffic,
                [m for m in man["end_to_end"] if _applies(m, name)],
                [m for m in man["per_layer"] if _applies(m, name)])


def reader(metric: str, directory: Path = BENCH / "metrics"):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = directory / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, trace, directory: Path = BENCH / "metrics") -> dict:
    """{name: {"value", "unit"}} of the per-layer ``entries`` that find
    something to read in ``trace``."""
    out = {}
    for m in entries:
        v = reader(m["name"], directory)(trace)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
