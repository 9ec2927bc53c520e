"""Tiny cells of the benchmark's mixes that run on the CPU."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.lib.cells import Cell  # noqa: E402

torch.set_num_threads(2)

TRAFFIC = ROOT / "benchmark" / "traffic"
RENDER = {"max_depth": 16, "rpp": 4, "spot_light": 1, "direct_light": 1}


def traffic(name: str, **over) -> dict:
    with open(TRAFFIC / f"{name}.json") as f:
        return dict(json.load(f), name=name, **over)


def progressive(scene: str = "textured_room") -> Cell:
    cfg = {"scene": scene, "width": 32, "height": 24, "render": RENDER}
    return Cell("tiny.progressive", 1, cfg,
                traffic("progressive", check_pixels=96, check_cycles=2,
                        trace_cycles=1),
                [{"name": "rays_per_s", "unit": "rays/s"},
                 {"name": "setup_s", "unit": "s"}], [])


def train() -> Cell:
    cfg = {"scene": "textured_room", "width": 1280, "height": 720,
           "render": dict(RENDER, rpp=8)}
    return Cell("tiny.train", 1, cfg, traffic("train", width=24, height=16,
                                              trace_steps=1),
                [{"name": "train_step_s", "unit": "s/step"},
                 {"name": "setup_s", "unit": "s"}], [])


def interactive() -> Cell:
    cfg = {"scene": "textured_room", "width": 32, "height": 24, "render": RENDER}
    return Cell("tiny.interactive", 1, cfg,
                traffic("interactive", pivot=[0.0, 0.8, 0.5], check_pixels=128,
                        check_span=3, trace_frames=2),
                [{"name": "frame_ms_p95", "unit": "ms"},
                 {"name": "setup_s", "unit": "s"}], [])


#: limits of the tiny cells: those of the real cells' files
LIMITS = {}
for _cell in ("textured_room.progressive", "textured_room.train",
              "mesh_massive.interactive"):
    with open(ROOT / "benchmark" / "limits" / f"{_cell}.json") as _f:
        LIMITS.update(json.load(_f))
