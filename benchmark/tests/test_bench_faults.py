"""The check that decides ``correct`` fails a broken program and the control.

Each fault is planted in the renderer underneath a whole run of a tiny
cell on the CPU (the harness's look for a card skipped), and the run has
to come out not correct: a pass or step that leaves its state unchanged,
half of the pixels (the batch) left out with the loss's mean taken over
the rest, an answer altered where it is produced. The exchange between
chips is no fault these one-card cells can have. The control, the
reference computed in bfloat16 in the program's place, has to read over
the limits too; on the card, at the cells' own sizes, ``calibrate.py
--control`` reads it.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from _tiny import LIMITS, interactive, progressive, train  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.lib import mixes  # noqa: E402


@pytest.fixture
def limits(monkeypatch):
    monkeypatch.setattr(run, "limits", lambda cell: LIMITS)


def _half(state, out):
    """``out`` with the first half of the image's pixels left as in
    ``state``."""
    n = state.width * state.height
    keep = {}
    for f in ("accum", "depth_buf", "space_buf", "origin", "direction",
              "throughput", "medium", "path_depth", "near", "far", "score"):
        new = getattr(out, f).clone()
        flat, old = new.reshape(n, -1), getattr(state, f).reshape(n, -1)
        flat[: n // 2] = old[: n // 2]
        keep[f] = new
    return out.replace(**keep)


def plant(monkeypatch, fault: str, kind: str):
    from rayzath_tpu_torch.engine import cycle, renderer
    from rayzath_tpu_torch.parallel import train as ptrain
    step = cycle.bounce_step
    if fault == "unchanged":
        if kind == "train":
            monkeypatch.setattr(ptrain, "_update", lambda k, p, g, lr: p.detach())
        else:
            monkeypatch.setattr(cycle.RenderCycle, "run", lambda self, *a, **k: None)
    elif fault == "half_batch":
        if kind == "train":
            def loss(scene, cam, cfg, state, key, target, n_steps, remat=False,
                     u=None, row0=0):
                st = ptrain.render_steps_preserve(scene, cam, cfg, state, key,
                                                  n_steps, row0=row0,
                                                  remat=remat, u=u)
                img = st.accum[..., :3] / torch.clamp(st.accum[..., 3:4], min=1.0)
                h = img.shape[0] // 2
                return torch.mean(torch.square(img[:h] - target[:h])), st
            monkeypatch.setattr(ptrain, "_loss", loss)
        else:
            monkeypatch.setattr(cycle, "bounce_step",
                                lambda *a, **k: _half(a[3], step(*a, **k)))
    elif fault == "altered":
        if kind == "train":
            project = ptrain._project
            monkeypatch.setattr(ptrain, "_project",
                                lambda name, v: project(name, v) * 1.01)
        elif kind == "interactive":
            final = renderer.final_color
            monkeypatch.setattr(renderer, "final_color",
                                lambda *a, **k: final(*a, **k) * 0.9)
        else:
            def altered(*a, **k):
                out = step(*a, **k)
                return dataclasses.replace(
                    out, accum=out.accum + 0.01 * (out.accum - a[3].accum))
            monkeypatch.setattr(cycle, "bounce_step", altered)


CELLS = {"progressive": progressive, "train": train, "interactive": interactive}


@pytest.mark.parametrize("kind", sorted(CELLS))
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_broken_program_is_not_correct(monkeypatch, limits, kind, fault):
    plant(monkeypatch, fault, kind)
    res = run.run_cell(CELLS[kind](), 2 ** 31 + 5, 0.2, False, "cpu")
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_the_control_is_not_correct(kind):
    cell = CELLS[kind]()
    mix = mixes.KINDS[cell.traffic["kind"]](cell.config, cell.traffic, 77, "cpu")
    mix.setup()
    mix.window(0.2, False)
    mix.release()
    got = mix.check(produce=torch.bfloat16)
    assert any(not (value <= LIMITS[key]) for _, value, key in got), got
