"""The harness: found by name, the result line, the import check, and no
result without a card or without the program."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from _tiny import ROOT, LIMITS, progressive  # noqa: E402  (sets sys.path)

from benchmark import run  # noqa: E402
from benchmark.lib import cells, mixes  # noqa: E402
from benchmark.lib.trace import Trace  # noqa: E402

MANIFEST = cells.manifest()


def test_every_cell_loads_by_name():
    for w in MANIFEST["workloads"]:
        cell = cells.load(w["name"])
        assert cell.traffic["kind"] in mixes.KINDS
        assert cell.config["scene"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert set(run.limits(w["name"]))


def test_every_per_layer_metric_has_a_reader():
    for m in MANIFEST["per_layer"]:
        assert callable(cells.reader(m["name"]))
        # nothing to read: the metric is left out, never 0
        assert cells.reader(m["name"])(Trace("none")) is None


def test_a_new_metric_file_is_read_by_name(tmp_path):
    (tmp_path / "dummy_ms.py").write_text(
        "def read(trace):\n    return 42.0 if trace.kind == 'progressive' else None\n")
    (tmp_path / "silent.py").write_text("def read(trace):\n    return None\n")
    entries = [{"name": "dummy_ms", "unit": "ms"}, {"name": "silent", "unit": "%"}]
    got = cells.read_metrics(entries, Trace("progressive"), directory=tmp_path)
    assert got == {"dummy_ms": {"value": 42.0, "unit": "ms"}}


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in MANIFEST["configs"]]
    names += [w["name"] for w in MANIFEST["workloads"]]
    names += [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))
    ok = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")
    for n in names:
        assert set(n) <= ok and len(n) <= 64
    for c in MANIFEST["configs"]:
        assert len(c["source"]) <= 200 and (ROOT / c["file"]).is_file()
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
        assert m["layer"] in layers


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"rayzath_tpu_torch": 0, "rayzath_tpu_torch.ops": 0,
            "jaxtyping": 0, "flaxen": 0}
    assert run.forbidden_modules(mods) == []
    assert run.forbidden_modules(dict(mods, **{"rayzath_tpu.ops": 0})) == ["rayzath_tpu"]
    assert run.forbidden_modules({"jaxlib.xla": 0, "jax": 0}) == ["jax", "jaxlib"]
    assert run.forbidden_modules({"flax.linen": 0}) == ["flax"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(monkeypatch, trace):
    monkeypatch.setattr(run, "limits", lambda cell: LIMITS)
    res = run.run_cell(progressive(), 2 ** 31 + 7, 0.2, trace, "cpu")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {"rays_per_s", "setup_s"}
    assert set(res["checks"]) == {"mismatch_share", "failed_units"}
    json.dumps(res)


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "textured_room.progressive", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
        env=env)


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    p = _run(tmp_path, env)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the renderer's kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_a_cell_on_the_card(cuda):
    """A short run of a cell of the manifest on the card: correct, and its
    end-to-end metrics all reported."""
    cell = cells.load("textured_room.progressive")
    res = run.run_cell(cell, 2 ** 31 + 3, 1.0, False, cuda)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert res["device"]["platform"] == "gpu"
