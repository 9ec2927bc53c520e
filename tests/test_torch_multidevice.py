"""The port's row-band runtime (``parallel/mesh.py``, ``distributed.py``,
``scaling.py``, ``dryrun.py``) on the CPU, against one device and against
the JAX package.

* n = 1, 2 and 4 bands on the CPU equal the one-device render bit for bit
  (the plain versions work ray by ray and the streams are row-keyed), on a
  soup scene and on a two-level scene; so does a checkpoint saved at 4
  bands and resumed at 2 (tests/test_checkpoint.py:58), and two gloo
  processes against one (tests/test_multihost.py).
* The port's bands against the JAX ``sharded_render_steps`` on the suite's
  8-device virtual CPU mesh, same seed: sample counts equal, radiance
  within ``assert_images_match``.
* ``sharded_training_step`` against ``training_step``: loss to rtol 1e-5,
  each ``DIFF_PARAMS`` gradient to rtol 1e-5 of its max |g|.
* The kernel launches go to the device of their tensors: a CPU test with
  the CUDA calls replaced by recorders (``tests/test_torch_gpu.py`` has the
  two-card test).
"""
import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import rayzath_tpu as rz  # noqa: E402
from rayzath_tpu.engine.state import init_state as jinit  # noqa: E402
from rayzath_tpu.models.device_scene import (compile_world as jcompile,  # noqa: E402
                                             compile_camera as jcamera)
from rayzath_tpu.parallel.mesh import (make_mesh as jmesh,  # noqa: E402
                                       sharded_render_steps as jsharded)

import rayzath_tpu_torch as rt  # noqa: E402
from rayzath_tpu_torch.engine.integrator import render_steps  # noqa: E402
from rayzath_tpu_torch.engine.state import (init_state, load_state,  # noqa: E402
                                            save_state, _ARRAYS)
from rayzath_tpu_torch.models import device_scene as tds  # noqa: E402
from rayzath_tpu_torch.ops import rng  # noqa: E402
from rayzath_tpu_torch.ops import traverse_cluster as tc  # noqa: E402
from rayzath_tpu_torch.parallel import distributed as D  # noqa: E402
from rayzath_tpu_torch.parallel import mesh as M  # noqa: E402
from rayzath_tpu_torch.parallel import train as T  # noqa: E402
from rayzath_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from rayzath_tpu_torch.parallel.scaling import (format_report,  # noqa: E402
                                                measure_scaling)

from test_oracle_parity import assert_images_match  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _scene(name, res=32):
    """(scene, camera, config) on the CPU: "soup" is cornell_box_nee, "two
    level" multi_light compiled two-level, depth 3."""
    world = (rt.scenes.cornell_box_nee if name == "soup"
             else rt.scenes.multi_light)(res, res)
    scene = tds.compile_world(world, two_level=name == "two level", device=CPU)
    assert scene.two_level == (name == "two level")
    cam = tds.compile_camera(world.cameras[0], CPU)
    return scene, cam, rt.RenderConfig(tracing=rt.Tracing(max_depth=3))


def _assert_states_equal(a, b):
    for f in _ARRAYS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.pass_idx, a.width, a.height) == (b.pass_idx, b.width, b.height)


# ---------------------------------------------------------------------------
# bands on one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("name", ["soup", "two level"])
def test_bands_equal_one_device(name, n):
    scene, cam, cfg = _scene(name)
    key = rng.key(3)
    ref = render_steps(scene, cam, cfg, init_state(32, 32, CPU), key, 3)
    state = init_state(32, 32, CPU)
    got = M.sharded_render_steps(scene, cam, cfg, state, key, 3, ["cpu"] * n)
    _assert_states_equal(got, ref)
    assert state.pass_idx == 0 and float(state.accum.abs().sum()) == 0.0


def test_shard_state_splits_rows():
    st = render_steps(*_scene("soup", 16)[:2], _scene("soup", 16)[2],
                      init_state(16, 16, CPU), rng.key(1), 1)
    bands = M.shard_state(st, ["cpu"] * 4)
    assert [b.height for b in bands] == [4] * 4
    assert torch.equal(bands[2].accum, st.accum[8:12])
    assert torch.equal(bands[2].origin, st.origin[8 * 16:12 * 16])
    _assert_states_equal(M.unshard_state(bands, CPU), st)
    with pytest.raises(ValueError, match="not divisible by 3"):
        M.shard_state(st, ["cpu"] * 3)
    with pytest.raises(ValueError, match="not divisible"):
        M.sharded_render_steps(*_scene("soup", 16), init_state(16, 16, CPU),
                               rng.key(1), 1, ["cpu"] * 5)


def test_checkpoint_resumes_across_band_counts(tmp_path):
    """tests/test_checkpoint.py:58 on the port: 2 steps at 4 bands, saved,
    loaded and resumed for 3 steps at 2 bands, equal 5 one-device steps bit
    for bit."""
    W, H = 32, 24
    world = rt.scenes.cornell_box(W, H)
    scene = tds.compile_world(world, device=CPU)
    cam = tds.compile_camera(world.cameras[0], CPU)
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=4))
    key = rng.key(7)
    ref = render_steps(scene, cam, cfg, init_state(W, H, CPU), key, 2)
    ref = render_steps(scene, cam, cfg, ref, key, 3)
    p = str(tmp_path / "shard.npz")
    save_state(p, M.sharded_render_steps(scene, cam, cfg, init_state(W, H, CPU),
                                         key, 2, ["cpu"] * 4))
    got = M.sharded_render_steps(scene, cam, cfg, load_state(p, CPU), key, 3,
                                 ["cpu"] * 2)
    _assert_states_equal(got, ref)


def test_bands_match_jax_sharded_render():
    """The port's 4 bands against the JAX sharded_render_steps on 4 of the
    suite's 8 virtual CPU devices, seed 11: sample counts equal, radiance
    within the image gate."""
    W = H = 32
    cfg_j = rz.RenderConfig(tracing=rz.Tracing(max_depth=3))
    jw = rz.scenes.cornell_box(W, H)
    jst = jsharded(jcompile(jw), jcamera(jw.cameras[0]), cfg_j, jinit(W, H),
                   jax.random.key(11), 4, jmesh(jax.devices()[:4]))
    scene, cam = (tds.compile_world(rt.scenes.cornell_box(W, H), device=CPU),
                  tds.compile_camera(rt.scenes.cornell_box(W, H).cameras[0], CPU))
    tst = M.sharded_render_steps(scene, cam,
                                 rt.RenderConfig(tracing=rt.Tracing(max_depth=3)),
                                 init_state(W, H, CPU), rng.key(11), 4,
                                 ["cpu"] * 4)
    a = tst.accum.numpy()
    assert a[..., 3].sum() > 0
    assert_images_match(a, np.asarray(jst.accum))


def test_mesh_defaults_to_the_card():
    import inspect
    for fn in (M.sharded_render_steps, M.sharded_training_step):
        assert inspect.signature(fn).parameters["mesh"].default is None
    assert M.make_mesh(["cpu", "cpu"]) == [CPU, CPU]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.sharded_render_steps(*_scene("soup", 8), init_state(8, 8, CPU),
                               rng.key(0), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.init_state_distributed(8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(1)


# ---------------------------------------------------------------------------
# training over bands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_sharded_training_step_matches(n):
    """Loss to rtol 1e-5 and every DIFF_PARAMS gradient to rtol 1e-5 of its
    max |g| against image_loss on one device; the step's update likewise."""
    from rayzath_tpu_torch.utils.check_worlds import lit_world
    world = lit_world(16)
    scene = tds.compile_world(world, device=CPU)
    cam = tds.compile_camera(world.cameras[0], CPU)
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=3))
    w_, h_ = world.cameras[0].width, world.cameras[0].height
    target = torch.full((h_, w_, 3), 0.1)
    seed, steps, lr = 13, 4, 0.5
    params = {k: getattr(scene, k).detach().requires_grad_(True)
              for k in T.DIFF_PARAMS}
    with torch.enable_grad():
        loss, _ = T.image_loss(dataclasses.replace(scene, **params), cam, cfg,
                               init_state(w_, h_, CPU), seed, target, steps)
        ref = torch.autograd.grad(loss, list(params.values()),
                                  allow_unused=True)
    sloss, grads, _ = M.sharded_value_and_grad(
        scene, cam, cfg, init_state(w_, h_, CPU), seed, target, steps,
        ["cpu"] * n)
    assert float(sloss) == pytest.approx(float(loss.detach()), rel=1e-5)
    nonzero = 0
    for k, g_ref in zip(T.DIFF_PARAMS, ref):
        g = grads[k]
        if g_ref is None:
            assert g is None, k
            continue
        scale = float(g_ref.abs().max())
        nonzero += scale > 0
        assert float((g - g_ref).abs().max()) <= 1e-5 * max(scale, 1e-30), k
    assert nonzero >= 4
    s1, st1, l1 = T.training_step(scene, cam, cfg, init_state(w_, h_, CPU),
                                  seed, target, lr, steps)
    s2, st2, l2 = M.sharded_training_step(scene, cam, cfg,
                                          init_state(w_, h_, CPU), seed,
                                          target, lr, steps, ["cpu"] * n)
    assert float(l2) == pytest.approx(float(l1), rel=1e-5)
    _assert_states_equal(st2, st1)
    for k in T.DIFF_PARAMS:
        a, b = getattr(s2, k), getattr(s1, k)
        assert not a.requires_grad
        assert float((a - b).abs().max()) <= 1e-5 * max(float(b.abs().max()), 1.0), k


def test_dryrun_multichip_on_the_cpu():
    loss = dryrun_multichip(2, ["cpu", "cpu"])
    assert np.isfinite(loss) and loss > 0
    with pytest.raises(RuntimeError, match="need 3 devices"):
        dryrun_multichip(3, ["cpu", "cpu"])


def test_measure_scaling_on_the_cpu():
    """The harness over 1 and 2 bands of the CPU (no scaling is measured
    there: both bands share the same cores)."""
    out = measure_scaling(rt.scenes.cornell_box, rpp=1, size=16, max_depth=2,
                          repeats=1, devices=["cpu", "cpu"])
    assert [r["n"] for r in out] == [1, 2]
    assert out[0]["efficiency"] == 1.0 and all(r["rays_per_s"] > 0 for r in out)
    report = format_report(out).splitlines()
    assert report[0] == "devices | Mrays/s | scaling efficiency"
    assert report[1].split("|")[0].strip() == "1" and len(report) == 3


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import rayzath_tpu_torch as rt
    from rayzath_tpu_torch.models.device_scene import compile_world, compile_camera
    from rayzath_tpu_torch.ops import rng
    from rayzath_tpu_torch.parallel import distributed as D

    port, pid, nproc, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    assert D.init_distributed(f"localhost:{port}", nproc, pid, device="cpu") == pid
    mesh = D.global_mesh()
    assert len(mesh) == nproc and D.world_size() == nproc
    w = rt.scenes.cornell_box(32, 32)
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=3, rpp=2))
    scene = compile_world(w, device="cpu")
    cam = compile_camera(w.cameras[0], "cpu")
    state = D.init_state_distributed(32, 32, mesh)
    state = D.render_steps_distributed(scene, cam, cfg, state, rng.key(11), 4)
    img = D.gather_image(state)
    band = D.host_row_band(32, mesh)
    if pid == 0:
        np.save(out, img)
    print(json.dumps({"band": band, "procs": D.world_size(),
                      "local_rows": state.height}))
    torch.distributed.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_match_one(tmp_path):
    """tests/test_multihost.py on the port: two processes on gloo, each
    renders its band and all_gathers, equal to one process bit for bit."""
    port = _free_port()
    out = str(tmp_path / "img.npy")
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("RZ_COORDINATOR", "RZ_NUM_PROCESSES", "RZ_PROCESS_ID",
              "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(port), str(i), "2", out],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so}\n{se}"
    metas = [json.loads(so.strip().splitlines()[-1]) for so, _ in outs]
    assert [m["band"] for m in metas] == [[0, 16], [16, 32]]
    assert all(m["procs"] == 2 and m["local_rows"] == 16 for m in metas)

    w = rt.scenes.cornell_box(32, 32)
    st = render_steps(tds.compile_world(w, device=CPU),
                      tds.compile_camera(w.cameras[0], CPU),
                      rt.RenderConfig(tracing=rt.Tracing(max_depth=3, rpp=2)),
                      init_state(32, 32, CPU), rng.key(11), 4)
    img2 = np.load(out)
    assert img2.dtype == np.float32 and img2.shape == (32, 32, 4)
    np.testing.assert_array_equal(img2, st.accum.numpy())


def test_single_process_initializes_nothing(monkeypatch):
    for k in ("RZ_COORDINATOR", "RZ_NUM_PROCESSES", "RZ_PROCESS_ID",
              "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert D.init_distributed(device="cpu") == 0
    assert not torch.distributed.is_initialized()
    assert (D.rank(), D.world_size()) == (0, 1)
    assert D.global_mesh("cpu") == [CPU]
    assert D.host_row_band(32) == (0, 32)
    st = D.init_state_distributed(8, 8, D.global_mesh("cpu"))
    assert st.height == 8
    assert np.array_equal(D.gather_image(st), st.accum.numpy())
    monkeypatch.setenv("RZ_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator address"):
        D.init_distributed(device="cpu")


# ---------------------------------------------------------------------------
# kernel launches follow their tensors' device
# ---------------------------------------------------------------------------

def test_launches_go_to_the_tensors_device(monkeypatch):
    """Each of B1-B4, and each G1 gather of the shadow kernels' opacity
    tables, launches inside ``torch.cuda.device(d)`` on
    ``torch.cuda.current_stream(d)``, d the device of its tensors. The
    tensors live on the meta device; the kernel library, the check for a
    CUDA device (``_kernels.card``), the shared-memory query, the device
    context and the stream lookup are recorders."""
    seen = {"ctx": [], "stream": [], "calls": []}

    class Lib:
        def __getattr__(self, name):
            def launch(*args):
                seen["calls"].append((name, args[-1].value))
                return 0
            return launch

    @contextlib.contextmanager
    def device_ctx(d):
        seen["ctx"].append(torch.device(d))
        yield

    class Stream:
        cuda_stream = 0x5EED

    def current_stream(device=None):
        seen["stream"].append(device)
        return Stream()

    monkeypatch.setattr(tc._kernels, "load", lambda: Lib())
    monkeypatch.setattr(tc._kernels, "card", lambda dev: dev)
    monkeypatch.setattr(tc, "_ranked_smem", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "device", device_ctx)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    # B1-B4's work counters get their meta-device pairs here, not in the
    # process-wide counters that later tests read
    for wrapper in (tc.cluster_closest, tc.cluster_shadow,
                    tc.cluster_closest_inst, tc.cluster_shadow_inst):
        monkeypatch.setattr(wrapper, "work", tc.WorkCounter(wrapper.work.keys))
    meta = torch.device("meta")
    r = 64
    o, d, x = (torch.zeros(r, 3, device=meta), torch.zeros(r, 3, device=meta),
               torch.zeros(r, device=meta))
    soup = tds.compile_world(rt.scenes.cornell_box_nee(8, 8), device=CPU)
    f = soup.cl_order.shape[0]
    tc.cluster_closest(o, d, x, x, soup.cl_box.to(meta), soup.cl_lw.to(meta),
                       soup.cl_order.to(meta))
    tc.cluster_shadow(o, d, x, soup.cl_box.to(meta), soup.cl_lw.to(meta),
                      soup.cl_order.to(meta), soup.cl_base.to(meta),
                      soup.cl_count.to(meta), torch.ones(f, 3, device=meta),
                      torch.ones(f, device=meta))
    inst = tds.compile_world(rt.scenes.cornell_box_nee(8, 8), two_level=True,
                             device=CPU)
    tc.cluster_closest_inst(o, d, x, x, inst.ti_rows.to(meta),
                            inst.cl_obox.to(meta), inst.cl_lw.to(meta))
    tc.cluster_shadow_inst(o, d, x, inst.ti_rows.to(meta), inst.cl_obox.to(meta),
                           inst.cl_lw.to(meta), inst.cl_slot.to(meta),
                           inst.inst_slot_map.to(meta),
                           inst.mat_color.to(meta))
    # cluster_opacity gathers twice, instance_opacity once
    assert [c[0] for c in seen["calls"]] == [
        "rz_cluster_closest", "rz_gather_rows", "rz_gather_rows",
        "rz_cluster_shadow", "rz_cluster_closest_inst", "rz_gather_rows",
        "rz_cluster_shadow_inst"]
    assert all(stream == 0x5EED for _, stream in seen["calls"])
    assert seen["ctx"] == [meta] * 7
    assert seen["stream"] == [meta] * 7
