"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports no jax, so it runs on a GPU host without
jax; ``tests/conftest.py`` imports jax, so there run it as

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Rules (as in chip_smoke.py phase 2): B1 ids equal the plain version's except
on f64-chaotic rays, t to rtol 1e-5; B2 rgba to rtol 1e-5 / atol 1e-6 where
the plain alpha >= 1e-4, and both below 1e-4 elsewhere.
"""
import numpy as np
import pytest
import torch

import rayzath_tpu_torch as rt
from rayzath_tpu_torch.models import device_scene as tds
from rayzath_tpu_torch.ops import camera as cam_ops
from rayzath_tpu_torch.ops import traverse_cluster as tc
from rayzath_tpu_torch.utils.parity import closest_f64, images_match

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rays(scene, world, dev, res):
    """Camera rays (u = 0.5) and bounce-like rays with seeded sphere
    directions from the camera rays' first hits."""
    cam = tds.compile_camera(world.cameras[0], dev)
    r = res * res
    o, d = cam_ops.generate_rays(cam, cam_ops.pixel_grid(res, res, device=dev),
                                 torch.full((r, 4), 0.5, device=dev))
    t, tid = tc.cluster_closest_plain(o, d, torch.zeros(r, device=dev),
                                      torch.full((r,), 1e30, device=dev),
                                      scene.cl_box, scene.cl_lw)
    p = torch.where((tid >= 0)[:, None], o + d * (t * 0.999)[:, None], o)
    v = np.random.default_rng(res).normal(size=(r, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return [(o, d), (p.contiguous(), torch.as_tensor(v, device=dev))]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell_box_nee", "multi_light",
                                  "glass_and_fog", "mesh_heavy"])
def test_kernels_match_plain(cuda, name):
    world = rt.scenes.SCENES[name](8, 8)
    scene = tds.compile_world(world, device=cuda)
    mat = scene.mat_color[scene.tri_mat.long()]
    op_rgb, op_a = mat[:, :3].contiguous(), (1.0 - mat[:, 3]).contiguous()
    op_tab = tc.cluster_opacity(op_rgb, op_a, scene.cl_order, scene.cl_base,
                                scene.cl_count)
    for o, d in _rays(scene, world, cuda, 128):
        r = o.shape[0]
        near = torch.zeros(r, device=cuda)
        far = torch.full((r,), 1e30, device=cuda)
        t_k, tid_k = tc.cluster_closest(o, d, near, far, scene.cl_box,
                                        scene.cl_lw, scene.cl_order)
        t_p, rid_p = tc.cluster_closest_plain(o, d, near, far, scene.cl_box,
                                              scene.cl_lw)
        tid_p = tc._map_ids(rid_p, scene.cl_order)
        torch.cuda.synchronize()
        diff = (tid_k != tid_p).cpu().numpy()
        if diff.any():
            n = scene.n_triangles
            _, chaotic = closest_f64(o.cpu().numpy()[diff], d.cpu().numpy()[diff],
                                     scene.tri_v0[:n].cpu().numpy(),
                                     scene.tri_e1[:n].cpu().numpy(),
                                     scene.tri_e2[:n].cpu().numpy())
            assert chaotic.all() and diff.mean() <= 1e-4
        same = (tid_k >= 0) & (tid_k == tid_p)
        torch.testing.assert_close(t_k[same], t_p[same], rtol=1e-5, atol=0)

        for dist in (torch.where(tid_k >= 0, t_k, torch.full_like(t_k, 3e38)),
                     torch.full_like(t_k, 3e38)):
            rgb_k, a_k = tc.cluster_shadow(o, d, dist, scene.cl_box,
                                           scene.cl_lw, scene.cl_order,
                                           scene.cl_base, scene.cl_count,
                                           op_rgb, op_a)
            rgb_p, a_p = tc.cluster_shadow_plain(o, d, dist, scene.cl_box,
                                                 scene.cl_lw, op_tab)
            live = a_p >= 1e-4
            torch.testing.assert_close(a_k[live], a_p[live], rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(rgb_k[live], rgb_p[live], rtol=1e-5,
                                       atol=1e-6)
            assert bool((a_k[~live] < 1e-4).all())


@pytest.mark.gpu
def test_translucent_shadow_products(cuda):
    """Random translucent soups: products over many hits per ray."""
    rng = np.random.default_rng(3)
    n = 700
    v0 = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-0.35, 0.35, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.35, 0.35, (n, 3)).astype(np.float32)
    tabs = [torch.as_tensor(x, device=cuda)
            for x in tc.build_cluster_tables(v0, e1, e2)]
    box, frames, order, base, count = tabs
    op_rgb = torch.as_tensor(rng.uniform(0.3, 1.0, (n, 3)).astype(np.float32),
                             device=cuda)
    op_a = torch.as_tensor(rng.uniform(0.4, 1.0, n).astype(np.float32),
                           device=cuda)
    o = torch.as_tensor(rng.uniform(-6, 6, (4096, 3)).astype(np.float32),
                        device=cuda)
    v = rng.normal(size=(4096, 3)).astype(np.float32)
    d = torch.as_tensor(v / np.linalg.norm(v, axis=1, keepdims=True), device=cuda)
    dist = torch.full((4096,), 8.0, device=cuda)
    rgb_k, a_k = tc.cluster_shadow(o, d, dist, box, frames, order, base, count,
                                   op_rgb, op_a)
    rgb_p, a_p = tc.cluster_shadow_plain(
        o, d, dist, box, frames,
        tc.cluster_opacity(op_rgb, op_a, order, base, count))
    live = a_p >= 1e-4
    assert int((a_p[live] < 1.0).sum()) > 100
    torch.testing.assert_close(a_k[live], a_p[live], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rgb_k[live], rgb_p[live], rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_wrappers_count_launches_and_check_inputs(cuda):
    world = rt.scenes.cornell_box_nee(8, 8)
    scene = tds.compile_world(world, device=cuda)
    o = torch.zeros((64, 3), device=cuda)
    d = torch.zeros((64, 3), device=cuda)
    d[:, 2] = 1.0
    near, far = torch.zeros(64, device=cuda), torch.full((64,), 1e30, device=cuda)
    before = tc.cluster_closest.launches
    tc.cluster_closest(o, d, near, far, scene.cl_box, scene.cl_lw, scene.cl_order)
    assert tc.cluster_closest.launches == before + 1
    with pytest.raises(ValueError):             # float64 rays are refused
        tc.cluster_closest(o.double(), d, near, far, scene.cl_box,
                           scene.cl_lw, scene.cl_order)
    with pytest.raises(ValueError):             # non-contiguous rays too
        tc.cluster_closest(o.t().contiguous().t(), d, near, far,
                           scene.cl_box, scene.cl_lw, scene.cl_order)
    assert tc.cluster_closest.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell_box_nee", "multi_light"])
def test_render_cuda_matches_cpu(cuda, name):
    """The same numpy uniforms through bounce_step on the card (kernels) and
    on the CPU (plain versions) give the same image."""
    from rayzath_tpu_torch.engine import integrator as I
    from rayzath_tpu_torch.engine.state import init_state
    out = []
    for dev in (cuda, torch.device("cpu")):
        world = rt.scenes.SCENES[name](32, 32)
        scene = tds.compile_world(world, device=dev)
        cam = tds.compile_camera(world.cameras[0], dev)
        cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=4))
        ns = I.n_streams(cfg, scene)
        rng = np.random.default_rng(11)
        st = init_state(32, 32, dev)
        for _ in range(4):
            u = torch.as_tensor(rng.random((32 * 32, ns), dtype=np.float32),
                                device=dev)
            st = I.bounce_step(scene, cam, cfg, st, u=u)
        out.append(st.accum.cpu().numpy())
    images_match(out[0], out[1])
