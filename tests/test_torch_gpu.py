"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports no jax, so it runs on a GPU host without
jax; ``tests/conftest.py`` imports jax, so there run it as

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Rules (as in chip_smoke.py phase 2): B1 and B3 ids (and B3 instance ids)
equal the plain version's except on f64-chaotic rays, t to rtol 1e-5, and
bit for bit on the tables of ``utils/check_tables.py`` (exact ties across
rows, walks of several windows, near < 0; B3 also on instanced_field's
720p render rays and a table of more instance rows than a rank window),
where B1 must also test at
most twice the needed clusters per ray on rays that hit a near wall; B2
and B4 rgba to rtol 1e-5 / atol 1e-6 where the plain alpha >= 1e-4, and
both below 1e-4 elsewhere, also with translucent opacities on tables of
several windows, and at most twice the needed cluster tests on shadow
rays stopped by an opaque wall; the B2/B4 backwards to rtol 1e-3 of the max
|g| of autograd through the plain versions; the texture fetch on the card
to 1e-6 of the CPU's; the threefry kernel bit for bit to the plain draw;
renders from a seed (no injected uniforms) on the card against the CPU by
``images_match`` (sample counts equal; radiance tol 2e-3, frac 0.995),
across a reprojecting camera move and on the dense path; the skip-link
walk (torch ops, ``packet_traversal=False``) on the card bit for bit as on
the CPU; the draw's device-only time below its call's time. The render
cycle (``engine/cycle.py``): the keyed draw bit for bit as the by-value
draw; graph renders bit for bit as eager ``render_steps`` across a camera
move, a material edit and a checkpoint resume (``utils/check_cycle.py``),
one capture per scene and config; launch counters that count replays;
``render(block=False)`` returning before the device finishes; and a pass
that cannot be captured raising instead of rendering eagerly. The shadow
backwards B2-grad and B4-grad against their plain versions (to rtol 1e-4
of the max |g|: the same hits, the sums in another order); the compiled
training step (``parallel/train.py``): the graph step's loss bit for bit
as the eager step's and its parameters within 1e-4 of the max |step|, on
textured_room, two-level instanced_field and the cutout world at 64^2,
one capture for several steps, launch counters that count replays, and a
step that reads the device on the host raising instead of stepping
eagerly. The table gather (``ops/gather.py``): G1 bit for bit as its plain
version and G2 to 1e-6 of the max |g| of its plain version (the float64
sum rounded once) on 262,144 rays over 8 rows, on atlas-sized tables and
with int64 indices, the same G2 bits twice on a table that fits in shared
memory, autograd through both against the CPU's, and a graph step
counting both per replay; and at the main path's widths (1, 3, 4, 14,
32) and others (2, 5, 8), row counts off the warp, word,
tile and block, one-row tables, warps on one row and on 32 rows, a
[65536, 4] atlas at random, a table off the 16-byte grid, and int64
indices on each path. The renderer's spans in a profiler trace, their
mirrors on the device's timeline marked as annotations. The coherence key
(``ops/sort_rays.py``): the kernels of ``csrc/sort_keys.cu`` bit for bit
as ``coherence_keys_plain`` on the card, on every kind of
``utils/check_keys.py`` (ties, signed zeros, zero, infinite and NaN
lanes), from one ray to past the kernels' widest grid, inside a replayed
CUDA graph and on mesh_heavy's bounce states; ``sort_payload``'s order
that of the stable sort of the plain keys; one key per sorted traversal
call of a ``bounce_step`` and none on a scene that does not sort. The
bounce's kernels (``csrc/bounce.cu``, ``ops/bounce.py``): a no-grad
``bounce_step`` against the plain stages on six scenes (soup, spot and
direct lights, media and refraction, all five map kinds, two-level,
cutouts), the head's outputs bit for bit, the next state's direction,
throughput, medium and depth different on at most ``BOUNCE_FLIP_SHARE``
of the rays, the accumulations by ``images_match``; each wrapper counted
once a replayed pass and not at all under autograd; the surface kernel's
culled shadow rays (dist 0: a sample of zero weight) exactly the plain
stage's, and B2's and B4's ``live`` counts those of dist > 0, eager and
in a replayed graph.
"""
import numpy as np
import pytest
import torch

import rayzath_tpu_torch as rt
from rayzath_tpu_torch.models import device_scene as tds
from rayzath_tpu_torch.ops import camera as cam_ops
from rayzath_tpu_torch.ops import traverse_cluster as tc
from rayzath_tpu_torch.models.mesh import Mesh
from rayzath_tpu_torch.utils import check_tables as ct
from rayzath_tpu_torch.utils.check_keys import CARD_KINDS, key_rays
from rayzath_tpu_torch.utils.hostmath import Transform
from rayzath_tpu_torch.utils.parity import (closest_f64, expand_instances,
                                            images_match)

torch.set_num_threads(2)


def stacked_world(case, World, Mesh, Transform):
    """128 layers of the same translucent white material (alpha 0.01, so
    each passes 0.99 of the light), 1.0 apart along z, each an 8x8 grid of
    quads 0.1 wide: "instances" = 128 instances of one one-quad mesh
    (Ip = 128), "clusters" = one instance of one mesh whose 128 layers are
    its 128 clusters. Built from the given package's classes, so the JAX
    package and the port get the same world."""
    cells = 1 if case == "instances" else 8
    g = np.linspace(-0.05, 0.05, cells + 1)
    xx, yy = np.meshgrid(g, g, indexing="ij")
    grid = np.stack([xx.ravel(), yy.ravel(), np.zeros(xx.size)], 1)
    quads = [(i * (cells + 1) + j, (i + 1) * (cells + 1) + j,
              (i + 1) * (cells + 1) + j + 1, i * (cells + 1) + j + 1)
             for i in range(cells) for j in range(cells)]
    tris = np.asarray([t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))])
    layers = 1 if case == "instances" else 128
    verts = np.concatenate([grid + (0.0, 0.0, k) for k in range(layers)])
    tri_v = np.concatenate([tris + k * len(grid) for k in range(layers)])
    w = World()
    veil = w.create_material("veil", color=(1.0, 1.0, 1.0, 0.01))
    mesh = w.meshes.create(Mesh("layers", vertices=verts.astype(np.float32),
                                tri_v=tri_v.astype(np.int32)))
    for k in range(128 // layers):
        w.create_instance(name=f"layer {k}", mesh=mesh, materials=[veil],
                          transform=Transform(position=(0.0, 0.0, float(k))))
    return w


def stack_rays(case):
    """128 shadow rays straight through the stack of ``stacked_world``, each
    well inside one triangle of its layer's grid: every row of the 128-row
    table is feasible for the block."""
    cells = 1 if case == "instances" else 8
    ij = np.random.default_rng(4).integers(0, cells, (128, 2))
    cw = 0.1 / cells
    xy = -0.05 + (ij + (0.7, 0.3)) * cw
    o = np.concatenate([xy, np.full((128, 1), -1.0)], 1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (128, 1))
    return o, d, np.full(128, 1000.0, np.float32)


def shadow_gate(got, ref):
    """The renderer's shadow gate: rgba (``got`` against the plain ``ref``)
    to rtol 1e-5 / atol 1e-6 where the plain alpha is at least 1e-4, both
    alphas below 1e-4 elsewhere."""
    (rgb_k, a_k), (rgb_p, a_p) = got, ref
    live = a_p >= 1e-4
    torch.testing.assert_close(a_k[live], a_p[live], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rgb_k[live], rgb_p[live], rtol=1e-5, atol=1e-6)
    assert bool((a_k[~live] < 1e-4).all())


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
            shadow_gate(tc.cluster_shadow(o, d, dist, scene.cl_box,
                                          scene.cl_lw, scene.cl_order,
                                          scene.cl_base, scene.cl_count,
                                          op_rgb, op_a),
                        tc.cluster_shadow_plain(o, d, dist, scene.cl_box,
                                                scene.cl_lw, op_tab))


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
    got = tc.cluster_shadow(o, d, dist, box, frames, order, base, count,
                            op_rgb, op_a)
    ref = tc.cluster_shadow_plain(
        o, d, dist, box, frames,
        tc.cluster_opacity(op_rgb, op_a, order, base, count))
    a_p = ref[1]
    assert int(((a_p >= 1e-4) & (a_p < 1.0)).sum()) > 100
    shadow_gate(got, ref)


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


def _two_level_world(name, res):
    if name == "instanced_field":
        return rt.scenes.instanced_field(res, res, n=3, resolution=12)
    return rt.scenes.SCENES[name](res, res)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["instanced_field", "multi_light"])
def test_inst_kernels_match_plain(cuda, name):
    """B3/B4 against their plain versions on two-level scenes: camera rays
    and bounce-like rays."""
    world = _two_level_world(name, 8)
    scene = tds.compile_world(world, two_level=True, device=cuda)
    cam = tds.compile_camera(world.cameras[0], cuda)
    res = 128
    r = res * res
    o, d = cam_ops.generate_rays(cam, cam_ops.pixel_grid(res, res, device=cuda),
                                 torch.full((r, 4), 0.5, device=cuda))
    near = torch.zeros(r, device=cuda)
    far = torch.full((r,), 1e30, device=cuda)
    tabs = (scene.ti_rows, scene.cl_obox, scene.cl_lw)
    t, _, _ = tc.cluster_closest_inst_plain(o, d, near, far, *tabs)
    p = torch.where((t > 0)[:, None] & (t < 1e30)[:, None],
                    o + d * (t * 0.999)[:, None], o)
    v = np.random.default_rng(res).normal(size=(r, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    op_tab = tc.instance_opacity(scene.mat_color, scene.inst_slot_map)
    for o, d in ((o, d), (p.contiguous(), torch.as_tensor(v, device=cuda))):
        before = tc.cluster_closest_inst.launches
        t_k, tid_k, inst_k = tc.cluster_closest_inst(o, d, near, far, *tabs)
        assert tc.cluster_closest_inst.launches == before + 1
        t_p, tid_p, inst_p = tc.cluster_closest_inst_plain(o, d, near, far, *tabs)
        torch.cuda.synchronize()
        diff = ((tid_k != tid_p) | (inst_k != inst_p)).cpu().numpy()
        if diff.any():
            v0, e1, e2, _, _ = expand_instances(
                *(x.cpu().numpy() for x in (scene.ti_rows, scene.cl_obox,
                                            scene.inst_fwd, scene.tri_v0,
                                            scene.tri_e1, scene.tri_e2)))
            _, chaotic = closest_f64(o.cpu().numpy()[diff],
                                     d.cpu().numpy()[diff], v0, e1, e2)
            assert chaotic.all() and diff.mean() <= 1e-4
        same = (tid_k >= 0) & (tid_k == tid_p) & (inst_k == inst_p)
        assert int(same.sum()) > r // 10
        torch.testing.assert_close(t_k[same], t_p[same], rtol=1e-5, atol=0)

        for dist in (torch.where(tid_k >= 0, t_k, torch.full_like(t_k, 3e38)),
                     torch.full_like(t_k, 3e38)):
            shadow_gate(tc.cluster_shadow_inst(
                o, d, dist, *tabs, scene.cl_slot, scene.inst_slot_map,
                scene.mat_color),
                tc.cluster_shadow_inst_plain(o, d, dist, *tabs, scene.cl_slot,
                                             op_tab))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["instances", "clusters"])
def test_inst_shadow_takes_every_factor_of_128_rows(cuda, case):
    """The B4 kernel walks every row of a 128-row table whose rows are all
    feasible for the block (the JAX ranked loops drop the last one, ROADMAP
    C): alpha is the analytic 0.99^128."""
    scene = tds.compile_world(stacked_world(case, rt.World, Mesh, Transform),
                              two_level=True, device=cuda)
    o, d, dist = (torch.as_tensor(x, device=cuda) for x in stack_rays(case))
    rgb, a = tc.cluster_shadow_inst(o, d, dist, scene.ti_rows, scene.cl_obox,
                                    scene.cl_lw, scene.cl_slot,
                                    scene.inst_slot_map, scene.mat_color)
    torch.cuda.synchronize()
    np.testing.assert_allclose(a.cpu().numpy(), 0.99 ** 128, rtol=1e-5)
    np.testing.assert_allclose(rgb.cpu().numpy(), 1.0, rtol=1e-6)


@pytest.mark.gpu
def test_render_two_level_cuda_matches_cpu(cuda):
    """A two-level scene through bounce_step on the card (B3/B4) and on the
    CPU (plain versions) with the same uniforms gives the same image."""
    from rayzath_tpu_torch.engine import integrator as I
    from rayzath_tpu_torch.engine.state import init_state
    out = []
    for dev in (cuda, torch.device("cpu")):
        world = _two_level_world("instanced_field", 32)
        scene = tds.compile_world(world, two_level=True, device=dev)
        cam = tds.compile_camera(world.cameras[0], dev)
        cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=4))
        ns = I.n_streams(cfg, scene)
        rng = np.random.default_rng(12)
        st = init_state(32, 32, dev)
        for _ in range(4):
            u = torch.as_tensor(rng.random((32 * 32, ns), dtype=np.float32),
                                device=dev)
            st = I.bounce_step(scene, cam, cfg, st, u=u)
        out.append(st.accum.cpu().numpy())
    images_match(out[0], out[1])


@pytest.mark.gpu
@pytest.mark.parametrize("rotate", [False, True])
def test_fetch_cuda_matches_cpu(cuda, rotate):
    """The texture fetch on the card against the same call on the CPU, both
    atlases, every filter and address mode: to 1e-6 absolute with
    unrotated UV transforms; with rotations to 1e-5, since CUDA's cos and
    sin may differ from the CPU's in the last bit and the texel coordinate
    scales that by the map width (measured: 2.6e-6)."""
    from rayzath_tpu_torch.ops import texture as ttex
    rng = np.random.default_rng(6)
    col = rng.uniform(0, 1, (16, 16, 4)).astype(np.float32)
    sc = rng.uniform(0, 1, (8, 16)).astype(np.float32)
    rects = np.array([[1, 2, 7, 5]] * 4 + [[9, 3, 4, 9]] * 4 + [[0, 0, 6, 6]] * 4
                     + [[2, 7, 3, 8]] * 4, np.int32)
    flags = np.array([(f, a, k) for k in (0, 1) for f in (0, 1) for a in range(4)],
                     np.int32)
    uvp = np.column_stack([rng.uniform(0.5, 2, 16), rng.uniform(0.5, 2, 16),
                           rng.uniform(-1, 1, 16) * rotate, rng.uniform(-0.5, 0.5, 16),
                           rng.uniform(-0.5, 0.5, 16)]).astype(np.float32)
    uv = rng.uniform(-2.5, 2.5, (20000, 2)).astype(np.float32)
    for atlas, table in ((0, col), (1, sc)):
        ids = np.nonzero(flags[:, 2] == atlas)[0]
        blk = ttex.block_indices(rects[ids], *table.shape[:2])
        map_id = rng.choice(ids, len(uv)).astype(np.int32)
        args = (table, blk, rects, flags, uvp, map_id, uv)
        cpu = ttex.fetch(*map(torch.as_tensor, args))
        gpu = ttex.fetch(*(torch.as_tensor(x, device=cuda) for x in args))
        torch.testing.assert_close(gpu.cpu(), cpu, rtol=0,
                                   atol=1e-5 if rotate else 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["b2", "b4"])
def test_shadow_backward_matches_plain_twin(cuda, kind):
    """The B2/B4 autograd.Functions on the card (kernel forward, B2-grad
    / B4-grad backward) against autograd through the plain twins on the card:
    rgba to the forward rules, the gradients of rays and opacities to rtol
    1e-3 of their max |g| (rays whose alpha is below 1e-4 get no
    cotangent: the kernel stops there). Half the materials are translucent."""
    rng = np.random.default_rng(13)
    if kind == "b2":
        world = rt.scenes.multi_light(8, 8)
        for m in list(world.materials)[::2]:
            m.color = np.asarray([*m.color[:3], 0.55], np.float32)
        scene = tds.compile_world(world, device=cuda)
    else:
        world = _two_level_world("instanced_field", 8)
        for m in list(world.materials)[::2]:
            m.color = np.asarray([*m.color[:3], 0.55], np.float32)
        scene = tds.compile_world(world, two_level=True, differentiable=True,
                                  device=cuda)
    rays = _rays(scene, world, cuda, 64) if kind == "b2" else None
    if kind == "b4":
        cam = tds.compile_camera(world.cameras[0], cuda)
        o, d = cam_ops.generate_rays(cam, cam_ops.pixel_grid(64, 64, device=cuda),
                                     torch.full((4096, 4), 0.5, device=cuda))
        v = rng.normal(size=(4096, 3)).astype(np.float32)
        rays = [(o + d * 2.0, torch.as_tensor(v / np.linalg.norm(v, axis=1, keepdims=True),
                                              device=cuda))]
    o, d = rays[-1]
    r = o.shape[0]
    dist = torch.full((r,), 3e38, device=cuda)
    tris = (scene.tri_v0, scene.tri_e1, scene.tri_e2)
    mc = scene.mat_color.clone().requires_grad_(True)
    mc_p = scene.mat_color.clone().requires_grad_(True)
    if kind == "b2":
        def op(m):
            mat = m[scene.tri_mat.long()]
            return mat[:, :3], 1.0 - mat[:, 3]
        fn = tc.cluster_shadow(o, d, dist, scene.cl_box, scene.cl_lw,
                               scene.cl_order, scene.cl_base, scene.cl_count,
                               *op(mc), tris=tris)
        plain = tc.cluster_shadow_plain(
            o, d, dist, scene.cl_box, scene.cl_lw,
            tc.cluster_opacity(*op(mc_p), scene.cl_order, scene.cl_base,
                               scene.cl_count))
    else:
        tabs = (scene.ti_rows, scene.cl_obox, scene.cl_lw, scene.cl_slot,
                scene.inst_slot_map)
        fn = tc.cluster_shadow_inst(o, d, dist, *tabs, mc, tris=tris,
                                    expanded=(scene.tri_slot, scene.exp_tri,
                                              scene.exp_inst, scene.inst_fwd))
        plain = tc.cluster_shadow_inst_plain(
            o, d, dist, *tabs[:4], tc.instance_opacity(mc_p, scene.inst_slot_map))
    live = plain[1] >= 1e-4
    assert int(((plain[1] > 0) & (plain[1] < 1)).sum()) > 100
    for a, b in zip(fn, plain):
        torch.testing.assert_close(a[live].detach(), b[live].detach(),
                                   rtol=1e-5, atol=1e-6)
    g = (torch.randn(r, 3, device=cuda) * live[:, None],
         torch.randn(r, device=cuda) * live)
    got, = torch.autograd.grad(fn, mc, g)
    ref, = torch.autograd.grad(plain, mc_p, g)
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= 1e-3, err


def _table_tensors(tabs, keys, dev):
    return [torch.as_tensor(tabs[k], device=dev) for k in keys]


def _aimed_rays(tabs, r, seed, dev):
    o, d = ct.aimed_rays(tabs["v0"], tabs["e1"], tabs["e2"], r, seed)
    return (torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev),
            torch.zeros(r, device=dev), torch.full((r,), 1e30, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ties", "windows", "stop", "negative_near"])
def test_ranked_b1_matches_plain_bit_for_bit(cuda, case):
    """B1's ranked walk on the tie table (every hit ties exactly in two
    cluster rows, the later row entered first), on a table of more than
    two windows of rows, on rays that hit a near wall with five times as
    many clusters behind the hits on their lines ("stop": the walk tests
    at most twice the needed clusters per ray and stages under a quarter
    of the rows per block, as the model in test_torch_ranked_walk.py
    does), and on the tie table with near < 0 on every other ray: ids and
    t equal the plain version's bit for bit."""
    tabs = {"windows": ct.window_tables,
            "stop": lambda: ct.window_tables(rows=200, n=300, seed=8)}.get(
                case, ct.tie_tables)()
    box, frames, order = _table_tensors(tabs, ("box_tab", "frames", "order"),
                                        cuda)
    if case == "windows":
        assert tabs["real_rows"] > 2 * ct.RANK_WINDOW
    r = 4096
    o, d, near, far = _aimed_rays(tabs, r, 5, cuda)
    if case == "stop":
        o, d = (torch.as_tensor(x, device=cuda)
                for x in ct.wall_rays(tabs["v0"], tabs["e1"], tabs["e2"], r))
    if case == "negative_near":
        near[::2] = -3.0
    visits = torch.zeros(r + r // 128, dtype=torch.int32, device=cuda)
    t_k, tid_k = tc.cluster_closest(o, d, near, far, box, frames, order,
                                    visits=visits)
    t_p, rid_p = tc.cluster_closest_plain(o, d, near, far, box, frames)
    tid_p = tc._map_ids(rid_p, order)
    torch.cuda.synchronize()
    assert torch.equal(tid_k, tid_p), int((tid_k != tid_p).sum())
    assert torch.equal(t_k, t_p), int((t_k != t_p).sum())
    assert int((tid_k >= 0).sum()) > r // 3
    if case == "ties":      # the earlier copy wins every tie
        assert bool((rid_p[rid_p >= 0] < int(box[tc.B_BASE,
                                                 tabs["real_rows"] // 2])).all())
    if case == "negative_near":
        assert bool((t_p[tid_p >= 0] < 0).any())    # a hit behind an origin
    assert int(visits[:r].sum()) > 0
    assert 0 < int(visits[r:].max()) <= tabs["real_rows"]
    if case == "stop":
        needed = ct.needed_soup(o, d, near, t_p, box)[0]
        on_line = ct.needed_soup(o, d, near, far, box)[0]
        assert on_line >= 3 * needed > 0, (on_line, needed)
        assert int(visits[:r].sum()) <= 2 * needed, (int(visits[:r].sum()), needed)
        assert float(visits[r:].float().mean()) < tabs["real_rows"] / 4


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ties", "windows", "negative_near"])
def test_ranked_b3_matches_plain_bit_for_bit(cuda, case):
    """B3's ranked walk on the tie tables (exact ties across instance rows
    and cluster rows, the later row entered first), on a mesh of more
    clusters than one window, and on the tie tables with near < 0 on every
    other ray: t, ids and instance ids equal the plain version's bit for
    bit."""
    tabs = (ct.window_instance_tables() if case == "windows"
            else ct.tie_instance_tables())
    ti, obox, frames = _table_tensors(tabs, ("ti_rows", "cl_obox", "frames"),
                                      cuda)
    if case == "windows":
        assert obox.shape[0] > ct.MESH_WINDOW
    r = 4096
    o, d, near, far = _aimed_rays(tabs, r, 6, cuda)
    if case == "negative_near":
        near[::2] = -3.0
    visits = torch.zeros(r + r // 128, dtype=torch.int32, device=cuda)
    got = tc.cluster_closest_inst(o, d, near, far, ti, obox, frames,
                                  visits=visits)
    ref = tc.cluster_closest_inst_plain(o, d, near, far, ti, obox, frames)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b), int((a != b).sum())
    hit = ref[1] >= 0
    assert int(hit.sum()) > r // 3
    if case == "ties":      # instance row 0 wins its ties with row 1
        assert bool((ref[2][hit] != 1).all())
    if case == "negative_near":
        assert bool((ref[0][hit] < 0).any())        # a hit behind an origin
    assert int(visits[:r].sum()) > 0 and int(visits[r:].max()) > 0


def _field_rays(scene, world, dev, res):
    """instanced_field's camera rays (u = 0.5) at res^2 and bounce-like rays
    with seeded sphere directions from their first hits (plain B3)."""
    cam = tds.compile_camera(world.cameras[0], dev)
    r = res * res
    o, d = cam_ops.generate_rays(cam, cam_ops.pixel_grid(res, res, device=dev),
                                 torch.full((r, 4), 0.5, device=dev))
    near, far = torch.zeros(r, device=dev), torch.full((r,), 1e30, device=dev)
    t, tid, _ = tc.cluster_closest_inst_plain(o, d, near, far, scene.ti_rows,
                                              scene.cl_obox, scene.cl_lw)
    p = torch.where((tid >= 0)[:, None], o + d * (t * 0.999)[:, None], o)
    v = np.random.default_rng(res).normal(size=(r, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return [(o, d), (p.contiguous(), torch.as_tensor(v, device=dev))]


def _render_walk_rays(world, dev, monkeypatch, passes=3):
    """The rays that B3 and B4 take in the last of ``passes`` eager passes
    (``render_steps``) of ``world``, sorted as the kernels see them: [(o, d,
    near, far)] and [(o, d, dist)]."""
    from rayzath_tpu_torch.engine import integrator as I
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.ops import rng
    seen = {}
    b3, b4 = I.cluster_closest_inst, I.cluster_shadow_inst

    def rec3(o, d, near, far, *a, **k):
        seen["b3"] = [x.clone() for x in (o, d, near, far)]
        return b3(o, d, near, far, *a, **k)

    def rec4(o, d, dist, *a, **k):
        seen["b4"] = [x.clone() for x in (o, d, dist)]
        return b4(o, d, dist, *a, **k)

    monkeypatch.setattr(I, "cluster_closest_inst", rec3)
    monkeypatch.setattr(I, "cluster_shadow_inst", rec4)
    scene = tds.compile_world(world, device=dev)
    cam = tds.compile_camera(world.cameras[0], dev)
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=16),
                          light_sampling=rt.LightSampling(spot_light=1,
                                                          direct_light=1))
    st = init_state(world.cameras[0].resolution[0],
                    world.cameras[0].resolution[1], dev)
    with torch.no_grad():
        I.render_steps(scene, cam, cfg, st, rng.key(5), passes)
    monkeypatch.undo()
    return scene, [seen["b3"]], [seen["b4"]]


def _inst_walk_case(case, dev, monkeypatch):
    """(B3 tables, B4 tables, [(o, d, near, far)], [(o, d, dist)], plain
    stride) of a case of test_inst_walks_match_plain."""
    big = 3.4e38
    if case in ("field", "big_mesh"):
        resolution = 60 if case == "big_mesh" else 48
        world = rt.scenes.instanced_field(64, 64, resolution=resolution)
        scene = tds.compile_world(world, two_level=True, device=dev)
        sets = _field_rays(scene, world, dev, 64)
        b3 = [(o, d, torch.zeros(len(o), device=dev),
               torch.full((len(o),), 1e30, device=dev)) for o, d in sets]
        b4 = [(o, d, torch.full((len(o),), big, device=dev)) for o, d in sets]
    elif case == "field_720":
        scene, b3, b4 = _render_walk_rays(rt.scenes.instanced_field(1280, 720),
                                          dev, monkeypatch)
    if case in ("field", "big_mesh", "field_720"):
        mats = (scene.cl_slot, scene.inst_slot_map,
                half_translucent(scene.mat_color))
        return ((scene.ti_rows, scene.cl_obox, scene.cl_lw), mats, b3, b4,
                64 if case == "field_720" else 1)
    tabs = {"instance_windows": ct.many_instance_tables,
            "mesh_windows": ct.window_instance_tables}.get(
                case, ct.tie_instance_tables)()
    ti, obox, frames = _table_tensors(tabs, ("ti_rows", "cl_obox", "frames"),
                                      dev)
    mats = ct.instance_materials(tabs, seed=16)
    mats = tuple(torch.as_tensor(mats[k], device=dev)
                 for k in ("cl_slot", "inst_slot_map", "mat_color"))
    r = 4096
    if case == "instance_windows":
        o, d = (torch.as_tensor(x, device=dev) for x in ct.aimed_rays(
            tabs["v0"], tabs["e1"], tabs["e2"], r, 17, spread=200.0))
        rays = (o, d, torch.zeros(r, device=dev),
                torch.full((r,), 1e30, device=dev))
    else:
        rays = _aimed_rays(tabs, r, 6, dev)
        if case == "negative_near":
            rays[2][::2] = -3.0
    return ((ti, obox, frames), mats, [rays],
            [(*rays[:2], torch.full((r,), big, device=dev))],
            16 if case == "instance_windows" else 1)


def half_translucent(mat_color):
    """Every other material (from index 2) at alpha 0.5, as chip_smoke.py's
    translucent sets."""
    mc = mat_color.clone()
    mc[2::2, 3] = 0.5
    return mc


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["field", "field_720", "negative_near",
                                  "instance_windows", "big_mesh",
                                  "mesh_windows", "ties"])
def test_inst_walks_match_plain(cuda, case, monkeypatch):
    """B3 and B4 (the warp walk) against the plain versions: B3's t, ids
    and instances bit for bit, B4 to the forward gate. Cases:
    instanced_field (24 + 1 clusters) at 64^2, camera and bounce-like rays;
    its 1280x720 render rays (the third pass, the plain versions on every
    64th ray); a table of more instance rows than one rank window
    (RANK_WINDOW), plain on every 16th ray; a sphere of 40 clusters and a
    mesh of 612, which a warp ranks and walks in windows of BATCH; the tie
    tables (a mesh of BATCH clusters), also with near < 0 on every other
    ray."""
    (ti, obox, frames), mats, b3_sets, b4_sets, stride = \
        _inst_walk_case(case, cuda, monkeypatch)
    assert (case != "instance_windows") or ti.shape[0] > ct.RANK_WINDOW
    op_tab = tc.instance_opacity(mats[2], mats[1])
    for o, d, near, far in b3_sets:
        got = tc.cluster_closest_inst(o, d, near, far, ti, obox, frames)
        sub = torch.arange(0, len(o), stride, device=cuda)
        ref = tc.cluster_closest_inst_plain(o[sub], d[sub], near[sub],
                                            far[sub], ti, obox, frames)
        torch.cuda.synchronize()
        for a, c in zip(got, ref):
            assert torch.equal(a[sub], c), int((a[sub] != c).sum())
        assert int((got[1] >= 0).sum()) > len(o) // 5
        if case == "negative_near":
            assert bool((ref[0][ref[1] >= 0] < 0).any())
    for o, d, dist in b4_sets:
        got = tc.cluster_shadow_inst(o, d, dist, ti, obox, frames, *mats)
        sub = torch.arange(0, len(o), stride, device=cuda)
        ref = tc.cluster_shadow_inst_plain(o[sub], d[sub], dist[sub], ti,
                                           obox, frames, mats[0], op_tab)
        torch.cuda.synchronize()
        shadow_gate([x[sub] for x in got], ref)
        assert int(((ref[1] > 0) & (ref[1] < 1)).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["b2", "b4"])
@pytest.mark.parametrize("case", ["windows", "stop"])
def test_ranked_shadow_matches_plain(cuda, case, kernel):
    """B2's and B4's ranked walks with dist = BIG: "windows", translucent
    opacities on a table of more than two windows of rows (B2) or a mesh of
    more clusters than one window (B4), so that products run over several
    windows; "stop", opaque walls hit by rays along (1, 1, 1) whose lines
    cross five times the clusters they need: the walk tests at most twice
    the needed ones per ray (the visit counter), as the model in
    test_torch_ranked_walk.py does. rgba to the forward gate."""
    r = 4096
    dist = torch.full((r,), 3.4e38, device=cuda)
    zero, far = torch.zeros(r, device=cuda), torch.full((r,), 1e30, device=cuda)
    visits = torch.zeros(r + r // 128, dtype=torch.int32, device=cuda)
    if kernel == "b2":
        tabs = (ct.window_tables() if case == "windows"
                else ct.window_tables(rows=200, n=300, seed=8))
        box, frames, order = _table_tensors(tabs, ("box_tab", "frames", "order"),
                                            cuda)
        op = {k: torch.as_tensor(v, device=cuda)
              for k, v in ct.soup_opacity(tabs, seed=10).items()}
        if case == "windows":
            assert tabs["real_rows"] > 2 * ct.RANK_WINDOW
        else:
            op["op_a"].zero_()                                   # opaque
        args = (box, frames, order, op["base"], op["count"], op["op_rgb"],
                op["op_a"])
    else:
        tabs = (ct.window_instance_tables() if case == "windows"
                else ct.window_instance_tables(rows=200, n=300, seed=9))
        ti, obox, frames = _table_tensors(tabs, ("ti_rows", "cl_obox", "frames"),
                                          cuda)
        mats = {k: torch.as_tensor(v, device=cuda) for k, v in
                ct.instance_materials(tabs, seed=12, alpha=(
                    (0.05, 0.5) if case == "windows" else (1.0, 1.0))).items()}
        if case == "windows":
            assert obox.shape[0] > ct.MESH_WINDOW
        args = (ti, obox, frames, mats["cl_slot"], mats["inst_slot_map"],
                mats["mat_color"])
    if case == "windows":
        o, d, *_ = _aimed_rays(tabs, r, 7, cuda)
    else:
        o, d = (torch.as_tensor(x, device=cuda)
                for x in ct.wall_rays(tabs["v0"], tabs["e1"], tabs["e2"], r))
    if kernel == "b2":
        got = tc.cluster_shadow(o, d, dist, *args, visits=visits)
        ref = tc.cluster_shadow_plain(o, d, dist, box, frames, tc.cluster_opacity(
            op["op_rgb"], op["op_a"], order, op["base"], op["count"]))
    else:
        got = tc.cluster_shadow_inst(o, d, dist, *args, visits=visits)
        ref = tc.cluster_shadow_inst_plain(
            o, d, dist, ti, obox, frames, mats["cl_slot"],
            tc.instance_opacity(mats["mat_color"], mats["inst_slot_map"]))
    torch.cuda.synchronize()
    shadow_gate(got, ref)
    made = int(visits[:r].sum())
    assert made > 0 and int(visits[r:].max()) > 0
    if case == "windows":
        assert int(((ref[1] > 1e-4) & (ref[1] < 0.5)).sum()) > r // 20
        return
    assert bool((ref[1] == 0).all())              # every ray meets the wall
    if kernel == "b2":
        t = tc.cluster_closest_plain(o, d, zero, far, box, frames)[0]
        needed = ct.needed_soup(o, d, zero, t, box)[0]
        on_line = ct.needed_soup(o, d, zero, dist, box)[0]
    else:
        t = tc.cluster_closest_inst_plain(o, d, zero, far, ti, obox, frames)[0]
        needed = ct.needed_inst(o, d, zero, t, ti, obox)[0]
        on_line = ct.needed_inst(o, d, zero, dist, ti, obox)[0]
    assert on_line >= 5 * needed > 0, (on_line, needed)
    assert made <= 2 * needed, (made, needed)


def _grouped_tables(case):
    """The tables of the ranked-walk tests built above the grouped line:
    "ties" the tie table of a 70,000-triangle soup (copies 965 rows apart,
    in other groups), "windows" the table of more than two rank windows,
    "stop" a 1,100-row wall table (its last group part padding)."""
    tabs = {"windows": ct.window_tables,
            "stop": lambda: ct.window_tables(rows=1100, n=300, seed=8)}.get(
                case, lambda: ct.tie_tables(n=70000))()
    assert tabs["box_tab"].shape[1] > tc.GROUPED_ROWS
    return tabs, tc.group_table(tabs["box_tab"])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ties", "windows", "stop", "negative_near"])
def test_grouped_b1_matches_plain_bit_for_bit(cuda, case):
    """B1's grouped walk on the tables of
    test_ranked_b1_matches_plain_bit_for_bit built above the grouped line:
    ids and t bit for bit as the plain version's, one launch counted in
    ``grouped``, and the group rows each block entered in the visit
    counter's third part; on the wall rays ("stop") at most twice the
    needed cluster tests per ray, and under a quarter of the rows staged
    per block, as the flat walk."""
    tabs, groups = _grouped_tables(case)
    box, frames, order, groups = _table_tensors(
        dict(tabs, groups=groups), ("box_tab", "frames", "order", "groups"),
        cuda)
    r = 4096
    blocks = r // 128
    o, d, near, far = _aimed_rays(tabs, r, 5, cuda)
    if case == "stop":
        o, d = (torch.as_tensor(x, device=cuda)
                for x in ct.wall_rays(tabs["v0"], tabs["e1"], tabs["e2"], r))
    if case == "negative_near":
        near[::2] = -3.0
    visits = torch.zeros(r + 2 * blocks, dtype=torch.int32, device=cuda)
    before = tc.cluster_closest.grouped
    slabs_before = tc.cluster_closest.work.read()["slab_tests"]
    t_k, tid_k = tc.cluster_closest(o, d, near, far, box, frames, order,
                                    groups=groups, visits=visits)
    assert tc.cluster_closest.grouped == before + 1
    t_p, rid_p = tc.cluster_closest_plain(o, d, near, far, box, frames)
    tid_p = tc._map_ids(rid_p, order)
    torch.cuda.synchronize()
    assert torch.equal(tid_k, tid_p), int((tid_k != tid_p).sum())
    assert torch.equal(t_k, t_p), int((t_k != t_p).sum())
    assert int((tid_k >= 0).sum()) > r // 3
    if case == "ties":      # the earlier copy wins every tie
        m = tabs["real_rows"] // 2
        assert m > tc.GROUP
        assert bool((rid_p[rid_p >= 0] < int(box[tc.B_BASE, m])).all())
    if case == "negative_near":
        assert bool((t_p[tid_p >= 0] < 0).any())    # a hit behind an origin
    real_groups = int((groups[tc.B_CNT] > 0).sum())
    staged, entered = visits[r:].reshape(2, blocks)
    slabs = tc.cluster_closest.work.read()["slab_tests"] - slabs_before
    assert int(visits[:r].sum()) > 0
    assert 0 < int(staged.max()) <= tabs["real_rows"]
    assert 0 < int(entered.max()) <= real_groups
    # each ray's gate tests at most every group and every row of the groups
    # its block entered, each twice (vote and visit)
    assert 0 < slabs <= int((2 * 128 * (real_groups + tc.GROUP * entered)).sum())
    if case == "stop":
        needed = ct.needed_soup(o, d, near, t_p, box)[0]
        on_line = ct.needed_soup(o, d, near, far, box)[0]
        assert on_line >= 3 * needed > 0, (on_line, needed)
        assert int(visits[:r].sum()) <= 2 * needed, (int(visits[:r].sum()), needed)
        assert float(staged.float().mean()) < tabs["real_rows"] / 4


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["windows", "stop"])
def test_grouped_b2_matches_plain(cuda, case):
    """B2's grouped walk with dist = BIG on the tables above the grouped
    line: translucent opacities on the table of more than two rank windows
    ("windows"), opaque walls hit along (1, 1, 1) ("stop": at most twice
    the needed cluster tests per ray); rgba to the forward gate, one
    launch counted in ``grouped``."""
    tabs, groups = _grouped_tables(case)
    box, frames, order, groups = _table_tensors(
        dict(tabs, groups=groups), ("box_tab", "frames", "order", "groups"),
        cuda)
    r = 4096
    blocks = r // 128
    dist = torch.full((r,), 3.4e38, device=cuda)
    zero, far = torch.zeros(r, device=cuda), torch.full((r,), 1e30, device=cuda)
    op = {k: torch.as_tensor(v, device=cuda)
          for k, v in ct.soup_opacity(tabs, seed=10).items()}
    if case == "stop":
        op["op_a"].zero_()                                       # opaque
        o, d = (torch.as_tensor(x, device=cuda)
                for x in ct.wall_rays(tabs["v0"], tabs["e1"], tabs["e2"], r))
    else:
        o, d, *_ = _aimed_rays(tabs, r, 7, cuda)
    args = (box, frames, order, op["base"], op["count"], op["op_rgb"],
            op["op_a"])
    visits = torch.zeros(r + 2 * blocks, dtype=torch.int32, device=cuda)
    before = tc.cluster_shadow.grouped
    got = tc.cluster_shadow(o, d, dist, *args, groups=groups, visits=visits)
    assert tc.cluster_shadow.grouped == before + 1
    ref = tc.cluster_shadow_plain(o, d, dist, box, frames, tc.cluster_opacity(
        op["op_rgb"], op["op_a"], order, op["base"], op["count"]))
    torch.cuda.synchronize()
    shadow_gate(got, ref)
    made = int(visits[:r].sum())
    assert made > 0 and int(visits[r + blocks:r + 2 * blocks].max()) > 0
    if case == "windows":
        assert int(((ref[1] > 1e-4) & (ref[1] < 0.5)).sum()) > r // 20
        return
    assert bool((ref[1] == 0).all())              # every ray meets the wall
    t = tc.cluster_closest_plain(o, d, zero, far, box, frames)[0]
    needed = ct.needed_soup(o, d, zero, t, box)[0]
    assert made <= 2 * needed, (made, needed)


@pytest.mark.gpu
def test_grouped_counts_replays(cuda):
    """A replayed pass on a scene above the grouped line (mesh_heavy at
    resolution 400) takes the grouped walk in every B1 and B2 launch:
    ``grouped`` gains what ``launches`` gains; on cornell_box_nee (128
    rows) it gains nothing."""
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=4))
    for big, world in ((True, rt.scenes.mesh_heavy(64, 64, resolution=400)),
                       (False, rt.scenes.cornell_box_nee(64, 64))):
        r = rt.Renderer(world, cfg, seed=3, device=cuda)
        r.render(rpp=1)                              # capture
        assert (r.scene.cl_box.shape[1] > tc.GROUPED_ROWS) == big
        wrappers = (tc.cluster_closest, tc.cluster_shadow)
        start = [(f.launches, f.grouped) for f in wrappers]
        r.render(rpp=3)
        for f, (launches, grouped) in zip(wrappers, start):
            gained = f.launches - launches
            assert gained >= 3
            assert f.grouped - grouped == (gained if big else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed,pass_idx,row0,h,w,ns", [
    (0, 0, 0, 4, 7, 8), (7, 3, 5, 16, 33, 14), (2 ** 31 - 1, 11, 300, 3, 512, 11),
    (9, 1, 0, 512, 512, 8), (3, 1, 2, 700, 1, 3)])
def test_threefry_kernel_matches_plain(cuda, seed, pass_idx, row0, h, w, ns):
    """The threefry kernel draws the plain version's uniforms bit for bit,
    in one launch; also where a warp's floats span more rows than its 32
    lanes hold keys for (rows of 3 floats)."""
    from rayzath_tpu_torch.ops import rng
    k = rng.fold_in(rng.key(seed), pass_idx)
    before = rng.uniform_rows.launches
    got = rng.uniform_rows(k, row0, h, w, ns, cuda)
    assert rng.uniform_rows.launches == before + 1
    ref = rng.uniform_rows_plain(k, row0, h, w, ns, cuda)
    torch.cuda.synchronize()
    assert got.shape == (h * w, ns)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.gpu
def test_draw_device_time_below_its_call(cuda):
    """``utils/cuda_timing.device_ms`` (launches queued behind a sleep)
    gives the threefry kernel's own time at 512^2 x 14: positive and below
    the call's time with its Python wrapper (``call_ms``)."""
    from rayzath_tpu_torch.ops import rng
    from rayzath_tpu_torch.utils.cuda_timing import call_ms, device_ms
    k = rng.fold_in(rng.key(1), 0)

    def draw():
        return rng.uniform_rows(k, 0, 512, 512, 14, cuda)

    dev_ms = device_ms(draw, 50)
    assert 0.0 < dev_ms < call_ms(draw, 20)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["glass_and_fog", "cornell_box_nee"])
def test_skip_link_walk_card_matches_cpu(cuda, name):
    """The skip-link walk (torch ops) on the card returns the CPU's bits:
    closest-hit t and ids on camera and bounce-like rays, and the shadow
    rgba of rays from the hits toward the first spot light (glass_and_fog
    has leaves of more than 8 triangles, walked in blocks)."""
    from rayzath_tpu_torch.ops import traverse as tw
    world = rt.scenes.SCENES[name](64, 64)
    cpu = torch.device("cpu")
    scenes = {dev.type: tds.compile_world(world, device=dev)
              for dev in (cuda, cpu)}
    # the inputs, made once on the CPU: the card's own camera rays and
    # norms would round differently
    scene = scenes["cpu"]
    walk = (scene.aabb_links, scene.node_count, scene.leaf_tri,
            scene.tri_v0, scene.tri_e1, scene.tri_e2)
    mat = scene.mat_color[scene.tri_mat.long()]
    sets = []
    for o, d in _rays(scene, world, cpu, 64):
        r = o.shape[0]
        near, far = torch.zeros(r), torch.full((r,), 1e30)
        t, tid = tw.bvh_closest(o, d, near, far, *walk)
        p = torch.where((tid >= 0)[:, None], o + d * (t * 0.999)[:, None], o)
        v = scene.spot_pos[0] - p
        dist = torch.linalg.norm(v, dim=1)
        sets.append(((o, d, near, far), (p, v / dist[:, None], dist)))
    assert int((scene.node_count > 8).sum()) > 0 or name != "glass_and_fog"
    for closest, shadow in sets:
        out = {}
        for dev, s in scenes.items():
            walk = (s.aabb_links, s.node_count, s.leaf_tri, s.tri_v0,
                    s.tri_e1, s.tri_e2)
            mat = s.mat_color[s.tri_mat.long()]
            out[dev] = [x.cpu() for x in (
                *tw.bvh_closest(*(x.to(s.tri_v0.device) for x in closest), *walk),
                *tw.bvh_shadow(*(x.to(s.tri_v0.device) for x in shadow), *walk,
                               mat[:, :3], 1.0 - mat[:, 3]))]
        for a, b in zip(out["cuda"], out["cpu"]):
            assert torch.equal(a, b)
        assert int((out["cpu"][1] >= 0).sum()) > 1000


def _seeded_renders(make_world, cfg, dev, move):
    """Renderer(seed=5) on ``dev``: two passes, then ``move(world)`` and one
    pass. Returns copies of the accumulation after each render call (the
    renderer updates its state in place)."""
    world = make_world()
    r = rt.Renderer(world, cfg, seed=5, device=dev)
    cam = world.cameras[0]
    out = []
    for step in range(2):
        if step:
            move(world)
        r.render(rpp=2 - step)
        out.append(r.views[id(cam)].state.accum.cpu().numpy().copy())
    return out


@pytest.mark.gpu
def test_reprojection_render_cuda_matches_cpu(cuda):
    """No injected uniforms: the card's render (threefry kernel, B1/B2 and
    the reprojection through B1) and the CPU's, from the same seed, agree
    before and after a camera move under temporal_blend 0.75."""
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=4))

    def move(world):
        world.cameras[0].look_at((0.1, 0.0, 1.0))

    gpu = _seeded_renders(lambda: rt.scenes.cornell_box_nee(32, 32), cfg, cuda,
                          move)
    cpu = _seeded_renders(lambda: rt.scenes.cornell_box_nee(32, 32), cfg, "cpu",
                          move)
    for a, b in zip(gpu, cpu):
        images_match(a, b)
    assert gpu[1][..., 3].sum() > 32 * 32            # seeded beyond one pass


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["threshold", "empty"])
def test_dense_path_cuda_matches_cpu(cuda, case):
    """The dense path (brute_force_threshold above the triangle count, and
    the empty world, which has no cluster table) on the card against the
    CPU, from the same seed."""
    from rayzath_tpu_torch.utils.check_worlds import empty_world
    if case == "threshold":
        make = lambda: rt.scenes.cornell_box_nee(32, 32)    # noqa: E731
        cfg = rt.RenderConfig(brute_force_threshold=64,
                              tracing=rt.Tracing(max_depth=4))
    else:
        make = lambda: empty_world(32)                      # noqa: E731
        cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=4))
    before = tc.cluster_closest.launches
    gpu = _seeded_renders(make, cfg, cuda, lambda w: None)
    assert tc.cluster_closest.launches == before        # no cluster walk
    cpu = _seeded_renders(make, cfg, "cpu", lambda w: None)
    for a, b in zip(gpu, cpu):
        images_match(a, b)
    assert gpu[1][..., :3].max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("name", ["cornell_box_nee", "multi_light"])
def test_band_render_on_the_card(cuda, name, n):
    """n row bands on one card against the unsharded render on the card,
    same seed: sample counts equal, radiance by ``images_match`` (B2's walk
    order may differ where a band is coherence-sorted on its own)."""
    from rayzath_tpu_torch.engine.integrator import render_steps
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.ops import rng
    from rayzath_tpu_torch.parallel.mesh import sharded_render_steps
    world = rt.scenes.SCENES[name](64, 64)
    scene = tds.compile_world(world, device=cuda)
    cam = tds.compile_camera(world.cameras[0], cuda)
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=4))
    ref = render_steps(scene, cam, cfg, init_state(64, 64, cuda), rng.key(2), 3)
    got = sharded_render_steps(scene, cam, cfg, init_state(64, 64, cuda),
                               rng.key(2), 3, [cuda] * n)
    assert got.accum.device.type == "cuda" and got.height == 64
    images_match(got.accum.cpu().numpy(), ref.accum.cpu().numpy())


@pytest.mark.gpu
def test_engine_on_the_card(cuda):
    """Engine() renders on the card by default, bit for bit as
    Renderer(seed=0, device="cuda") on the same world."""
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=4))
    e = rt.Engine(cfg)
    assert e.device.type == "cuda"
    e.world = rt.scenes.cornell_box_nee(64, 64)
    e.render_world(rpp=3)
    w = rt.scenes.cornell_box_nee(64, 64)
    r = rt.Renderer(w, cfg, seed=0, device="cuda")
    r.render(rpp=3)
    a = e.renderer.views[id(e.world.cameras[0])].state.accum
    assert torch.equal(a, r.views[id(w.cameras[0])].state.accum)


@pytest.mark.gpu
def test_headless_on_the_card(cuda, tmp_path):
    """A task file with the default engine ("CUDAGPU") renders on the card
    and writes its report and a PNG."""
    import io
    import json
    import os
    from rayzath_tpu_torch.headless import Headless
    scene = {"Objects": {
        "Material": [{"name": "white", "color": [0.8, 0.8, 0.8, 1.0],
                      "emission": 5.0}],
        "Mesh": [{"name": "box", "generate cube": {}}],
        "Camera": {"name": "cam", "position": [0, 0, -3],
                   "resolution": [16, 16], "aperture": 0.02,
                   "exposure time": 1.0},
        "Instance": [{"name": "box1", "Mesh": "box", "Material": ["white"]}]},
        "Material": {"emission": 0.5}}
    (tmp_path / "scene.json").write_text(json.dumps(scene))
    (tmp_path / "tasks.json").write_text(json.dumps({"tasks": [
        {"scene path": "scene.json", "rpp": 4, "max depth": 3}]}))
    before = tc.cluster_closest.launches
    assert Headless(out=io.StringIO()).run(str(tmp_path / "tasks.json"),
                                           str(tmp_path / "out"), True) == 0
    assert tc.cluster_closest.launches >= before + 4
    report = (tmp_path / "out" / "report.txt").read_text()
    assert "engine: CUDAGPU | max depth: 3" in report
    assert [f for f in os.listdir(tmp_path / "out") if f.endswith(".png")]


@pytest.mark.gpu
def test_second_card_renders_like_the_first(cuda):
    """With cuda:0 current, a Renderer on cuda:1 launches its kernels on
    cuda:1 (each launch under its tensors' device) and renders what cuda:0
    renders, bit for bit. Skips below two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=4))
    out = []
    torch.cuda.set_device(0)
    for dev in ("cuda:0", "cuda:1"):
        w = rt.scenes.multi_light(64, 64)
        r = rt.Renderer(w, cfg, seed=1, device=dev)
        r.render(rpp=3)
        a = r.views[id(w.cameras[0])].state.accum
        assert a.device == torch.device(dev)
        out.append(a.cpu())
    assert torch.cuda.current_device() == 0
    assert torch.equal(out[0], out[1])


# ---------------------------------------------------------------------------
# the render cycle: one captured CUDA graph per pass
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("seed,pass_idx,row0,h,w,ns", [
    (0, 0, 0, 4, 7, 8), (7, 2 ** 31 - 1, 5, 16, 33, 14),
    (2 ** 31 - 1, 2 ** 32 - 1, 300, 3, 512, 11), (9, 1, 0, 512, 512, 8),
    (3, 1, 2, 700, 1, 3)])
def test_keyed_draw_matches_by_value_draw(cuda, seed, pass_idx, row0, h, w, ns):
    """The keyed entry folds fold_in(key, pass_idx) on the device and draws
    the by-value kernel's (and so the plain version's) bits, one launch."""
    from rayzath_tpu_torch.ops import rng
    k = rng.key(seed)
    counter = pass_idx - 2 ** 32 if pass_idx >= 2 ** 31 else pass_idx
    dk = rng.DeviceKey(rng.key_words(k, cuda),
                       torch.tensor(counter, dtype=torch.int32, device=cuda))
    before = rng.uniform_rows_keyed.launches
    got = rng.uniform_rows_keyed(dk, row0, h, w, ns, cuda)
    assert rng.uniform_rows_keyed.launches == before + 1
    ref = rng.uniform_rows(rng.fold_in(k, pass_idx), row0, h, w, ns, cuda)
    plain = rng.uniform_rows_plain(rng.fold_in(k, pass_idx), row0, h, w, ns,
                                   cuda)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))


def _cycle_world(name, res):
    from rayzath_tpu_torch.utils.check_worlds import cutout_world
    if name == "cutout world":
        return cutout_world(res)
    return rt.scenes.SCENES[name](res, res)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell_box_nee", "multi_light",
                                  "instanced_field", "textured_room",
                                  "cutout world"])
def test_graph_render_equals_eager(cuda, name):
    """Renderer.render on the card replays captured graphs and leaves every
    state array bit for bit as eager render_steps from the same seed, at
    64^2: an rpp sequence, a reprojecting camera move (no new capture), a
    material edit (a new capture) and a checkpoint resumed in a fresh
    renderer (its own capture)."""
    from rayzath_tpu_torch.utils.check_cycle import against_eager
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=8))
    out = against_eager(_cycle_world(name, 64), cfg, cuda, seed=4)
    assert out["captures"] == [1, 1, 1, 1, 2, 1]
    assert dict((s[0], s[2]) for s in out["stages"])["camera move"] > 64 * 64


@pytest.mark.gpu
def test_replays_count_launches(cuda):
    """Each replayed pass adds the captured pass's launches to the
    wrappers' counters: as many as one eager pass makes."""
    from rayzath_tpu_torch.engine.integrator import render_steps
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.ops import rng
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=8))
    world = rt.scenes.multi_light(64, 64)
    r = rt.Renderer(world, cfg, seed=2, device=cuda)
    r.render(rpp=1)                                  # capture
    wrappers = (tc.cluster_closest, tc.cluster_shadow, rng.uniform_rows,
                rng.uniform_rows_keyed)
    start = [f.launches for f in wrappers]
    with torch.no_grad():
        render_steps(r.scene, tds.compile_camera(world.cameras[0], cuda), cfg,
                     init_state(64, 64, cuda), rng.key(2), 1)
    eager = [f.launches - s for f, s in zip(wrappers, start)]
    # multi_light: one closest hit, a shadow ray per light sample, one draw
    assert eager[0] == 1 and eager[1] >= 2 and eager[2] == 1 and eager[3] == 0
    start = [f.launches for f in wrappers]
    r.render(rpp=5)
    got = [f.launches - s for f, s in zip(wrappers, start)]
    assert got == [5 * eager[0], 5 * eager[1], 0, 5]
    assert r.views[id(world.cameras[0])].cycle.captures == 1


@pytest.mark.gpu
def test_render_without_blocking_returns_before_the_device(cuda):
    """render(block=False) at 512^2, rpp 16, returns once the replays are
    enqueued: its host time is below the device time of the same render."""
    world = rt.scenes.cornell_box_nee(512, 512)
    r = rt.Renderer(world, rt.RenderConfig(tracing=rt.Tracing(max_depth=8)),
                    device=cuda)
    r.render(rpp=1)                                  # capture
    torch.cuda.synchronize()
    import time
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    r.render(rpp=16, block=False)
    host_ms = (time.perf_counter() - t0) * 1e3
    b.record()
    b.synchronize()
    assert host_ms < a.elapsed_time(b)
    assert r.views[id(world.cameras[0])].state.pass_idx == 17


@pytest.mark.gpu
def test_pass_that_cannot_be_captured_raises(cuda, monkeypatch):
    """A pass that reads a device value on the host cannot be captured: the
    render raises RuntimeError and renders nothing eagerly."""
    from rayzath_tpu_torch.engine import integrator as I
    mat_pack = I.mat_pack

    def reads_the_device(scene):
        mp = mat_pack(scene)
        float(mp[0, 0].item())
        return mp

    world = rt.scenes.cornell_box_nee(64, 64)
    r = rt.Renderer(world, rt.RenderConfig(tracing=rt.Tracing(max_depth=4)),
                    device=cuda)
    monkeypatch.setattr(I, "mat_pack", reads_the_device)
    with pytest.raises(RuntimeError, match="could not be captured"):
        r.render(rpp=2)
    cv = r.views[id(world.cameras[0])]
    assert cv.pass_count == 0 and cv.state.pass_idx == 0
    assert float(cv.state.accum.abs().sum()) == 0.0
    monkeypatch.setattr(I, "mat_pack", mat_pack)
    r.render(rpp=2)                                  # captures again
    assert cv.cycle.captures == 1 and cv.state.pass_idx == 2


@pytest.mark.gpu
def test_render_spans_on_the_card(cuda):
    """The renderer's spans in a profiler trace on the card: the cycle's
    capture, replays and synchronise as ``rz::capture``, ``rz::replay``
    and ``rz::wait`` inside ``rz::cycle``, and each range's mirror on the
    device's timeline marked as an annotation, not an operation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    world = rt.scenes.cornell_box_nee(64, 64)
    r = rt.Renderer(world, rt.RenderConfig(tracing=rt.Tracing(max_depth=4)),
                    device=cuda)
    cam = world.cameras[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r.render(rpp=2)
        cam.look_at((0.1, 0.0, 1.0))
        r.render(rpp=1)
        r.image()
    host = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith("rz::") and e.device_type == DeviceType.CPU]
    names = [n for n, _, _ in host]
    for name, n in (("rz::render", 2), ("rz::capture", 1), ("rz::replay", 2),
                    ("rz::wait", 2), ("rz::reproject", 1), ("rz::readback", 1)):
        assert names.count(name) == n, name
    cycles = [(a, b) for n, a, b in host if n == "rz::cycle"]
    for n, a, b in host:
        if n in ("rz::capture", "rz::replay", "rz::wait"):
            assert any(s <= a and b <= e for s, e in cycles), n
    mirrors = [e for e in prof.events()
               if e.name.startswith("rz::") and e.device_type == DeviceType.CUDA]
    assert all(getattr(e, "is_user_annotation", False) for e in mirrors)


# ---------------------------------------------------------------------------
# the shadow backwards and the compiled training step
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["b2", "b4"])
def test_shadow_grad_kernels_match_plain(cuda, kind):
    """B2-grad / B4-grad against cluster_shadow_grad_plain /
    cluster_shadow_inst_grad_plain on 64^2 bounce-like rays with dist =
    BIG, half the materials translucent, random cotangents (every fifth ray
    zero); a zero cotangent gives a zero table; the launch counters count."""
    rng = np.random.default_rng(21)
    world = (rt.scenes.mesh_heavy(8, 8, resolution=40) if kind == "b2"
             else _two_level_world("instanced_field", 8))
    for m in list(world.materials)[::2]:
        m.color = np.asarray([*m.color[:3], 0.5], np.float32)
    scene = tds.compile_world(world, two_level=kind == "b4", device=cuda)
    if kind == "b2":
        o, d = _rays(scene, world, cuda, 64)[1]
        mat = scene.mat_color[scene.tri_mat.long()]
        tabs = (scene.cl_box, scene.cl_lw,
                tc.cluster_opacity(mat[:, :3], 1.0 - mat[:, 3], scene.cl_order,
                                   scene.cl_base, scene.cl_count))
        kernel, plain = tc.cluster_shadow_grad, tc.cluster_shadow_grad_plain
    else:
        cam = tds.compile_camera(world.cameras[0], cuda)
        o, d = cam_ops.generate_rays(cam, cam_ops.pixel_grid(64, 64, device=cuda),
                                     torch.full((4096, 4), 0.5, device=cuda))
        v = rng.normal(size=(4096, 3)).astype(np.float32)
        o, d = (o + d * 2.0).contiguous(), torch.as_tensor(
            v / np.linalg.norm(v, axis=1, keepdims=True), device=cuda)
        tabs = (scene.ti_rows, scene.cl_obox, scene.cl_lw, scene.cl_slot,
                tc.instance_opacity(scene.mat_color, scene.inst_slot_map))
        kernel, plain = tc.cluster_shadow_inst_grad, tc.cluster_shadow_inst_grad_plain
    r = o.shape[0]
    dist = torch.full((r,), 3e38, device=cuda)
    g = torch.as_tensor(rng.normal(size=(r, 4)).astype(np.float32), device=cuda)
    g[::5] = 0.0
    g_rgb, g_a = g[:, :3].contiguous(), g[:, 3].contiguous()
    before = kernel.launches
    got = kernel(o, d, dist, *tabs, g_rgb, g_a)
    ref = plain(o, d, dist, *tabs, g_rgb, g_a)
    zero = kernel(o, d, dist, *tabs, torch.zeros_like(g_rgb), torch.zeros_like(g_a))
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert float(ref.abs().max()) > 0
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= 1e-4, err
    assert float(zero.abs().max()) == 0.0


def _train_setup(name, res, dev):
    from rayzath_tpu_torch.engine.integrator import render_steps
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.ops import rng
    two_level = name == "instanced_field"
    world = (_two_level_world(name, res) if two_level
             else _cycle_world(name, res))
    scene = tds.compile_world(world, two_level=two_level or None,
                              differentiable=two_level, device=dev)
    cam = tds.compile_camera(world.cameras[0], dev)
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=3),
                          two_level=two_level or None)
    dim = scene.mat_color.clone()
    dim[2:, :3] *= 0.8
    import dataclasses
    with torch.no_grad():
        st = render_steps(dataclasses.replace(scene, mat_color=dim), cam, cfg,
                          init_state(res, res, dev), rng.key(5), 4)
    target = st.accum[..., :3] / torch.clamp(st.accum[..., 3:4], min=1.0)
    return scene, cam, cfg, target


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["textured_room", "instanced_field",
                                  "cutout world"])
def test_graph_step_equals_eager_step(cuda, name):
    """training_step on the card (one captured graph per step) against the
    eager step from the same scene, seed and target at 64^2, depth 3, 4
    passes, remat: the loss bit for bit, the parameters within 1e-4 of the
    max |step| (B2-grad's and B4-grad's atomics add in no fixed order);
    later steps replay the same graph. The cutout world's step captures
    the cutout pass's product, whose backward reads nothing on the host
    (``ops/vec.prod``)."""
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.parallel import train
    scene, cam, cfg, target = _train_setup(name, 64, cuda)
    train._STEPS.clear()
    args = (cam, cfg)
    ref, _, ref_loss = train._eager_step(scene, *args, init_state(64, 64, cuda),
                                         7, target, 0.01, 4, remat=True)
    got, st, loss = train.training_step(scene, *args, init_state(64, 64, cuda),
                                        7, target, 0.01, 4, remat=True)
    torch.cuda.synchronize()
    assert torch.equal(loss, ref_loss)
    assert st.pass_idx == 4 and float(st.accum[..., 3].sum()) > 0
    moved = 0.0
    for k in train.DIFF_PARAMS:
        step = float((getattr(ref, k) - getattr(scene, k)).abs().max())
        diff = float((getattr(got, k) - getattr(ref, k)).abs().max())
        assert diff <= 1e-4 * max(step, 1e-30), (k, diff, step)
        moved = max(moved, step)
    assert moved > 0
    step_obj = train._STEPS[torch.device("cuda", torch.cuda.current_device())]
    for seed in (8, 9):
        got, _, loss = train.training_step(got, *args, init_state(64, 64, cuda),
                                           seed, target, 0.01, 4, remat=True)
    torch.cuda.synchronize()
    assert step_obj.captures == 1 and bool(torch.isfinite(loss))
    train._STEPS.clear()


@pytest.mark.gpu
def test_step_replays_count_launches(cuda):
    """Each replayed step adds the captured step's launches to the
    counters, as many as an eager step makes (no remat: one draw and one
    forward per pass): the forward kernels, B2-grad and, in place of the
    by-value draw, the keyed draw."""
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.ops import rng
    from rayzath_tpu_torch.parallel import train
    scene, cam, cfg, target = _train_setup("multi_light", 32, cuda)
    wrappers = (tc.cluster_closest, tc.cluster_shadow, tc.cluster_shadow_grad,
                rng.uniform_rows, rng.uniform_rows_keyed)

    def counts(fn):
        start = [f.launches for f in wrappers]
        fn()
        torch.cuda.synchronize()
        return [f.launches - s for f, s in zip(wrappers, start)]

    def step(fn):
        return lambda: fn(scene, cam, cfg, init_state(32, 32, cuda), 3, target,
                          0.01, 2)

    eager = counts(step(train._eager_step))
    assert eager[0] >= 2 and eager[1] >= 2 and eager[2] == eager[1]
    assert eager[3] == 2 and eager[4] == 0
    train._STEPS.clear()
    step(train.training_step)()                      # capture
    got = counts(lambda: [step(train.training_step)() for _ in range(3)])
    assert got == [3 * eager[0], 3 * eager[1], 3 * eager[2], 0, 3 * 2]
    train._STEPS.clear()


@pytest.mark.gpu
def test_step_that_cannot_be_captured_raises(cuda, monkeypatch):
    """A step that reads a device value on the host (a ``.item()``
    monkeypatched into the projected update) cannot be captured: the call
    raises RuntimeError and returns nothing computed eagerly instead; once
    the read is gone the step captures."""
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.parallel import train
    scene, cam, cfg, target = _train_setup("cornell_box_nee", 32, cuda)
    project = train._project

    def reads_the_device(name, value):
        float(value.max().item())
        return project(name, value)

    train._STEPS.clear()
    monkeypatch.setattr(train, "_project", reads_the_device)
    with pytest.raises(RuntimeError, match="could not be captured"):
        train.training_step(scene, cam, cfg, init_state(32, 32, cuda), 1,
                            target, 0.01, 2)
    monkeypatch.setattr(train, "_project", project)
    _, _, loss = train.training_step(scene, cam, cfg, init_state(32, 32, cuda),
                                     1, target, 0.01, 2)
    assert bool(torch.isfinite(loss))
    assert next(iter(train._STEPS.values())).captures == 1
    train._STEPS.clear()


# ---------------------------------------------------------------------------
# the table gather: G1 and G2 (ops/gather.py)
# ---------------------------------------------------------------------------

def _coherent_idx(rng, r, n, run=64):
    """[r] indices into n rows in runs of ``run`` equal ones (neighbouring
    rays on one material or texel), int32."""
    starts = rng.integers(0, n, size=-(-r // run))
    return np.repeat(starts, run)[:r].astype(np.int32)


#: name -> (table rows n, row shape, index shape, pattern, int64 indices):
#: few distinct indices (262,144 rays over the 8 rows of a [8, 14]
#: material table; all on one row; a 2-row light table), atlas-sized tables
#: ([8192, 4] colour, [12288] scalar) with [R, 4] corner indices in runs of
#: 16, no rays; the main path's widths (1, 3, 4, 14, tri_pack's 32, where
#: G1 and G2 take different branches) and others (5, 8 and 2), row counts
#: that are no multiple of the warp, the 16-byte word, the tile or the
#: block, a one-row table, warps wholly on one row and warps of 32
#: distinct rows, an atlas larger than the fixed-order path's tables at
#: random, and int64 indices on each path
GATHER_CASES = {
    "materials": (8, (14,), (262144,), "mixed", False),
    "one_row": (8, (14,), (262144,), "one", False),
    "light": (2, (), (262144,), "mixed", False),
    "atlas": (8192, (4,), (65536, 4), "runs16", False),
    "scalar_atlas": (12288, (), (65536, 4), "runs16", False),
    "int64": (8, (14,), (262144,), "mixed", True),
    "empty": (8, (14,), (0,), "mixed", False),
    "w1": (3, (), (262144 + 7,), "mixed", False),
    "w3": (4, (3,), (100003,), "mixed", False),
    "w4": (6, (4,), (65536 + 33,), "mixed", False),
    "w14": (6, (14,), (262144 + 17,), "mixed", False),
    "w32": (300, (32,), (50001,), "mixed", False),
    "w5": (7, (5,), (33333,), "mixed", False),
    "w8": (40, (8,), (4097,), "mixed", False),
    "w2": (9, (2,), (31,), "mixed", False),
    "one_ray": (6, (14,), (1,), "mixed", False),
    "n1": (1, (14,), (10007,), "mixed", False),
    "n1_atlas": (1, (4,), (513, 4), "mixed", True),
    "one_row_warps": (6, (4,), (262144 + 5,), "one", False),
    "distinct_warps": (64, (14,), (262144 + 3,), "distinct", False),
    "distinct_atlas": (8192, (4,), (65536 + 9, 4), "distinct", False),
    "random_atlas": (65536, (4,), (262144, 4), "random", False),
    "random_atlas_int64": (65536, (4,), (262144, 4), "random", True),
    "scalar_atlas_int64": (12288, (), (65536 + 1, 4), "random", True),
    "w14_int64": (6, (14,), (262144 + 17,), "mixed", True),
    "w5_int64": (7, (5,), (33333,), "one", True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_kernels_match_plain(cuda, case):
    """G1 bit for bit as gather_rows_plain and G2 to 1e-6 of the max |g| of
    gather_rows_grad_plain (the float64 sum rounded once) on every case of
    GATHER_CASES (indices half in runs of 64, half at random with some out
    of range, to be clamped; in runs of 16; all on one row; each warp's 32
    rays on 32 distinct rows; all at random). A table that fits in shared
    memory gives the same G2 bits twice. The counters count one launch per
    call. G1 on a table whose rows start off the 16-byte grid (a view one
    element in) and on an int32 table (a slot map) is bit for bit too."""
    from rayzath_tpu_torch.ops import _kernels, gather
    n, row, idx_shape, pattern, wide = GATHER_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    r = int(np.prod(idx_shape))
    if pattern == "one":
        idx = np.full(r, n // 2)
    elif pattern == "runs16":
        idx = _coherent_idx(rng, r, n, run=16)
    elif pattern == "distinct":
        idx = (np.arange(r) * 7 + 3) % max(n, 1)
        assert n >= 32
    elif pattern == "random":
        idx = rng.integers(0, n, size=r)
    else:
        idx = np.where(rng.uniform(size=r) < 0.5, _coherent_idx(rng, r, n),
                       rng.integers(-2, n + 2, size=r))
    idx = torch.as_tensor(idx.reshape(idx_shape).astype(
        np.int64 if wide else np.int32), device=cuda)
    table = torch.as_tensor(rng.uniform(-10, 10, size=(n,) + row)
                            .astype(np.float32), device=cuda)
    g = torch.as_tensor(rng.normal(size=idx_shape + row).astype(np.float32),
                        device=cuda)
    before = (gather.gather_rows_fwd.launches, gather.gather_rows_grad.launches)
    got = gather.gather_rows_fwd(table, idx)
    d1 = gather.gather_rows_grad(idx, g, n)
    d2 = gather.gather_rows_grad(idx, g, n)
    torch.cuda.synchronize()
    ran = int(r > 0)
    assert (gather.gather_rows_fwd.launches - before[0],
            gather.gather_rows_grad.launches - before[1]) == (ran, 2 * ran)
    assert torch.equal(got.view(torch.int32),
                       gather.gather_rows_plain(table, idx).view(torch.int32))
    k = int(np.prod(row))
    flat = torch.empty(n * k + 1, dtype=torch.float32, device=cuda)
    off = flat[1:].view((n,) + row)                 # 4 bytes off the grid
    off.copy_(table)
    assert torch.equal(gather.gather_rows_fwd(off, idx).view(torch.int32),
                       got.view(torch.int32))
    d_ref = gather.gather_rows_grad_plain(idx, g, n)
    assert d1.shape == d_ref.shape == (n, k)
    if ran:
        err = float((d1 - d_ref).abs().max() / d_ref.abs().max())
        assert err <= 1e-6, err
    else:
        assert not d1.any()
    if _kernels.load().rz_gather_grad_partials(r, n, k):
        assert torch.equal(d1, d2)
    ints = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31 - 1, size=(320,))
                           .astype(np.int32), device=cuda)
    small = torch.clamp(idx.reshape(-1)[:1000], max=319)
    assert torch.equal(gather.gather_rows_fwd(ints, small),
                       gather.gather_rows_plain(ints, small))


@pytest.mark.gpu
def test_gather_autograd_on_the_card(cuda):
    """gather_rows on a table that needs a gradient: G1 forward, G2
    backward, the same as the plain twins' autograd (the clamped indices
    included); a graph step replays both, counted per replay."""
    from rayzath_tpu_torch.ops import gather
    rng = np.random.default_rng(3)
    table = torch.as_tensor(rng.normal(size=(6, 4)).astype(np.float32),
                            device=cuda).requires_grad_(True)
    idx = torch.as_tensor(rng.integers(-2, 8, size=(5000,)).astype(np.int32),
                          device=cuda)
    g = torch.as_tensor(rng.normal(size=(5000, 4)).astype(np.float32),
                        device=cuda)
    out = gather.gather_rows(table, idx)
    (d,) = torch.autograd.grad(out, table, g)
    t_cpu = table.detach().cpu().requires_grad_(True)
    out_cpu = gather.gather_rows(t_cpu, idx.cpu())
    (d_cpu,) = torch.autograd.grad(out_cpu, t_cpu, g.cpu())
    assert torch.equal(out.detach().cpu(), out_cpu.detach())
    assert float((d.cpu() - d_cpu).abs().max()) <= 1e-6 * float(d_cpu.abs().max())
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.parallel import train
    scene, cam, cfg, target = _train_setup("textured_room", 32, cuda)
    wrappers = (gather.gather_rows_fwd, gather.gather_rows_grad)

    def counts(fn):
        start = [f.launches for f in wrappers]
        fn()
        torch.cuda.synchronize()
        return [f.launches - s for f, s in zip(wrappers, start)]

    def step(fn):
        return lambda: fn(scene, cam, cfg, init_state(32, 32, cuda), 3, target,
                          0.01, 2)

    eager = counts(step(train._eager_step))
    assert eager[0] > 0 and eager[1] > 0
    train._STEPS.clear()
    step(train.training_step)()                      # capture
    assert counts(lambda: [step(train.training_step)() for _ in range(2)]) == [
        2 * eager[0], 2 * eager[1]]
    train._STEPS.clear()


# ---------------------------------------------------------------------------
# the coherence key (ops/sort_rays.py, csrc/sort_keys.cu)
# ---------------------------------------------------------------------------

def _keys_match_plain(o, d):
    """The kernels' keys equal coherence_keys_plain's bit for bit on the
    same card, and sort_payload orders the rays as the stable sort of the
    plain keys does."""
    from rayzath_tpu_torch.ops import sort_rays
    plain = sort_rays.coherence_keys_plain(o, d)
    keys = sort_rays.coherence_keys(o, d)
    assert keys.dtype == torch.int64 and keys.shape == plain.shape
    differ = int((keys != plain).sum())
    assert differ == 0, f"{differ} of {keys.numel()} keys differ"
    o_s, d_s, (ids_s,), idx = sort_rays.sort_payload(
        o, d, (torch.arange(o.shape[0], device=o.device),))
    assert torch.equal(idx, torch.sort(plain, stable=True).indices)
    assert torch.equal(ids_s, idx)
    assert torch.equal(o_s.view(torch.int32), o[idx].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n", [
    *((k, 5_000) for k in CARD_KINDS),
    ("bounce", 1), ("camera", 1), ("bounce", 768), ("bounce", 67_585),
    ("bounce", 921_600), ("two_equal", 1_000_003)])
def test_sort_keys_match_plain(cuda, kind, n):
    """csrc/sort_keys.cu bit for bit as coherence_keys_plain, counted once
    a call: random rays, one shared origin, tie-heavy and zero directions,
    signed zeros, infs and NaNs; ray counts off the block, one ray, one
    block, the bounds launch's widest grid plus a ray and 720p."""
    from rayzath_tpu_torch.ops import sort_rays
    o, d = (torch.as_tensor(x, device=cuda) for x in key_rays(kind, n, seed=n))
    before = sort_rays.coherence_keys.launches
    _keys_match_plain(o, d)
    assert sort_rays.coherence_keys.launches == before + 2   # keys, payload


@pytest.mark.gpu
def test_sort_keys_in_a_graph(cuda):
    """The two launches capture into a CUDA graph: replays give the plain
    keys of whatever the static inputs hold when they run."""
    from rayzath_tpu_torch.ops import sort_rays
    n = 70_001
    o, d = (torch.as_tensor(x, device=cuda) for x in key_rays("bounce", n))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sort_rays.coherence_keys(o, d)                # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        keys = sort_rays.coherence_keys(o, d)
    for kind in ("bounce", "two_equal", "camera"):
        o2, d2 = key_rays(kind, n, seed=5)
        o.copy_(torch.as_tensor(o2))
        d.copy_(torch.as_tensor(d2))
        graph.replay()
        assert torch.equal(keys, sort_rays.coherence_keys_plain(o, d)), kind


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mesh_heavy", "cornell_box_nee"])
def test_sort_keys_in_bounce_steps(cuda, name, monkeypatch):
    """On the o and d of real bounce states (three eager passes at 64^2)
    the kernels give the plain keys; a pass computes one key per sorted
    traversal call (mesh_heavy: 719 clusters) and none where the scene
    has under 16 clusters (cornell_box_nee)."""
    from rayzath_tpu_torch.engine import integrator as I
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.ops import rng, sort_rays
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=8))
    world = rt.scenes.SCENES[name](64, 64)
    scene = tds.compile_world(world, device=cuda)
    cam = tds.compile_camera(world.cameras[0], cuda)
    seen = []
    keys_of, sort_payload = sort_rays.coherence_keys, I.sort_payload

    def checked(o, d, extras):
        assert torch.equal(keys_of(o, d), sort_rays.coherence_keys_plain(o, d))
        seen.append(o.shape[0])
        return sort_payload(o, d, extras)

    monkeypatch.setattr(I, "sort_payload", checked)
    state = init_state(64, 64, cuda)
    traversals = (tc.cluster_closest, tc.cluster_shadow)
    for p in range(3):
        start = ([f.launches for f in traversals], keys_of.launches, len(seen))
        with torch.no_grad():
            state = I.bounce_step(scene, cam, cfg, state,
                                  rng.fold_in(rng.key(6), p))
        walks = sum(f.launches - s for f, s in zip(traversals, start[0]))
        calls = len(seen) - start[2]
        assert walks >= 2
        if name == "mesh_heavy":
            # a checked call computes the key twice: here and in sort_payload
            assert calls == walks and keys_of.launches - start[1] == 2 * calls
        else:
            assert calls == 0 and keys_of.launches == start[1]


def _bounce_world(name, res):
    from rayzath_tpu_torch.utils.check_worlds import cutout_world
    if name == "cutout world":
        return cutout_world(res)
    if name == "instanced_field":
        return rt.scenes.instanced_field(res, res, n=3, resolution=12)
    return rt.scenes.SCENES[name](res, res)


#: the largest share of rays whose next direction, throughput, medium or
#: depth may differ between the bounce kernels and the plain stages on the
#: card: a threshold or a lottery that one rounding flips (measured: none)
BOUNCE_FLIP_SHARE = 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell_box_nee", "multi_light",
                                  "glass_and_fog", "textured_room",
                                  "instanced_field", "cutout world"])
def test_bounce_kernels_match_plain_stages(cuda, name):
    """The same numpy uniforms through bounce_step on the card without
    autograd (the kernels of csrc/bounce.cu) and with it (the plain torch
    stages), 5 bounces at 48^2: from each plain state the head kernel's
    outputs (``integrator._head_kernel``, the wrapper ``bounce_head``)
    equal ``_head``'s bit for bit and the next state's direction,
    throughput, medium and path depth differ on at most
    BOUNCE_FLIP_SHARE of the rays; the two chains' accumulations match by
    ``images_match``."""
    from rayzath_tpu_torch.engine import integrator as I
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.ops import bounce
    res = 48
    world = _bounce_world(name, res)
    scene = tds.compile_world(world, device=cuda)
    cam = tds.compile_camera(world.cameras[0], cuda)
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=6))
    ns = I.n_streams(cfg, scene)
    rng = np.random.default_rng(8)
    plain = fused = init_state(res, res, cuda)
    stages = (bounce.bounce_head, bounce.bounce_surface, bounce.bounce_tail)
    for _ in range(5):
        u = torch.as_tensor(rng.random((res * res, ns), dtype=np.float32),
                            device=cuda)
        hd_p = I._head(scene, cam, plain, u)
        start = [f.launches for f in stages]
        with torch.no_grad():
            hd = I._head_kernel(scene, cam, plain, u)
            step = I.bounce_step(scene, cam, cfg, plain, u=u)
            fused = I.bounce_step(scene, cam, cfg, fused, u=u)
        assert [f.launches - s for f, s in zip(stages, start)] == [3, 2, 2]
        for f in ("near", "far", "far_eff", "scat_dist", "has_scatter", "med"):
            assert torch.equal(getattr(hd, f), getattr(hd_p, f)), f
        start = [f.launches for f in stages]
        nxt = I.bounce_step(scene, cam, cfg, plain, u=u)
        assert [f.launches for f in stages] == start
        for f in ("direction", "throughput", "medium", "path_depth"):
            a, b = getattr(step, f), getattr(nxt, f)
            differ = (a != b).reshape(res * res, -1).any(1).float().mean()
            assert float(differ) <= BOUNCE_FLIP_SHARE, (f, float(differ))
        plain = nxt
    images_match(fused.accum.cpu().numpy(), plain.accum.cpu().numpy())


@pytest.mark.gpu
def test_replays_count_bounce_launches(cuda):
    """A replayed render cycle advances each bounce wrapper's launches by
    one a pass, as one eager no-grad pass does; a pass under autograd runs
    the plain stages and launches none."""
    from rayzath_tpu_torch.engine.integrator import render_steps
    from rayzath_tpu_torch.engine.state import init_state
    from rayzath_tpu_torch.ops import bounce, rng
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=8))
    world = rt.scenes.multi_light(64, 64)
    r = rt.Renderer(world, cfg, seed=2, device=cuda)
    r.render(rpp=1)                                  # capture
    wrappers = (bounce.bounce_head, bounce.bounce_surface, bounce.bounce_tail)
    start = [f.launches for f in wrappers]
    cam = tds.compile_camera(world.cameras[0], cuda)
    with torch.no_grad():
        render_steps(r.scene, cam, cfg, init_state(64, 64, cuda), rng.key(2), 1)
    assert [f.launches - s for f, s in zip(wrappers, start)] == [1, 1, 1]
    start = [f.launches for f in wrappers]
    render_steps(r.scene, cam, cfg, init_state(64, 64, cuda), rng.key(2), 1)
    assert [f.launches for f in wrappers] == start
    r.render(rpp=5)
    assert [f.launches - s for f, s in zip(wrappers, start)] == [5, 5, 5]
    assert r.views[id(world.cameras[0])].cycle.captures == 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cornell_box_nee", "multi_light",
                                  "glass_and_fog", "textured_room",
                                  "instanced_field", "cutout world"])
def test_bounce_surface_culls_as_the_plain_stage(cuda, name):
    """The same numpy uniforms and closest-hit walk, 5 bounces at 48^2:
    the shadow rays that ``bounce_surface_kernel`` hands the walks
    inactive (dist 0) are exactly those ``_surface`` culls, which are
    exactly the kernel's samples of a lane that hit nothing or of a
    radiance of 0."""
    from rayzath_tpu_torch.engine import integrator as I
    from rayzath_tpu_torch.engine.state import init_state
    res = 48
    world = _bounce_world(name, res)
    scene = tds.compile_world(world, device=cuda)
    cam = tds.compile_camera(world.cameras[0], cuda)
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=6))
    ns = I.n_streams(cfg, scene)
    rng = np.random.default_rng(9)
    state = init_state(res, res, cuda)
    culled = 0
    with torch.no_grad():
        for _ in range(5):
            u = torch.as_tensor(rng.random((res * res, ns), dtype=np.float32),
                                device=cuda)
            hd = I._head(scene, cam, state, u)
            walk = I._closest_walk(scene, cfg, state.origin, state.direction,
                                   hd.near, hd.far_eff, hw=(res, res))
            plain = I._surface(scene, cfg, state, u, hd, walk)
            fused = I._surface_kernel(scene, cfg, state, u,
                                      I._head_kernel(scene, cam, state, u),
                                      walk)
            assert len(fused.shadow_dist) == len(plain.shadow_dist) > 0
            for k, (got, want, rad) in enumerate(zip(
                    fused.shadow_dist, plain.shadow_dist, fused.shadow_rad)):
                off = got == 0.0
                assert torch.equal(off, want == 0.0), k
                assert torch.equal(off, ~fused.any_hit | (rad == 0.0)), k
                culled += int(off.sum())
            state = I.bounce_step(scene, cam, cfg, state, u=u)
    assert culled > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["textured_room", "mesh_heavy",
                                  "cutout world", "instanced_field"])
def test_shadow_walks_count_live_rays(cuda, name):
    """B2 (flat on textured_room, grouped on mesh_heavy at resolution 400,
    its cutout variant on the cutout world) and B4 (instanced_field) on a
    bounce's shadow rays as ``bounce_surface_kernel`` writes them: their
    ``work``'s ``live`` gains the rays of dist > 0 on one eager call of
    the shadow walks, and 4 times that over a graph of the call replayed
    3 times after its warm-up, while ``rays`` gains every ray."""
    from rayzath_tpu_torch.engine import cycle
    from rayzath_tpu_torch.engine import integrator as I
    from rayzath_tpu_torch.engine.state import init_state
    res = 64
    world = (rt.scenes.mesh_heavy(res, res, resolution=400)
             if name == "mesh_heavy" else _bounce_world(name, res))
    scene = tds.compile_world(world, device=cuda,
                              two_level=name == "instanced_field" or None)
    cam = tds.compile_camera(world.cameras[0], cuda)
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=6))
    assert scene.two_level == (name == "instanced_field")
    if not scene.two_level:
        assert (scene.cl_box.shape[1] > tc.GROUPED_ROWS) == (
            name == "mesh_heavy")
    ns = I.n_streams(cfg, scene)
    rng = np.random.default_rng(4)
    state = init_state(res, res, cuda)
    with torch.no_grad():
        for _ in range(3):
            u = torch.as_tensor(rng.random((res * res, ns), dtype=np.float32),
                                device=cuda)
            hd = I._head_kernel(scene, cam, state, u)
            walk = I._closest_walk(scene, cfg, state.origin, state.direction,
                                   hd.near, hd.far_eff, hw=(res, res))
            sf = I._surface_kernel(scene, cfg, state, u, hd, walk)
            state = I.bounce_step(scene, cam, cfg, state, u=u)
        if name == "cutout world":
            assert I.shadow_route(scene, cfg, cuda) == "fused"
    f = tc.cluster_shadow_inst if scene.two_level else tc.cluster_shadow
    n = sum(len(dist) for dist in sf.shadow_dist)
    want = sum(int((dist > 0.0).sum()) for dist in sf.shadow_dist)
    assert 0 < want < n

    def walks():
        with torch.no_grad():
            return [I.shadow_test(scene, cfg, sf.shadow_o, d, dist)
                    for d, dist in zip(sf.shadow_d, sf.shadow_dist)]

    start, rays = f.work.read()["live"], f.rays
    walks()
    torch.cuda.synchronize()
    assert (f.work.read()["live"] - start, f.rays - rays) == (want, n)
    start, rays = f.work.read()["live"], f.rays
    graph, per_replay = cycle.capture(walks, walks, "test")
    for _ in range(3):
        graph.replay()
    cycle.advance(per_replay, 3)
    torch.cuda.synchronize()
    assert (f.work.read()["live"] - start, f.rays - rays) == (4 * want, 4 * n)


# ---------------------------------------------------------------------------
# B2's cutout variant: texture-alpha shadows filtered at the walk's hits
# ---------------------------------------------------------------------------

def _canopy(cards, dev):
    world = rt.scenes.leaf_canopy(64, 36, cards=cards)
    return world, tds.compile_world(world, device=dev)


def _b2_cutouts(scene, o, d, dist):
    mat = scene.mat_color[scene.tri_mat.long()]
    return tc.cluster_shadow(o, d, dist, scene.cl_box, scene.cl_lw,
                             scene.cl_order, scene.cl_base, scene.cl_count,
                             mat[:, :3].contiguous(),
                             (1.0 - mat[:, 3]).contiguous(),
                             groups=scene.cl_group,
                             cutouts=tc.Cutouts.of(scene))


@pytest.mark.gpu
@pytest.mark.parametrize("cards", [3000, 65536], ids=["flat", "grouped"])
def test_b2_cutouts_match_plain(cuda, cards):
    """B2's cutout variant on a crown of 3,000 cards (a flat table of 71
    rows) and on the full leaf canopy (1,664 rows: the grouped walk),
    65,536 shadow rays of ``check_worlds.canopy_shadow_rays``: rgba to the
    shadow gate of the plain twin with the same cutouts; its
    ``cutout_fetches`` at most the plain twin's and, over the rays whose
    plain alpha stays above 2e-4 (where the stop never fired), equal to
    it."""
    from rayzath_tpu_torch.utils.check_worlds import canopy_shadow_rays
    world, scene = _canopy(cards, cuda)
    grouped = scene.cl_box.shape[1] > tc.GROUPED_ROWS
    assert grouped == (cards == 65536)
    o, d, dist = canopy_shadow_rays(world, 65536, seed=31, device=cuda)
    cut = tc.Cutouts.of(scene)
    mat = scene.mat_color[scene.tri_mat.long()]
    op_tab = tc.cluster_opacity(mat[:, :3], 1.0 - mat[:, 3], scene.cl_order,
                                scene.cl_base, scene.cl_count)
    *ref, want = tc._shadow_plain(o, d, dist, scene.cl_box, scene.cl_lw,
                                  op_tab, cut)
    start = (tc.cluster_shadow.fetches.read()["cutout_fetches"],
             tc.cluster_shadow.grouped)
    got = _b2_cutouts(scene, o, d, dist)
    torch.cuda.synchronize()
    fetched = tc.cluster_shadow.fetches.read()["cutout_fetches"] - start[0]
    assert tc.cluster_shadow.grouped - start[1] == int(grouped)
    shadow_gate(got, ref)
    assert 0 < fetched <= int(want.sum())
    free = ref[1] >= 2e-4
    o, d, dist = (x[free].contiguous() for x in (o, d, dist))
    start = tc.cluster_shadow.fetches.read()["cutout_fetches"]
    _b2_cutouts(scene, o, d, dist)
    torch.cuda.synchronize()
    assert (tc.cluster_shadow.fetches.read()["cutout_fetches"] - start
            == int(want[free].sum()) > 0)
    assert int((ref[1] < 1e-4).sum()) > 1000


@pytest.mark.gpu
@pytest.mark.parametrize("cards", [3000, 65536], ids=["flat", "grouped"])
def test_b2_cutouts_from_a_card(cuda, cards):
    """B2's cutout variant on 16,384 shadow rays that start on a card
    (``canopy_shadow_rays(..., on_cards=True)``, a bounce off a leaf),
    flat and grouped: a and rgb * a within 1e-4 of the dense route's
    result with the ray's own card (origin moved 3e-5 m back along the
    ray) or without it (moved 3e-5 m on) on all but 1% of the rays and
    within 5e-3 on all but one in 1,000 (``cluster_shadow``'s rule for a
    hit within rounding of t = 0; the bounds and the bracket are derived
    in ``tests/test_torch_cutout_shadow.py``)."""
    from rayzath_tpu_torch.engine import integrator as I
    from rayzath_tpu_torch.utils.check_worlds import canopy_shadow_rays
    world, scene = _canopy(cards, cuda)
    o, d, dist = canopy_shadow_rays(world, 16384, seed=33, device=cuda,
                                    on_cards=True)
    cfg = rt.RenderConfig()

    def dense(o, d, dist):
        base = I._shadow_core(scene, cfg, o, d, dist)
        tex = I.texture_shadow_factor(scene, o, d, dist)
        return base[0] * tex[0], base[1] * tex[1]

    def gap(x, y):
        return torch.maximum((x[1] - y[1]).abs(),
                             (x[0] * x[1][:, None] - y[0] * y[1][:, None])
                             .abs().amax(1))

    with torch.no_grad():
        got = _b2_cutouts(scene, o, d, dist)
        take = dense(o - 3e-5 * d, d, dist + 3e-5)
        leave = dense(o + 3e-5 * d, d, dist - 3e-5)
    g = torch.minimum(gap(got, take), gap(got, leave))
    assert float((g > 1e-4).float().mean()) <= 0.01, float(g.max())
    assert int((g > 5e-3).sum()) <= len(g) // 1000, float(g.max())
    assert float(((take[1] - leave[1]).abs() > 1e-3).float().mean()) >= 0.1


@pytest.mark.gpu
def test_b2_cutouts_keep_the_plain_variant(cuda):
    """Without cutouts B2 launches its variant without the texel factor:
    the shadow gate of the plain version without cutouts, no fetch
    counted; the cutout variant's resources are reported apart."""
    from rayzath_tpu_torch.utils.check_worlds import canopy_shadow_rays
    world, scene = _canopy(3000, cuda)
    o, d, dist = canopy_shadow_rays(world, 8192, seed=32, device=cuda)
    mat = scene.mat_color[scene.tri_mat.long()]
    start = tc.cluster_shadow.fetches.read()["cutout_fetches"]
    got = tc.cluster_shadow(o, d, dist, scene.cl_box, scene.cl_lw,
                            scene.cl_order, scene.cl_base, scene.cl_count,
                            mat[:, :3].contiguous(),
                            (1.0 - mat[:, 3]).contiguous())
    op_tab = tc.cluster_opacity(mat[:, :3], 1.0 - mat[:, 3], scene.cl_order,
                                scene.cl_base, scene.cl_count)
    shadow_gate(got, tc.cluster_shadow_plain(o, d, dist, scene.cl_box,
                                             scene.cl_lw, op_tab))
    assert tc.cluster_shadow.fetches.read()["cutout_fetches"] == start
    rows = scene.cl_box.shape[1]
    for grouped in (False, True):
        res = tc.walk_resources("shadow", rows, grouped, cutout=True)
        assert res["registers"] > 0 and res["blocks_per_sm"] > 0


@pytest.mark.gpu
def test_cutout_render_fused_matches_dense(cuda, monkeypatch):
    """A captured render of the small crown (3,000 cards, 64x36, depth 8,
    4 passes) takes B2's cutout variant and never the dense pass (its
    counter stays, replays included, and fetches are counted); the same
    render with the dense route forced calls the dense pass for each light
    sample of each pass, and the two accumulations match by
    ``images_match``."""
    from rayzath_tpu_torch.engine import integrator as I
    cfg = rt.RenderConfig(tracing=rt.Tracing(max_depth=8))

    def render():
        world = rt.scenes.leaf_canopy(64, 36, cards=3000)
        r = rt.Renderer(world, cfg, seed=5, device=cuda)
        r.render(rpp=4)
        return r.views[id(world.cameras[0])].state.accum.cpu().numpy()

    dense0 = I.texture_shadow_factor.launches
    fetch0 = tc.cluster_shadow.fetches.read()["cutout_fetches"]
    fused = render()
    assert I.texture_shadow_factor.launches == dense0
    assert tc.cluster_shadow.fetches.read()["cutout_fetches"] > fetch0
    real = I.shadow_route
    monkeypatch.setattr(I, "shadow_route",
                        lambda *a: "dense" if real(*a) == "fused" else real(*a))
    dense = render()
    calls = I.texture_shadow_factor.launches - dense0
    assert calls >= 4 * 2 and calls % 2 == 0      # two NEE samples a pass
    images_match(fused, dense)
