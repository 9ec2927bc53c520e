"""Wavefront path-tracing integrator on torch tensors.

Counterpart of ``rayzath_tpu/engine/integrator.py`` for world-space soup
and two-level instanced scenes. The whole wavefront of
R = W*H rays advances ONE bounce per :func:`bounce_step` over SoA buffers;
terminated paths regenerate camera rays in place (reference
cuda_render_kernel.cu:50-65). Behaviour
follows the JAX package line for line: Beer's-law absorption
(cuda_render_kernel.cu:162-176), exponential scattering media
(cuda_material.cuh:141-159), the uber-material BSDF
(cuda_material.cuh:162-301), NEE with MIS power weights for spot + direct
lights (cuda_render_kernel.cu:239-355), sky-sphere environment, texture
maps of all five kinds with normal mapping (cuda_material.cuh:70-123,
cuda_render_parts.cuh:1095-1116) and texture-alpha filtered shadows
(cuda_instance.cuh:92-164).

Two traversal kernels carry each path (ops/traverse_cluster.py). On a soup
scene B1 ``cluster_closest`` answers every bounce's closest-hit query and
B2 ``cluster_shadow`` traces every NEE shadow ray; on a two-level scene B3
``cluster_closest_inst`` and B4 ``cluster_shadow_inst`` do, and the hit's
object-space shading row is moved to world space through the instance's
transforms. As in the JAX package, a soup scene takes the dense test
instead at or below ``brute_force_threshold`` triangles, and the skip-link
BVH walk of ``ops/traverse.py`` (torch ops, no kernel) when the config
asks for ``packet_traversal=False``; a two-level scene keeps B3/B4.

Uniforms: the JAX package's streams bit for bit (``ops/rng.py``). A render
holds a key, ``rng.key(seed)`` as ``jax.random.key(seed)``; each pass folds
its pass index into it, and :func:`pass_uniforms` keys each global image
row by itself, so a band of rows at ``row0`` draws what the same rows of
the whole image draw. On the card one threefry kernel launch draws a pass.
``bounce_step`` takes the pass key from the host, or an ``rng.DeviceKey``
(the render's key words and a device pass counter, folded where the draw
runs: the captured render cycle of ``engine/cycle.py``), or injected
[R, ns] uniforms (``u=``).

Differentiable, as the JAX package is: discrete hit ids from the traversal
kernels carry no gradient, and (t, b1, b2) are re-derived differentiably by
``refine_tri`` on the hit's triangle (path replay); the shadow kernels'
autograd Functions take their gradient with the B2-grad / B4-grad kernels
(ops/traverse_cluster.py); every table gather goes through
``ops/gather.py`` ``gather_rows`` (the G1 gather, its backward the per-row
sum G2) where the JAX package calls its ``gather_rows``; the free-flight
scatter decision carries the JAX package's score-function ratios (forward
value exactly 1).
``Renderer.render`` runs under ``torch.no_grad``, so the serve path records
no graph; ``render_steps(..., remat=True)`` checkpoints each bounce for
training (parallel/train.py).

Texture-alpha cutouts (a material with a colour map and alpha < 1):
:func:`shadow_route` alone chooses how a shadow ray is filtered through
them, as :func:`_stages` chooses the stages. On a card without autograd
(every ``Renderer.render`` pass there) a soup scene's B2 walk fetches the
texel at its own hits (its cutout variant); elsewhere (the CPU, training,
two-level scenes) the dense pass :func:`texture_shadow_factor` multiplies
every cutout triangle's texel into the walk's product.

A bounce's arithmetic is three stages cut at the walks (``_head``,
``_surface``, ``_tail``). :func:`_stages` alone chooses how they run: on a
card without autograd (every ``Renderer.render`` pass there) one
hand-written kernel each (``ops/bounce.py``, ``csrc/bounce.cu``, the plain
stages' values as torch computes them there); on the CPU and under
autograd (training) the plain stages, whose arithmetic is the JAX
package's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.utils.checkpoint

from ..models.device_scene import TorchScene, TorchCamera, WORLD_MATERIAL_ID
from ..ops import bounce as bounce_ops
from ..ops import camera as cam_ops
from ..ops.gather import gather_rows
from ..ops import rng
from ..ops import texture as tex_ops
from ..ops._kernels import counted
from ..ops.intersect import (_project_terms, project_closest, project_shadow,
                             refine_tri)
from ..ops.sort_rays import sort_payload, unsort_payload
from ..ops.traverse import bvh_closest, bvh_shadow
from ..ops.traverse_cluster import (cluster_closest, cluster_shadow,
                                    cluster_closest_inst, cluster_shadow_inst,
                                    Cutouts, SLOTS)
from ..ops.vec import (dot, normalize, lerp, reflect, halfway,
                       cosine_sample_hemisphere, sample_sphere,
                       sample_hemisphere, sample_disk, fresnel_specular_ratio,
                       cross, prod)
from .config import RenderConfig
from .state import RenderState, BIG, PATH_LIMIT


# ---------------------------------------------------------------------------
# material fetch
# ---------------------------------------------------------------------------

NO_MAP = -1


class MatProps(NamedTuple):
    color_rgb: torch.Tensor   # [R,3] color * texture rgb
    alpha_op: torch.Tensor    # [R] (1 - alpha) * (1 - tex alpha): 0 = opaque
    metalness: torch.Tensor   # [R]
    roughness: torch.Tensor   # [R]
    emission: torch.Tensor    # [R]
    ior: torch.Tensor         # [R]
    scattering: torch.Tensor  # [R]
    normal_map: Optional[torch.Tensor]  # [R] i32 map id (-1 none); None
                                        # on a scene without maps


def mat_pack(scene: TorchScene) -> torch.Tensor:
    """[M,14] packed material rows built from the live SoA leaves: color 0:4,
    metalness 4, roughness 5, emission 6, ior 7, scattering 8, maps 9:14."""
    return torch.cat([
        scene.mat_color,
        scene.mat_metalness[:, None], scene.mat_roughness[:, None],
        scene.mat_emission[:, None], scene.mat_ior[:, None],
        scene.mat_scattering[:, None],
        scene.mat_maps.to(torch.float32)], dim=1)


def material_fetch(scene: TorchScene, mp, mat_id, texcrd) -> MatProps:
    """Material properties at a surface point (reference
    Material::color/emission/metalness/roughness with maps,
    cuda_material.cuh:70-123). ``mp`` is :func:`mat_pack`'s table; the
    fetch of a map kind no material references is skipped."""
    row = gather_rows(mp, torch.clamp(mat_id, 0, scene.n_materials - 1))
    rgb, alpha_op = row[:, 0:3], 1.0 - row[:, 3]
    metal, rough, emis = row[:, 4], row[:, 5], row[:, 6]
    normal_map = None
    if scene.has_maps:
        maps = torch.round(row[:, 9:14]).to(torch.int32)
        tex_id, nrm_id, met_id, rgh_id, emi_id = maps.unbind(1)
        normal_map = torch.full_like(nrm_id, NO_MAP)
        used = scene.map_kinds_used
        if used[0]:
            tex = tex_ops.fetch_scene(scene, tex_id, texcrd, atlas=0)
            has_t = tex_id >= 0
            rgb = torch.where(has_t[:, None], rgb * tex[:, :3], rgb)
            alpha_op = torch.where(has_t, alpha_op * (1.0 - tex[:, 3]), alpha_op)
        if used[2]:
            met_v = tex_ops.fetch_scene(scene, met_id, texcrd, atlas=1)[:, 0]
            metal = torch.where(met_id >= 0, met_v, metal)
        if used[3]:
            rgh_v = tex_ops.fetch_scene(scene, rgh_id, texcrd, atlas=1)[:, 0]
            rough = torch.where(rgh_id >= 0, rgh_v, rough)
        if used[4]:
            emi_v = tex_ops.fetch_scene(scene, emi_id, texcrd, atlas=1)[:, 0]
            emis = torch.where(emi_id >= 0, emis * emi_v, emis)
        if used[1]:
            normal_map = nrm_id
    return MatProps(rgb, alpha_op, metal, rough, emis, row[:, 7], row[:, 8],
                    normal_map)


# ---------------------------------------------------------------------------
# ray order for the traversal kernels
# ---------------------------------------------------------------------------

TILE = 32  # image tile side: one 32x32 tile = 8 thread blocks of 128 rays


def _tileable(hw, r: int) -> bool:
    return (hw is not None and hw[0] % TILE == 0 and hw[1] % TILE == 0
            and hw[0] * hw[1] == r)


def _tile(x, hw):
    """Permute row-major rays into 32x32 image tiles (reshape/permute only),
    so a thread block covers a narrow frustum instead of image rows."""
    h, w = hw
    t = TILE
    rest = tuple(x.shape[1:])
    x = x.reshape((h // t, t, w // t, t) + rest)
    x = x.permute((0, 2, 1, 3) + tuple(range(4, 4 + len(rest))))
    return x.reshape((h * w,) + rest).contiguous()


def _untile(x, hw):
    h, w = hw
    t = TILE
    rest = tuple(x.shape[1:])
    x = x.reshape((h // t, w // t, t, t) + rest)
    x = x.permute((0, 2, 1, 3) + tuple(range(4, 4 + len(rest))))
    return x.reshape((h * w,) + rest).contiguous()


def _sort_traversal(cfg: RenderConfig, scene: TorchScene) -> bool:
    """Effective ray-sort decision: ``cfg.ray_sort``, or (None = auto) sort
    when the scene has at least 16 traversal candidates (instances on a
    two-level scene, real clusters on a soup), as in the JAX package.
    Whether sorting pays on the GPU is measured in PERF.md, open question
    3: it halves mesh_massive's pass, takes 8% off instanced_field's (145
    instances) and costs textured_room (21 clusters) about 1%."""
    if cfg.ray_sort is not None:
        return cfg.ray_sort
    n_cand = scene.n_instances if scene.two_level else scene.n_clusters
    return n_cand >= 16


def _run_coherent(cfg: RenderConfig, hw, o, d, extras, run, sort=False):
    """Run a cluster traversal on a coherence-ordered ray order and return
    its per-ray results in the original order. With ``sort``: the coherence
    key sort (ops/sort_rays.py); otherwise 32x32 image tiles when the
    wavefront is a whole tileable image."""
    if sort:
        o_s, d_s, extras_s, idx_s = sort_payload(o, d, extras)
        return unsort_payload(idx_s, run(o_s, d_s, *extras_s))
    if _tileable(hw, o.shape[0]):
        outs = run(_tile(o, hw), _tile(d, hw), *[_tile(e, hw) for e in extras])
        return tuple(_untile(x, hw) for x in outs)
    return run(o.contiguous(), d.contiguous(),
               *[e.contiguous() for e in extras])


def _apply_fwd(fwd_rows, v, translate: bool):
    """Per-ray object->world 3x4 transforms ([R,12] row-major) applied to
    [R,3] vectors (points when ``translate``)."""
    a = fwd_rows
    out = torch.stack([
        a[:, 0] * v[:, 0] + a[:, 1] * v[:, 1] + a[:, 2] * v[:, 2],
        a[:, 4] * v[:, 0] + a[:, 5] * v[:, 1] + a[:, 6] * v[:, 2],
        a[:, 8] * v[:, 0] + a[:, 9] * v[:, 1] + a[:, 10] * v[:, 2]], dim=1)
    if translate:
        out = out + torch.stack([a[:, 3], a[:, 7], a[:, 11]], dim=1)
    return out


def _apply_nrm(nrm_rows, v):
    """Per-ray normal matrices ([R,9] row-major 3x3) applied to [R,3]."""
    a = nrm_rows
    return torch.stack([
        a[:, 0] * v[:, 0] + a[:, 1] * v[:, 1] + a[:, 2] * v[:, 2],
        a[:, 3] * v[:, 0] + a[:, 4] * v[:, 1] + a[:, 5] * v[:, 2],
        a[:, 6] * v[:, 0] + a[:, 7] * v[:, 1] + a[:, 8] * v[:, 2]], dim=1)


def _dense(cfg: RenderConfig, scene: TorchScene) -> bool:
    """A soup scene takes the dense projection test (``ops/intersect.py``)
    when it has at most ``cfg.brute_force_threshold`` triangles or no
    cluster table (an empty world), as in the JAX package."""
    return (scene.n_triangles <= cfg.brute_force_threshold
            or scene.cl_box is None)


def _closest_walk(scene: TorchScene, cfg: RenderConfig, o, d, near, far,
                  hw=None):
    """The closest-hit walk alone: (t, tri_id, inst_id) from B1 or B3 (in
    the ray order of :func:`_run_coherent`), the dense test or the
    skip-link walk; ``inst_id`` is None on the soup path. Discrete: it
    records no gradient."""
    sort = _sort_traversal(cfg, scene)
    o_k, d_k = o.detach(), d.detach()
    near, far = near.detach(), far.detach()
    if scene.two_level:
        return _run_coherent(
            cfg, hw, o_k, d_k, (near, far),
            lambda o, d, near, far: cluster_closest_inst(
                o, d, near, far, scene.ti_rows, scene.cl_obox, scene.cl_lw),
            sort=sort)
    if _dense(cfg, scene):
        t, tid = project_closest(o_k, d_k, near, far, scene.tri_pw,
                                 scene.tri_pc,
                                 chunk=min(cfg.chunk, scene.tri_v0.shape[0]))
    elif cfg.packet_traversal:
        t, tid = _run_coherent(
            cfg, hw, o_k, d_k, (near, far),
            lambda o, d, near, far: cluster_closest(
                o, d, near, far, scene.cl_box, scene.cl_lw, scene.cl_order,
                groups=scene.cl_group),
            sort=sort)
    else:
        t, tid = bvh_closest(o_k, d_k, near, far, scene.aabb_links,
                             scene.node_count, scene.leaf_tri,
                             scene.tri_v0, scene.tri_e1, scene.tri_e2)
    return t, tid, None


def _hit_row(scene: TorchScene, o, d, t, tid, inst):
    """The walk's hit made shadable: (t, b1, b2, external, tp), with
    (t, b1, b2) re-derived by ``refine_tri`` on the hit's packed attribute
    row ``tp`` ([R,32], see TorchScene.tri_pack), moved to world space on a
    two-level scene. A miss keeps the walk's ``t`` and gets b1 = b2 = 0."""
    tp = gather_rows(scene.tri_pack, torch.clamp(tid, min=0))
    if scene.two_level:
        # object -> world (the reference moves the ray instead,
        # cuda_instance.cuh:186-229: the same hit, shaded in world space);
        # normals through the inverse-transpose rows
        ii = torch.clamp(inst, min=0)
        fwd = gather_rows(scene.inst_fwd, ii)
        nrm = gather_rows(scene.inst_nrm, ii)
        parts = [_apply_fwd(fwd, tp[:, 0:3], True),
                 _apply_fwd(fwd, tp[:, 3:6], False),
                 _apply_fwd(fwd, tp[:, 6:9], False)]
        for base in (9, 12, 15):
            n_w = _apply_nrm(nrm, tp[:, base:base + 3])
            parts.append(n_w / torch.clamp(
                torch.linalg.norm(n_w, dim=1, keepdim=True), min=1e-20))
        tp = torch.cat(parts + [tp[:, 18:]], dim=1)
    t_r, b1_r, b2_r, det = refine_tri(o, d, tp[:, 0:3], tp[:, 3:6], tp[:, 6:9])
    ext = det > 0.0
    hit_mask = tid >= 0
    zero = torch.zeros((), dtype=torch.float32, device=o.device)
    t = torch.where(hit_mask, t_r, t)
    b1 = torch.where(hit_mask, b1_r, zero)
    b2 = torch.where(hit_mask, b2_r, zero)
    return t, b1, b2, ext, tp


def closest_hit(scene: TorchScene, cfg: RenderConfig, o, d, near, far,
                hw=None):
    """Returns (t, tri_id, inst_id, b1, b2, external, tp): the traversal
    kernel's hit id (:func:`_closest_walk`) and (t, b1, b2) re-derived by
    ``refine_tri`` on the hit's packed attribute row ``tp`` ([R,32], see
    TorchScene.tri_pack, in world space in both modes; :func:`_hit_row`).
    ``inst_id`` is None on the soup path (the instance is
    ``tri_inst[tri_id]`` there). Ids, the miss ``t`` and ``external`` carry
    no gradient; a hit's (t, b1, b2) do."""
    t, tid, inst = _closest_walk(scene, cfg, o, d, near, far, hw)
    t, b1, b2, ext, tp = _hit_row(scene, o, d, t, tid, inst)
    return t, tid, inst, b1, b2, ext, tp


@counted()
def texture_shadow_factor(scene: TorchScene, o, d, dist, chunk: int = 512):
    """Texture part of the transmission-filtered shadow mask (the JAX
    package's ``texture_shadow_factor``).

    The reference fetches the material's texture at every shadow-ray hit
    (cuda_instance.cuh:92-164; per-hit factor (rgb * tex_rgb,
    (1 - alpha) * (1 - tex_alpha)), cuda_material.cuh:86-95). The product
    factorizes: the traversal kernels multiply the constant material part
    over all hits, and this dense pass over the cutout set (fixed at scene
    compile) multiplies in (tex_rgb, 1 - tex_alpha) at each hit's
    interpolated texcrd. |dz| < 1e-7 is nudged, as in ``ops/intersect.py``;
    the last chunk is ragged where the JAX package pads it with never-hit
    frames (the same products). Unlike B2/B4 this pass has no alpha < 1e-4
    stop (ROADMAP C). Differentiable: gradients reach the color atlas.
    Taken where :func:`shadow_route` says "dense"; ``launches`` counts its
    calls (``ops/_kernels.py`` ``COUNTED``, so a replayed graph counts
    them too)."""
    texture_shadow_factor.launches += 1
    c_total = scene.cut_pw.shape[1] // 3
    pw = scene.cut_pw.reshape(3, 3, c_total)
    pc = scene.cut_pc.reshape(3, c_total)
    r = o.shape[0]
    rgb = torch.ones((r, 3), dtype=torch.float32, device=o.device)
    a = torch.ones(r, dtype=torch.float32, device=o.device)
    for i0 in range(0, c_total, chunk):
        sl = slice(i0, min(i0 + chunk, c_total))
        c = sl.stop - i0
        t, b1, b2, _ = _project_terms(o, d, pw[:, :, sl].reshape(3, 3 * c),
                                      pc[:, sl].reshape(3 * c))
        valid = ((b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
                 & (t > 0.0) & (t < dist[:, None]))          # [R, c]
        t0, t1, t2 = (x[sl] for x in (scene.cut_t0, scene.cut_t1, scene.cut_t2))
        uv = (t0[None] + b1[..., None] * (t1 - t0)[None]
              + b2[..., None] * (t2 - t0)[None])             # [R, c, 2]
        mid = scene.cut_map[sl][None].expand(r, c)
        tex = tex_ops.fetch_scene(scene, mid.reshape(-1), uv.reshape(-1, 2),
                                  atlas=0).reshape(r, c, 4)
        rgb = rgb * prod(torch.where(valid[..., None], tex[..., :3], 1.0), 1)
        a = a * prod(torch.where(valid, 1.0 - tex[..., 3], 1.0), 1)
    return rgb, a


def shadow_route(scene: TorchScene, cfg: RenderConfig, device) -> str:
    """How :func:`shadow_test` filters shadow rays on ``device`` through the
    scene's texture-alpha cutouts: "none" (no cutout set); "fused", B2's
    cutout variant fetching each hit's texel inside the walk, for a soup
    scene walked by B2 on a CUDA device with autograd off (every
    ``Renderer.render`` pass there); else "dense", the walk's product times
    :func:`texture_shadow_factor`: the CPU, training (the dense pass carries
    the atlas's gradient, B2-grad knows no texel factor), two-level scenes
    (B4), and the dense and skip-link routes. Every soup scene with
    cutouts and a cluster table holds the per-slot tables
    (``compile_world``, ``scene_from_arrays``)."""
    if not scene.n_cutout:
        return "none"
    fused = (torch.device(device).type == "cuda"
             and not torch.is_grad_enabled() and not scene.two_level
             and cfg.packet_traversal and not _dense(cfg, scene))
    return "fused" if fused else "dense"


def shadow_test(scene: TorchScene, cfg: RenderConfig, o, d, dist, hw=None):
    """Transmission-filtered visibility (reference World::anyIntersection):
    the B2 (soup) or B4 (two-level) kernel's product of constant material
    opacity over every hit, resolved from the live material table, and the
    texel factors of the hits on cutouts, inside B2 or by
    :func:`texture_shadow_factor` (:func:`shadow_route`)."""
    route = shadow_route(scene, cfg, o.device)
    if route == "dense":
        base_rgb, base_a = _shadow_core(scene, cfg, o, d, dist, hw)
        tex_rgb, tex_a = texture_shadow_factor(scene, o, d, dist)
        return base_rgb * tex_rgb, base_a * tex_a
    return _shadow_core(scene, cfg, o, d, dist, hw,
                        Cutouts.of(scene) if route == "fused" else None)


def _shadow_core(scene: TorchScene, cfg: RenderConfig, o, d, dist, hw=None,
                 cutouts=None):
    tris = (scene.tri_v0, scene.tri_e1, scene.tri_e2)
    if scene.two_level:
        expanded = (None if scene.exp_tri is None else
                    (scene.tri_slot, scene.exp_tri, scene.exp_inst,
                     scene.inst_fwd))
        return _run_coherent(
            cfg, hw, o, d, (dist,),
            lambda o, d, dist: cluster_shadow_inst(
                o, d, dist, scene.ti_rows, scene.cl_obox, scene.cl_lw,
                scene.cl_slot, scene.inst_slot_map, scene.mat_color,
                tris=tris, expanded=expanded),
            sort=_sort_traversal(cfg, scene))
    mat = gather_rows(scene.mat_color, scene.tri_mat)
    op_rgb = mat[:, :3]
    op_a = 1.0 - mat[:, 3]
    if _dense(cfg, scene):
        return project_shadow(o, d, dist, scene.tri_pw, scene.tri_pc, op_rgb,
                              op_a, chunk=min(cfg.chunk, scene.tri_v0.shape[0]))
    if cfg.packet_traversal:
        return _run_coherent(
            cfg, hw, o, d, (dist,),
            lambda o, d, dist: cluster_shadow(
                o, d, dist, scene.cl_box, scene.cl_lw, scene.cl_order,
                scene.cl_base, scene.cl_count, op_rgb, op_a, tris=tris,
                groups=scene.cl_group, cutouts=cutouts),
            sort=_sort_traversal(cfg, scene))
    return bvh_shadow(o, d, dist, scene.aabb_links, scene.node_count,
                      scene.leaf_tri, *tris, op_rgb, op_a)


# ---------------------------------------------------------------------------
# BSDF (reference cuda_material.cuh:162-301)
# ---------------------------------------------------------------------------

def brdf_eval(d_in, mapped_normal, surface_scattering, roughness, alpha_op,
              reflectance, vpl):
    """The reference BRDF (cuda_material.cuh:162-182). ``vpl`` must be unit."""
    is_scatter = surface_scattering > 0.0
    n_dot_o = dot(mapped_normal, vpl)
    n_dot_i = dot(mapped_normal, -d_in)
    vh = halfway(d_in, vpl)
    # clipped: both vectors are unit only to rounding, and |n_dot_h| > 1
    # would let b cross zero for roughness 0 (mirrors) and ndf become inf
    n_dot_h = torch.clamp(dot(mapped_normal, vh), -1.0, 1.0)
    b = n_dot_h * n_dot_h * (roughness - 1.0) + 1.0001
    ndf = (roughness + 1e-5) / (b * b)

    def att(c):
        c = torch.clamp(c, min=0.0)
        return c / (c * (1.0 - roughness) + roughness + 1e-7)

    attenuation = att(n_dot_i) * att(n_dot_o)
    diffuse = n_dot_o * (alpha_op == 0.0).to(n_dot_o.dtype)
    specular = ndf * attenuation / torch.clamp(n_dot_i * n_dot_o, min=1e-7)
    val = lerp(diffuse, specular * n_dot_o, reflectance)
    val = torch.where((n_dot_o <= 0.0) | (n_dot_i <= 0.0),
                      torch.zeros_like(val), val)
    return torch.where(is_scatter, torch.ones_like(val), val)


def sample_direction(d_in, normal, mapped_normal, mat: MatProps,
                     surf_scattering, fresnel, reflectance, refr_ratio, refr_b,
                     u_r1, u_r2, u_lottery):
    """Importance-sample the next direction (reference
    Material::sampleDirection, cuda_material.cuh:203-301).
    Returns (next_dir, tint_factor, refracted)."""
    def flip_above(v, n):
        c = dot(n, v)[:, None]
        return torch.where(c < 0.0, v - 2.0 * c * n, v)

    # 1) scattering medium event or transmissive surface in a scattering material
    scatter_dir = sample_sphere(u_r1, u_r2, d_in)

    # 2) transmission (refract or fresnel-reflect)
    refr_dir = d_in * refr_ratio[:, None] + mapped_normal * refr_b[:, None]
    refl_m = flip_above(reflect(d_in, mapped_normal), normal)
    take_refr = fresnel < u_lottery
    trans_dir = torch.where(take_refr[:, None], refr_dir, refl_m)
    trans_tint = torch.where(take_refr, torch.ones_like(mat.metalness),
                             mat.metalness)

    # 3) diffuse
    diff_dir = flip_above(cosine_sample_hemisphere(u_r1, u_r2, mapped_normal),
                          normal)

    # 4) glossy
    vh = sample_hemisphere(u_r1, 1.0 - torch.pow(u_r2 + 1e-5, mat.roughness),
                           mapped_normal)
    gloss_dir = flip_above(reflect(d_in, vh), normal)

    is_trans = mat.alpha_op > 0.0
    is_scat = is_trans & (surf_scattering > 0.0)
    is_diffuse = ~is_trans & (u_lottery > reflectance)

    next_dir = torch.where(is_scat[:, None], scatter_dir,
                torch.where(is_trans[:, None], trans_dir,
                 torch.where(is_diffuse[:, None], diff_dir, gloss_dir)))
    one = torch.ones_like(mat.metalness)
    tint = torch.where(is_scat, mat.metalness,
            torch.where(is_trans, trans_tint,
             torch.where(is_diffuse, one, mat.metalness)))
    refracted = is_trans & ~is_scat & take_refr
    return normalize(next_dir), tint, refracted


# ---------------------------------------------------------------------------
# next-event estimation (reference cuda_render_kernel.cu:239-355)
# ---------------------------------------------------------------------------

def _where0(cond, x):
    return torch.where(cond, torch.zeros_like(x), x)


def _spot_sample(scene, point, next_dir, d_in, mapped_normal, surf_scattering,
                 roughness, alpha_op, reflectance, brdf_color, vs_pdf,
                 medium_scattering, us):
    """One spot-light sample (uniforms ``us`` [R,3]): its shadow ray's
    direction and distance from ``point``, and its unshadowed weight as
    (lcol * brdf_color [R,3], MIS-weighted radiance [R]); :func:`_tail`
    adds ``weight * (radiance * v_a) * v_rgb`` under the ray's
    visibility."""
    n_lights = scene.n_spot_lights
    li = torch.clamp((us[:, 0] * n_lights).to(torch.int32), max=n_lights - 1)
    lpos = gather_rows(scene.spot_pos, li)
    ldir = gather_rows(scene.spot_dir, li)
    lcol = gather_rows(scene.spot_color, li)
    lsize = gather_rows(scene.spot_size, li)
    lemit = gather_rows(scene.spot_emission, li)
    lcos = gather_rows(scene.spot_cos_angle, li)

    # sampleDirection (cuda_spot_light.cuh:56-80)
    v_pl0 = lpos - point
    d_pl0 = torch.sqrt(torch.clamp(dot(v_pl0, v_pl0), min=1e-20))
    vop_dot = dot(v_pl0, next_dir)
    d_pq = torch.sqrt(torch.clamp(d_pl0 * d_pl0 - vop_dot * vop_dot,
                                  min=1e-20))
    would_hit = (d_pq < lsize) & (vop_dot > 0.0)
    d_oq = torch.sqrt(torch.clamp(d_pl0 * d_pl0 - d_pq * d_pq, min=1e-20))
    vpl_hit = next_dir * torch.clamp(d_oq, min=1e-4)[:, None]
    vpl_disk = sample_disk(us[:, 1], us[:, 2], v_pl0 / d_pl0[:, None],
                           lsize) + v_pl0
    vpl = torch.where(would_hit[:, None], vpl_hit, vpl_disk)
    se = torch.where(would_hit, lemit, torch.zeros_like(lemit))

    d_pl = torch.sqrt(torch.clamp(dot(vpl, vpl), min=1e-20))
    vpl_n = vpl / d_pl[:, None]
    brdf = brdf_eval(d_in, mapped_normal, surf_scattering, roughness,
                     alpha_op, reflectance, vpl_n)
    solid_angle = (lsize * lsize * torch.pi) / ((d_pl + 1.0) * (d_pl + 1.0))
    sctr = torch.exp(-d_pl * medium_scattering)
    beam = (lcos < dot(-vpl_n, ldir)).to(torch.float32)

    l_pdf = 1.0 / torch.clamp(solid_angle, min=1e-20)
    vsw = vs_pdf / (vs_pdf + l_pdf)
    lw = 1.0 - vsw
    le = lemit * solid_angle * brdf
    radiance = (le * lw + se * vsw) * sctr * beam
    radiance = _where0(radiance < 1e-4, radiance)
    radiance = _where0(brdf < 1e-4, radiance)
    return vpl_n, d_pl, lcol * brdf_color, radiance


def _direct_sample(scene, next_dir, d_in, mapped_normal, surf_scattering,
                   roughness, alpha_op, reflectance, brdf_color, vs_pdf, us):
    """One direct-light sample, as :func:`_spot_sample` (its shadow ray
    runs to BIG)."""
    n_lights = scene.n_direct_lights
    li = torch.clamp((us[:, 0] * n_lights).to(torch.int32), max=n_lights - 1)
    ldir = gather_rows(scene.dir_dir, li)
    lcol = gather_rows(scene.dir_color, li)
    lemit = gather_rows(scene.dir_emission, li)
    lcos = gather_rows(scene.dir_cos, li)

    # sampleDirection (cuda_direct_light.cuh:50-67)
    would_hit = dot(next_dir, -ldir) > lcos
    cone = sample_sphere(us[:, 1], us[:, 2] * 0.5 * (1.0 - lcos), -ldir)
    vpl = torch.where(would_hit[:, None], next_dir, cone)
    se = torch.where(would_hit, lemit, torch.zeros_like(lemit))

    vpl_n = normalize(vpl)
    brdf = brdf_eval(d_in, mapped_normal, surf_scattering, roughness,
                     alpha_op, reflectance, vpl_n)
    solid_angle = 2.0 * torch.pi * (1.0 - lcos)
    l_pdf = 1.0 / torch.clamp(solid_angle, min=1e-20)
    vsw = vs_pdf / (vs_pdf + l_pdf)
    lw = 1.0 - vsw
    le = lemit * solid_angle * brdf
    radiance = le * lw + se * vsw
    radiance = _where0(radiance < 1e-4, radiance)
    return vpl_n, torch.full_like(se, BIG), lcol * brdf_color, radiance


def _live_dist(dist, any_hit, radiance):
    """A light sample's shadow distance, or 0 where the sample weighs
    exactly zero whatever its visibility: a lane that hit nothing
    (:func:`_tail` drops its NEE) or a radiance of exactly 0 (a NaN stays
    traced). Every walk takes a ray of dist 0 as inactive, with visibility
    (1, 1, 1, 1) and no test, and :func:`_tail`'s product with the
    radiance is the same +0 as with the walked visibility."""
    return torch.where(any_hit & (radiance != 0.0), dist,
                       torch.zeros_like(dist))


# ---------------------------------------------------------------------------
# one wavefront bounce: _head, the closest-hit walk, _surface, the shadow
# walks, _tail
# ---------------------------------------------------------------------------

def n_streams(cfg: RenderConfig, scene: TorchScene) -> int:
    ns = 8
    if scene.n_spot_lights:
        ns += 3 * cfg.light_sampling.spot_light
    if scene.n_direct_lights:
        ns += 3 * cfg.light_sampling.direct_light
    return ns


def light_samples(cfg: RenderConfig, scene: TorchScene):
    """((lights, samples) of the spot lights, (lights, samples) of the
    direct lights): a kind without lights draws no sample."""
    ls = cfg.light_sampling
    return ((scene.n_spot_lights,
             ls.spot_light if scene.n_spot_lights else 0),
            (scene.n_direct_lights,
             ls.direct_light if scene.n_direct_lights else 0))


def pass_uniforms(key, row0: int, height: int, width: int, ns: int,
                  device) -> torch.Tensor:
    """Uniform streams for image rows [row0, row0 + height) at one pass
    (the JAX package's ``pass_uniforms``): row y draws
    ``uniform(fold_in(key, y), (width, ns))``, so the streams depend on
    (key, global row) only. ``key`` is the pass key (``rng.Key``) or an
    ``rng.DeviceKey`` whose pass key is folded on the device. Returns
    [height * width, ns] float32 on ``device``, drawn by the threefry
    kernel on a card."""
    if isinstance(key, rng.DeviceKey):
        return rng.uniform_rows_keyed(key, row0, height, width, ns, device)
    return rng.uniform_rows(key, row0, height, width, ns, device)


def host_reads(cfg: RenderConfig, scene: TorchScene) -> bool:
    """Whether a pass reads device values on the host: the skip-link walk
    (``packet_traversal=False`` on a soup scene with a cluster table) reads
    its active ray count every ``CHECK_EVERY`` steps, so its pass cannot be
    captured into a CUDA graph."""
    return not (cfg.packet_traversal or scene.two_level or _dense(cfg, scene))


class Head(NamedTuple):
    """What :func:`_head` hands the closest-hit walk and :func:`_surface`."""
    near: torch.Tensor         # [R] the walk's near
    far: torch.Tensor          # [R] far (camera segments refreshed)
    far_eff: torch.Tensor      # [R] the walk's far: far or the free flight
    scat_dist: torch.Tensor    # [R] sampled free-flight distance
    has_scatter: torch.Tensor  # [R] bool: the medium scatters
    med: torch.Tensor          # [R] i32 the medium's material row
    mp: torch.Tensor           # [M,14] :func:`mat_pack`'s table
    med_row: Optional[torch.Tensor]  # [R,14] the medium's row; None fused


class Surface(NamedTuple):
    """What :func:`_surface` hands the shadow walks and :func:`_tail`."""
    t_final: torch.Tensor      # [R] segment length
    any_hit: torch.Tensor      # [R] bool: a surface or a scatter event
    point: torch.Tensor        # [R,3] hit point with its nudge
    next_dir: torch.Tensor     # [R,3]
    throughput: torch.Tensor   # [R,3] after Beer's law
    throughput_next: torch.Tensor  # [R,3] tinted
    contrib: torch.Tensor      # [R,3] emissive contribution
    metallic_tint: Optional[torch.Tensor]  # [R,3]; None without lights
    new_medium: torch.Tensor   # [R] i32
    new_depth: torch.Tensor    # [R] i32
    score: torch.Tensor        # [R]
    shadow_o: Optional[torch.Tensor]  # [R,3] origin of every shadow ray
    shadow_d: tuple            # per light sample: [R,3] direction
    shadow_dist: tuple         # per light sample: [R] distance; 0 culled
    shadow_w: tuple            # per light sample: [R,3] lcol * brdf_color
    shadow_rad: tuple          # per light sample: [R] radiance


def _head(scene: TorchScene, cam: TorchCamera, state: RenderState,
          u) -> Head:
    """Before the closest-hit walk: the segment's clip range and the
    medium's free flight."""
    depth0 = state.path_depth
    # camera segments refresh their clip range (cuda_render_kernel.cu:95)
    near = torch.where(depth0 == 0, cam.near_far[0], state.near)
    far = torch.where(depth0 == 0, cam.near_far[1], state.far)
    mp = mat_pack(scene)
    med = torch.clamp(state.medium, 0, scene.n_materials - 1)
    med_row = gather_rows(mp, med)
    med_scatter = med_row[:, 8]
    # --- volumetric free flight (cuda_material.cuh:141-159) ---
    # the sampled distance uses a detached sigma: the event's dependence on
    # sigma goes through the score-function ratio of _surface instead
    sigma = torch.clamp(med_scatter, min=1e-20)
    scat_dist = -torch.log(u[:, 0] + 1e-4) / sigma.detach()
    has_scatter = med_scatter > 1e-4
    far_eff = torch.where(has_scatter, torch.minimum(far, scat_dist), far)
    return Head(near, far, far_eff, scat_dist, has_scatter, med, mp, med_row)


def _surface(scene: TorchScene, cfg: RenderConfig, state: RenderState, u,
             hd: Head, walk) -> Surface:
    """From the closest-hit walk (``walk``: :func:`_closest_walk`'s
    (t, tri_id, inst_id), its hit re-derived by :func:`_hit_row` first, as
    :func:`closest_hit` does) to the shadow rays: the surface frame, the
    material with its maps, normal mapping, Beer's law, the emission, the
    next direction, the hit point and each light sample's shadow ray and
    unshadowed weight, the ray inactive (dist 0) where that weight is
    exactly zero (:func:`_live_dist`)."""
    o, d = state.origin, state.direction
    t, tri_id, inst_id = walk
    t, b1, b2, external, tp = _hit_row(scene, o, d, t, tri_id, inst_id)
    dev = o.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    depth0 = state.path_depth
    mp, med, med_row = hd.mp, hd.med, hd.med_row
    med_color = med_row[:, 0:4]
    med_ior = med_row[:, 7]
    med_scatter = med_row[:, 8]
    sigma = torch.clamp(med_scatter, min=1e-20)
    has_scatter, scat_dist, far_eff = hd.has_scatter, hd.scat_dist, hd.far_eff

    hit_obj = tri_id >= 0
    scatter_evt = has_scatter & ~hit_obj & (scat_dist < hd.far)
    any_hit = hit_obj | scatter_evt
    t_final = torch.where(hit_obj, t, torch.where(scatter_evt, scat_dist, far_eff))

    # --- scatter-event score-function surrogate: the event decision is a
    # discrete function of sigma that the pathwise gradient cannot see, so
    # the throughput carries p_sigma(outcome) / detach(p_sigma(outcome))
    # (value exactly 1; scatter pdf sigma exp(-sigma s), survival
    # exp(-sigma t)); the sample-count channel carries the path's
    # cumulative ratio (_tail), since a path's termination pass shifts with
    # the same decisions. Without autograd both are the constant 1, which
    # multiplies exactly, so serving skips them ---
    t_sg = t_final.detach()
    logp = torch.where(scatter_evt, torch.log(sigma) - sigma * t_sg,
                       torch.where(has_scatter, -sigma * t_sg, zero))
    score = state.score + logp
    event_ratio = one
    if torch.is_grad_enabled():
        event_ratio = torch.exp(logp - logp.detach())

    e1, e2 = tp[:, 3:6], tp[:, 6:9]
    n0_w, n1_w, n2_w = tp[:, 9:12], tp[:, 12:15], tp[:, 15:18]
    if scene.two_level:
        # material through the instance's slot table (reference
        # Instance::analyzeIntersection, cuda_instance.cuh:231-264)
        slot = torch.round(tp[:, 24]).to(torch.int32)
        flat = torch.clamp(inst_id, min=0) * SLOTS + slot
        tri_mat_hit = gather_rows(scene.inst_slot_map.reshape(-1), flat)
    else:
        tri_mat_hit = torch.round(tp[:, 24]).to(torch.int32)

    world_id = torch.full_like(tri_mat_hit, WORLD_MATERIAL_ID)
    surf_mat = torch.where(hit_obj, tri_mat_hit,
                           torch.where(scatter_evt, med, world_id))
    behind_mat = torch.where(hit_obj & external, surf_mat,
                             torch.where(scatter_evt, med, world_id))

    # --- surface frame ---
    b0 = 1.0 - b1 - b2
    tt0, tt1, tt2 = tp[:, 18:20], tp[:, 20:22], tp[:, 22:24]
    texcrd = None                  # read only by the map fetches
    if scene.has_maps:
        texcrd_hit = tt0 * b0[:, None] + tt1 * b1[:, None] + tt2 * b2[:, None]
        texcrd = torch.where(hit_obj[:, None], texcrd_hit,
                             torch.where(scatter_evt[:, None], zero,
                                         cam_ops.sky_texcrd(d)))
    ext_f = torch.where(external, one, -one)[:, None]
    flat_n = normalize(cross(e1, e2)) * ext_f
    vtx_n = normalize(n0_w * b0[:, None] + n1_w * b1[:, None]
                      + n2_w * b2[:, None])

    mat = material_fetch(scene, mp, surf_mat, texcrd)

    # normal mapping (reference Triangle::mapNormal,
    # cuda_render_parts.cuh:1095-1116), the uv determinant floored at 1e-12
    mapped = vtx_n
    if scene.has_maps:
        nm_rgb = tex_ops.fetch_scene(scene, mat.normal_map, texcrd, atlas=0)[:, :3]
        duv1 = tt1 - tt0
        duv2 = tt2 - tt0
        det_uv = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
        f = 1.0 / torch.where(det_uv.abs() < 1e-12,
                              torch.full_like(det_uv, 1e-12), det_uv)
        tangent = normalize((e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * f[:, None])
        tangent = normalize(tangent - mapped * dot(tangent, mapped)[:, None])
        bitangent = cross(tangent, mapped)
        mn = nm_rgb * 2.0 - 1.0
        perturbed = normalize(mapped * mn[:, 2:3] + tangent * mn[:, 0:1]
                              + bitangent * mn[:, 1:2])
        mapped = torch.where((mat.normal_map >= 0)[:, None], perturbed, mapped)
    mapped = mapped * ext_f

    normal = torch.where(hit_obj[:, None], flat_n, d)
    mapped_normal = torch.where(hit_obj[:, None], mapped, d)

    # --- Beer's law (cuda_render_kernel.cu:162-176), base floored at 1e-6 ---
    med_alpha_op = 1.0 - med_color[:, 3]
    throughput = (state.throughput * med_color[:, :3]
                  * (event_ratio * torch.pow(torch.clamp(med_alpha_op, min=1e-6),
                                             t_final))[:, None])

    # --- emissive contribution ---
    contrib = torch.where((mat.emission > 0.0)[:, None],
                          throughput * mat.color_rgb * mat.emission[:, None],
                          zero)

    new_depth = torch.where(any_hit, depth0 + 1,
                            torch.full_like(depth0, PATH_LIMIT))

    # --- fresnel / reflectance ---
    behind = torch.clamp(behind_mat, 0, scene.n_materials - 1)
    n2 = gather_rows(mp, behind)[:, 7]
    fresnel, refr_ratio, refr_b = fresnel_specular_ratio(mapped_normal, d,
                                                         med_ior, n2)
    reflectance = lerp(fresnel, 1.0, mat.metalness)

    surf_scattering = mat.scattering
    next_dir, tint, refracted = sample_direction(
        d, normal, mapped_normal, mat, surf_scattering, fresnel, reflectance,
        refr_ratio, refr_b, u[:, 1], u[:, 2], u[:, 3])

    # hit point with normal nudge (cuda_render_kernel.cu:214-216); the
    # nudge normal flips when refracting (cuda_material.cuh:272)
    nudge_n = torch.where(refracted[:, None], -normal, normal)
    point = o + d * t_final[:, None] + nudge_n * (1e-4 * t_final)[:, None]

    # --- NEE (only for surviving surface interactions); masked lanes get
    # a safe origin so the light math stays finite ---
    point_nee = metallic_tint = None
    shadows = []
    (_, n_spot), (_, n_direct) = light_samples(cfg, scene)
    if scene.n_spot_lights or scene.n_direct_lights:
        point_nee = torch.where(any_hit[:, None], point, zero)
        vs_pdf = brdf_eval(d, mapped_normal, surf_scattering, mat.roughness,
                           mat.alpha_op, reflectance, next_dir)
        brdf_color = lerp(mat.color_rgb, torch.ones_like(mat.color_rgb),
                          reflectance[:, None])
        off = 8
        for s in range(n_spot):
            shadows.append(_spot_sample(
                scene, point_nee, next_dir, d, mapped_normal, surf_scattering,
                mat.roughness, mat.alpha_op, reflectance, brdf_color, vs_pdf,
                med_scatter, u[:, off + 3 * s:off + 3 * s + 3]))
        off += 3 * n_spot
        for s in range(n_direct):
            shadows.append(_direct_sample(
                scene, next_dir, d, mapped_normal, surf_scattering,
                mat.roughness, mat.alpha_op, reflectance, brdf_color, vs_pdf,
                u[:, off + 3 * s:off + 3 * s + 3]))
        metallic_tint = lerp(torch.ones_like(mat.color_rgb), mat.color_rgb,
                             mat.metalness[:, None])

    # --- throughput tint (cuda_render_kernel.cu:235) ---
    throughput_next = lerp(throughput, throughput * mat.color_rgb, tint[:, None])
    new_medium = torch.where(refracted, behind_mat, med)
    shadows = [(vpl_n, _live_dist(dist, any_hit, rad), w, rad)
               for vpl_n, dist, w, rad in shadows]
    per_sample = tuple(zip(*shadows)) if shadows else ((), (), (), ())
    return Surface(t_final, any_hit, point, next_dir, throughput,
                   throughput_next, contrib, metallic_tint, new_medium,
                   new_depth, score, point_nee, *per_sample)


def _shadows(scene: TorchScene, cfg: RenderConfig, sf: Surface, hw):
    """The shadow walks: each light sample's visibility (v_rgb, v_a)."""
    return tuple(shadow_test(scene, cfg, sf.shadow_o, d, dist, hw=hw)
                 for d, dist in zip(sf.shadow_d, sf.shadow_dist))


def _tail(scene: TorchScene, cam: TorchCamera, cfg: RenderConfig,
          state: RenderState, u, sf: Surface, vis, row0: int) -> RenderState:
    """After the shadow walks: each light sample's weight under its
    visibility (``vis``: (v_rgb, v_a) per sample), the accumulation, the
    depth and space buffers, and the next state, with terminated paths
    regenerated through the camera."""
    H, W = state.height, state.width
    dev = state.accum.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    o, d = state.origin, state.direction
    depth0 = state.path_depth
    contrib = sf.contrib
    if sf.shadow_o is not None:
        direct = torch.zeros_like(sf.point)
        k = 0
        for n_lights, n_samples in light_samples(cfg, scene):
            if not n_lights:
                continue
            total = torch.zeros_like(sf.point)
            for _ in range(n_samples):
                v_rgb, v_a = vis[k]
                total = total + (sf.shadow_w[k]
                                 * (sf.shadow_rad[k] * v_a)[:, None] * v_rgb)
                k += 1
            direct = direct + total / (n_samples / float(n_lights))
        contrib = contrib + torch.where(
            sf.any_hit[:, None], direct * sf.throughput * sf.metallic_tint,
            zero)

    count_ratio = one
    if torch.is_grad_enabled():
        count_ratio = torch.exp(sf.score - sf.score.detach())

    # --- accumulate (fresh tensors: the input state stays valid) ---
    terminated = ~(sf.new_depth < cfg.tracing.max_depth)
    accum = state.accum + torch.cat(
        [contrib.reshape(H, W, 3),
         torch.where(terminated, count_ratio, zero).reshape(H, W, 1)], dim=2)

    # depth/space buffers on camera segments (renderFirstPass,
    # cuda_render_kernel.cu:39-43)
    t_final = sf.t_final
    cam_seg = (depth0 == 0).reshape(H, W)
    depth_buf = torch.where(cam_seg, t_final.reshape(H, W), state.depth_buf)
    space_buf = torch.where(cam_seg[..., None],
                            (o + d * t_final[:, None]).reshape(H, W, 3),
                            state.space_buf)

    # --- continue or regenerate (cuda_render_kernel.cu:107-120) ---
    pix = cam_ops.pixel_grid(W, H, row0, device=dev)
    cam_o, cam_d = cam_ops.generate_rays(cam, pix, u[:, 4:8])

    tm = terminated[:, None]
    return state.replace(
        accum=accum, depth_buf=depth_buf, space_buf=space_buf,
        origin=torch.where(tm, cam_o, sf.point),
        direction=torch.where(tm, cam_d, sf.next_dir),
        throughput=torch.where(tm, one, sf.throughput_next),
        medium=torch.where(terminated,
                           torch.full_like(sf.new_medium, WORLD_MATERIAL_ID),
                           sf.new_medium),
        path_depth=torch.where(terminated, torch.zeros_like(sf.new_depth),
                               sf.new_depth),
        near=torch.where(terminated, cam.near_far[0], zero),
        far=torch.where(terminated, cam.near_far[1],
                        torch.full_like(t_final, BIG)),
        score=torch.where(terminated, zero, sf.score),
        pass_idx=state.pass_idx + 1)


def _head_kernel(scene: TorchScene, cam: TorchCamera, state: RenderState,
                 u) -> Head:
    """:func:`_head` in one kernel launch (``ops/bounce.py``; no
    ``med_row``)."""
    mp = mat_pack(scene)
    return Head(*bounce_ops.bounce_head(scene, cam, state, u, mp), mp, None)


def _surface_kernel(scene: TorchScene, cfg: RenderConfig, state: RenderState,
                    u, hd: Head, walk) -> Surface:
    """:func:`_surface` in one kernel launch (``ops/bounce.py``)."""
    return Surface(*bounce_ops.bounce_surface(scene, state, u, hd, walk,
                                              light_samples(cfg, scene)))


def _tail_kernel(scene: TorchScene, cam: TorchCamera, cfg: RenderConfig,
                 state: RenderState, u, sf: Surface, vis,
                 row0: int) -> RenderState:
    """:func:`_tail` in one kernel launch (``ops/bounce.py``)."""
    out = bounce_ops.bounce_tail(scene, cam, state, u, sf, vis,
                                 light_samples(cfg, scene),
                                 cfg.tracing.max_depth, row0)
    return state.replace(**out, pass_idx=state.pass_idx + 1)


def _stages(state: RenderState):
    """The bounce's (head, surface, tail): the kernel stages where the
    state is on a CUDA device and autograd does not record (every
    ``Renderer.render`` pass on a card, captured or eager), else the plain
    stages (the CPU; training, captured or eager)."""
    if state.accum.device.type == "cuda" and not torch.is_grad_enabled():
        return _head_kernel, _surface_kernel, _tail_kernel
    return _head, _surface, _tail


def bounce_step(scene: TorchScene, cam: TorchCamera, cfg: RenderConfig,
                state: RenderState, key=None, u=None,
                row0: int = 0) -> RenderState:
    """Advance every pixel's path by one bounce (reference
    renderCumulativePass, cuda_render_kernel.cu:67-121).

    ``key``: this pass's key, an ``rng.Key`` (:func:`render_steps` folds
    the pass index into the render's key on the host) or an
    ``rng.DeviceKey`` (the render's key words and a device pass counter,
    folded where the draw runs); the pass draws :func:`pass_uniforms` from
    it. ``u``: injected [R, ns] uniforms (ns = :func:`n_streams`) in place
    of the draw. ``row0``: global image row of this wavefront's first
    row.

    The arithmetic runs in three stages cut at the walks: head before the
    closest-hit walk, surface between it and the shadow walks, tail after
    them, as :func:`_stages` chooses them (the plain :func:`_head`,
    :func:`_surface`, :func:`_tail` or one kernel each)."""
    H, W = state.height, state.width
    if u is None:
        if key is None:
            raise ValueError("bounce_step needs a pass key or uniforms u")
        u = pass_uniforms(key, row0, H, W, n_streams(cfg, scene),
                          state.accum.device)
    head, surface, tail = _stages(state)
    hd = head(scene, cam, state, u)
    walk = _closest_walk(scene, cfg, state.origin, state.direction, hd.near,
                         hd.far_eff, hw=(H, W))
    sf = surface(scene, cfg, state, u, hd, walk)
    return tail(scene, cam, cfg, state, u, sf,
                _shadows(scene, cfg, sf, (H, W)), row0)


# ---------------------------------------------------------------------------
# multi-bounce render step
# ---------------------------------------------------------------------------

def render_steps(scene: TorchScene, cam: TorchCamera, cfg: RenderConfig,
                 state: RenderState, key, n_steps: int,
                 row0: int = 0, remat: bool = False, u=None) -> RenderState:
    """Run ``n_steps`` cumulative bounce passes (the analog of the reference
    render cycle, cuda_engine_renderer.cu:125-186). Never mutates ``state``.
    Each pass runs under ``rng.fold_in(key, state.pass_idx)``, as the JAX
    package's ``_render_steps_impl`` does; ``key`` is ``rng.key(seed)``, or
    an ``rng.DeviceKey`` whose counter holds ``state.pass_idx`` on the
    device (the captured training step of ``parallel/train.py``: each
    pass's key is then folded where the draw runs, from the counter plus
    the pass's offset).

    ``remat``: one ``torch.utils.checkpoint`` per bounce, so a backward
    keeps only each bounce's input state and recomputes its graph. That is
    exact: a pass's uniforms depend only on (key, pass index, row) or are
    injected, and the kernels are deterministic. ``u``: optional sequence of
    ``n_steps`` injected [R, ns] uniform tensors (see :func:`bounce_step`)."""
    for i in range(n_steps):
        ui = None if u is None else u[i]
        k = (rng.DeviceKey(key.words, key.pass_idx + i)
             if isinstance(key, rng.DeviceKey)
             else rng.fold_in(key, state.pass_idx))
        if remat and torch.is_grad_enabled():
            # the pass draws no torch random numbers, so there is no RNG
            # state to restore (and a captured step could not read it)
            state = torch.utils.checkpoint.checkpoint(
                bounce_step, scene, cam, cfg, state, k, ui, row0,
                use_reentrant=False, preserve_rng_state=False)
        else:
            state = bounce_step(scene, cam, cfg, state, k, u=ui, row0=row0)
    return state


#: The JAX package donates the input state of ``render_steps`` and keeps a
#: non-donating twin. The port's ``render_steps`` never mutates its input,
#: so both names are the same function; the donated, compiled counterpart
#: is the render cycle of ``engine/cycle.py``, which ``Renderer.render``
#: runs.
render_steps_preserve = render_steps


@torch.no_grad()
def ray_cast(scene: TorchScene, cam: TorchCamera, cfg: RenderConfig,
             state: RenderState, pixel_x: int, pixel_y: int):
    """Object picking (reference rayCast kernel, cuda_render_kernel.cu:130-144):
    re-trace the pixel's primary ray in a depth window around the stored
    depth. Returns (instance_idx, material_idx) as ints (-1 = none)."""
    dev = state.depth_buf.device
    px = torch.tensor([[float(pixel_x), float(pixel_y)]], dtype=torch.float32,
                      device=dev)
    o, d = cam_ops.simple_ray(cam, px)
    depth = state.depth_buf[pixel_y, pixel_x]
    near = (depth * 0.99).reshape(1)
    far = (depth * 1.01).reshape(1)
    _, tid, inst_id, _, _, _, _ = closest_hit(scene, cfg, o, d, near, far)
    tri = int(tid[0])
    if tri < 0:
        return -1, -1
    if scene.two_level:
        inst = int(inst_id[0])
        return inst, int(scene.inst_slot_map[inst, scene.tri_slot[tri]])
    return int(scene.tri_inst[tri]), int(scene.tri_mat[tri])
