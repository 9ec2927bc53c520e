"""The bounce's elementwise layer as three hand-written CUDA kernels.

``engine/integrator.py`` ``bounce_step`` runs its arithmetic in three
stages cut at the traversal walks: ``_head`` before the closest-hit walk,
``_surface`` between it and the shadow walks, ``_tail`` after them. These
wrappers run one stage each: the plain torch stage for tensors on the CPU,
and for tensors on a CUDA device one launch of ``csrc/bounce.cu``
(``bounce_head_kernel``, ``bounce_surface_kernel``, ``bounce_tail_kernel``),
counted in a ``launches`` attribute; any other device raises (after the
kernel library's load, which raises without a card or nvcc), and there is
no fallback. ``bounce_step`` takes them whenever autograd does not record
(every ``Renderer.render`` pass, captured or eager); training records
autograd and runs the plain stages.

The kernels compute the plain stages' values as torch computes them on the
card, op for op (``csrc/bounce.cu``'s header says where the two may part:
a threshold or a lottery that one rounding flips). They read the scene's
tables in place (the material, triangle, instance, map, atlas and light
tables), so a stage's gathers are part of its one launch.

Each wrapper hands its outputs in the plain stage's form (``Head``,
``Surface``, ``RenderState``), so stages of the two kinds can be compared
one by one.
"""
from __future__ import annotations

import ctypes

import torch

from . import _kernels
from ._kernels import launch as _launch
from .traverse_cluster import SLOTS

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


def _integrator():
    from ..engine import integrator  # the integrator imports this module
    return integrator


def _args(ptrs, ints):
    """The ctypes arrays of the entries' (pointers, integers): a tensor
    gives its data pointer, None a null pointer."""
    p = (ctypes.c_void_p * len(ptrs))(
        *[None if x is None else x.data_ptr() for x in ptrs])
    v = (ctypes.c_longlong * len(ints))(*[int(i) for i in ints])
    return p, len(ptrs), v, len(ints)


def _check(dev, name, x, dtype, shape=None):
    """``x`` on ``dev`` with ``dtype`` and (where given) ``shape``; returns
    it contiguous."""
    if x.device != dev or x.dtype != dtype or (
            shape is not None and tuple(x.shape) != tuple(shape)):
        raise ValueError(f"{name} must be {tuple(shape) if shape else ''} "
                         f"{dtype} on {dev}, got {tuple(x.shape)} {x.dtype} "
                         f"on {x.device}")
    return x.contiguous()


def _device(state):
    dev = state.accum.device
    if dev.type != "cuda":
        raise ValueError(f"the bounce kernels run on a CUDA device, got {dev}")
    return dev


def _uniforms(dev, u, r):
    if u.dim() != 2 or u.shape[0] != r:
        raise ValueError(f"u must be [{r}, ns], got {tuple(u.shape)}")
    return _check(dev, "u", u, _F32)


def bounce_head(scene, cam, state, u):
    """``integrator._head``: the closest-hit walk's near and far, the
    medium's free flight. Returns an ``integrator.Head`` (``med_row`` None
    on a card)."""
    I = _integrator()
    if state.accum.device.type == "cpu":
        return I._head(scene, cam, state, u)
    lib = _kernels.load()
    dev = _device(state)
    r = state.height * state.width
    u = _uniforms(dev, u, r)
    mp = I.mat_pack(scene)
    out = torch.empty((4, r), dtype=_F32, device=dev)
    has_scatter = torch.empty(r, dtype=_BOOL, device=dev)
    med = torch.empty(r, dtype=_I32, device=dev)
    if r:
        ptrs = [_check(dev, "path_depth", state.path_depth, _I32, (r,)),
                _check(dev, "near", state.near, _F32, (r,)),
                _check(dev, "far", state.far, _F32, (r,)),
                _check(dev, "medium", state.medium, _I32, (r,)),
                u, mp.contiguous(),
                _check(dev, "near_far", cam.near_far, _F32, (2,)),
                out, has_scatter, med]
        _launch("bounce_head", lib.rz_bounce_head, dev,
                *_args(ptrs, [r, u.shape[1], mp.shape[0], scene.n_materials]))
        bounce_head.launches += 1
    return I.Head(out[0], out[1], out[2], out[3], has_scatter, med, mp, None)


bounce_head.launches = 0


def bounce_surface(scene, cfg, state, u, hd, walk):
    """``integrator._surface`` from the closest-hit walk's (t, tri_id,
    inst_id) (the CPU re-derives the hit with ``integrator._hit_row``
    first, as ``closest_hit`` does). Returns an ``integrator.Surface``."""
    I = _integrator()
    o, d = state.origin, state.direction
    if o.device.type == "cpu":
        t, tid, inst = walk
        hit = I._hit_row(scene, o, d, t, tid, inst)
        return I._surface(scene, cfg, state, u, hd,
                          (hit[0], tid, inst) + tuple(hit[1:]))
    lib = _kernels.load()
    dev = _device(state)
    r = state.height * state.width
    u = _uniforms(dev, u, r)
    _, tid, inst = walk
    tid = _check(dev, "tri_id", tid.to(_I32), _I32, (r,))
    if scene.two_level:
        inst = _check(dev, "inst_id", inst.to(_I32), _I32, (r,))
    (n_spot, spot_s), (n_dir, dir_s) = I.light_samples(cfg, scene)
    nee = bool(scene.n_spot_lights or scene.n_direct_lights)
    s = spot_s + dir_s

    def f32(*shape):
        return torch.empty(shape, dtype=_F32, device=dev)

    t_final, point, next_dir = f32(r), f32(r, 3), f32(r, 3)
    thr, thr_next, contrib, score = f32(r, 3), f32(r, 3), f32(r, 3), f32(r)
    metallic_tint = f32(r, 3) if nee else None
    any_hit = torch.empty(r, dtype=_BOOL, device=dev)
    new_medium = torch.empty(r, dtype=_I32, device=dev)
    new_depth = torch.empty(r, dtype=_I32, device=dev)
    shadow_o = f32(r, 3) if nee else None
    sh_d, sh_dist, sh_w, sh_rad = f32(s, r, 3), f32(s, r), f32(s, r, 3), f32(s, r)
    if r:
        mp = hd.mp.contiguous()
        ca, sa = scene.color_atlas, scene.scalar_atlas
        tables = [mp, scene.tri_pack, scene.inst_fwd, scene.inst_nrm,
                  scene.inst_slot_map, ca, sa, scene.col_blk_idx,
                  scene.sc_blk_idx, scene.map_rect, scene.map_flags,
                  scene.map_uv, scene.spot_pos, scene.spot_dir,
                  scene.spot_color, scene.spot_size, scene.spot_emission,
                  scene.spot_cos_angle, scene.dir_dir, scene.dir_color,
                  scene.dir_emission, scene.dir_cos]
        if any(x.device != dev for x in tables):
            raise ValueError(f"the scene's tables must be on {dev}")
        ptrs = [_check(dev, "origin", o, _F32, (r, 3)),
                _check(dev, "direction", d, _F32, (r, 3)),
                _check(dev, "throughput", state.throughput, _F32, (r, 3)),
                _check(dev, "score", state.score, _F32, (r,)),
                _check(dev, "path_depth", state.path_depth, _I32, (r,)),
                u,
                _check(dev, "far", hd.far, _F32, (r,)),
                _check(dev, "far_eff", hd.far_eff, _F32, (r,)),
                _check(dev, "scat_dist", hd.scat_dist, _F32, (r,)),
                _check(dev, "has_scatter", hd.has_scatter, _BOOL, (r,)),
                _check(dev, "med", hd.med, _I32, (r,)),
                tid, inst if scene.two_level else None,
                *[x.contiguous() for x in tables],
                t_final, point, next_dir, thr, thr_next, contrib,
                metallic_tint, score, any_hit, new_medium, new_depth,
                shadow_o, sh_d, sh_dist, sh_w, sh_rad]
        used = sum(1 << k for k, on in enumerate(scene.map_kinds_used) if on)
        ints = [r, u.shape[1], mp.shape[0], scene.n_materials,
                scene.tri_pack.shape[0], scene.inst_fwd.shape[0], SLOTS,
                int(scene.two_level), int(scene.has_maps), int(nee), used,
                scene.map_uv.shape[0], ca.shape[1], ca.shape[0] * ca.shape[1],
                sa.shape[1], sa.shape[0] * sa.shape[1],
                n_spot, spot_s, n_dir, dir_s]
        _launch("bounce_surface", lib.rz_bounce_surface, dev,
                *_args(ptrs, ints))
        bounce_surface.launches += 1
    return I.Surface(t_final, any_hit, point, next_dir, thr, thr_next,
                     contrib, metallic_tint, new_medium, new_depth, score,
                     shadow_o, tuple(sh_d), tuple(sh_dist), tuple(sh_w),
                     tuple(sh_rad))


bounce_surface.launches = 0


def _stacked(parts, dev, r, width):
    """The per-sample tensors as one contiguous [S, r(, width)] tensor: the
    buffer they are views of where they are its rows in order (as the
    surface kernel's outputs are), else a stacked copy."""
    shape = (r,) if width is None else (r, width)
    parts = [_check(dev, "a light sample's tensor", x, _F32, shape)
             for x in parts]
    if not parts:
        return None
    base = parts[0]
    n = base.numel()
    storage = base.untyped_storage().data_ptr()
    if all(x.untyped_storage().data_ptr() == storage
           and x.data_ptr() == base.data_ptr() + k * n * 4
           for k, x in enumerate(parts)):
        return torch.as_strided(base, (len(parts),) + shape,
                                (n,) + tuple(base.stride()))
    return torch.stack(parts)


def bounce_tail(scene, cam, cfg, state, u, sf, vis, row0: int = 0):
    """``integrator._tail``: the light samples under their visibility
    ``vis`` ((v_rgb, v_a) per sample), the accumulation, the depth and
    space buffers and the next state. Returns the next ``RenderState``
    (fresh tensors: ``state`` stays valid)."""
    I = _integrator()
    if state.accum.device.type == "cpu":
        return I._tail(scene, cam, cfg, state, u, sf, vis, row0)
    lib = _kernels.load()
    dev = _device(state)
    h, w = state.height, state.width
    r = h * w
    u = _uniforms(dev, u, r)
    (n_spot, spot_s), (n_dir, dir_s) = I.light_samples(cfg, scene)
    nee = bool(scene.n_spot_lights or scene.n_direct_lights)
    if len(vis) != spot_s + dir_s or len(sf.shadow_w) != len(vis):
        raise ValueError(f"{len(vis)} visibilities and {len(sf.shadow_w)} "
                         f"light samples for {spot_s + dir_s}")

    def f32(*shape):
        return torch.empty(shape, dtype=_F32, device=dev)

    out = dict(accum=f32(h, w, 4), depth_buf=f32(h, w),
               space_buf=f32(h, w, 3), origin=f32(r, 3), direction=f32(r, 3),
               throughput=f32(r, 3),
               medium=torch.empty(r, dtype=_I32, device=dev),
               path_depth=torch.empty(r, dtype=_I32, device=dev),
               near=f32(r), far=f32(r), score=f32(r))
    if r:
        vec = (r, 3)
        ptrs = [_check(dev, "accum", state.accum, _F32, (h, w, 4)),
                _check(dev, "depth_buf", state.depth_buf, _F32, (h, w)),
                _check(dev, "space_buf", state.space_buf, _F32, (h, w, 3)),
                _check(dev, "origin", state.origin, _F32, vec),
                _check(dev, "direction", state.direction, _F32, vec),
                _check(dev, "path_depth", state.path_depth, _I32, (r,)),
                u,
                _check(dev, "t_final", sf.t_final, _F32, (r,)),
                _check(dev, "point", sf.point, _F32, vec),
                _check(dev, "next_dir", sf.next_dir, _F32, vec),
                _check(dev, "throughput", sf.throughput, _F32, vec),
                _check(dev, "throughput_next", sf.throughput_next, _F32, vec),
                _check(dev, "contrib", sf.contrib, _F32, vec),
                (_check(dev, "metallic_tint", sf.metallic_tint, _F32, vec)
                 if nee else None),
                _check(dev, "score", sf.score, _F32, (r,)),
                _check(dev, "any_hit", sf.any_hit, _BOOL, (r,)),
                _check(dev, "new_medium", sf.new_medium, _I32, (r,)),
                _check(dev, "new_depth", sf.new_depth, _I32, (r,)),
                _stacked(sf.shadow_w, dev, r, 3),
                _stacked(sf.shadow_rad, dev, r, None),
                _stacked([v[0] for v in vis], dev, r, 3),
                _stacked([v[1] for v in vis], dev, r, None),
                *[_check(dev, "the camera", x, _F32) for x in (
                    cam.position, cam.rot, cam.fov, cam.near_far,
                    cam.focal_distance, cam.aperture)],
                *out.values()]
        ints = [r, u.shape[1], w, row0, cfg.tracing.max_depth, cam.width,
                cam.height, int(nee), n_spot, spot_s, n_dir, dir_s]
        _launch("bounce_tail", lib.rz_bounce_tail, dev, *_args(ptrs, ints))
        bounce_tail.launches += 1
    return state.replace(**out, pass_idx=state.pass_idx + 1)


bounce_tail.launches = 0
