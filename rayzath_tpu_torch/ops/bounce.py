"""The bounce's elementwise layer as three hand-written CUDA kernels.

``engine/integrator.py`` ``bounce_step`` runs its arithmetic in three
stages cut at the traversal walks: ``_head`` before the closest-hit walk,
``_surface`` between it and the shadow walks, ``_tail`` after them. Each
wrapper here runs one stage as one launch of ``csrc/bounce.cu``
(``bounce_head_kernel``, ``bounce_surface_kernel``, ``bounce_tail_kernel``)
on tensors on a CUDA device, counted in a ``launches`` attribute. There is
no CPU route: the kernel library's load raises without a card or nvcc, and
tensors on another device than a card raise ``ValueError``. The
integrator chooses between these kernels and its plain stages
(``integrator._stages``): the kernels where the state is on a card and
autograd does not record (every ``Renderer.render`` pass there, captured
or eager), the plain stages on the CPU and in training.

The kernels compute the plain stages' values as torch computes them on the
card, op for op (``csrc/bounce.cu``'s header says where the two may part:
a threshold or a lottery that one rounding flips). They read the scene's
tables in place (the material, triangle, instance, map, atlas and light
tables), so a stage's gathers are part of its one launch.

What the integrator computes for them comes in as arguments (``mat_pack``'s
table, the light samples), and each wrapper hands back tensors, in the
order of the plain stage's ``Head`` or ``Surface`` fields or by the
``RenderState`` field they replace, which the integrator assembles.
"""
from __future__ import annotations

import ctypes

import torch

from . import _kernels
from ._kernels import counted, launch as _launch
from .traverse_cluster import SLOTS

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


def _args(ptrs, ints):
    """The ctypes arrays of the entries' (pointers, integers): a tensor
    gives its data pointer, None a null pointer."""
    p = (ctypes.c_void_p * len(ptrs))(
        *[None if x is None else x.data_ptr() for x in ptrs])
    v = (ctypes.c_longlong * len(ints))(*[int(i) for i in ints])
    return p, len(ptrs), v, len(ints)


def _arg(dev, name, x, dtype, shape=None):
    """``x`` contiguous (a copy where it is not), checked by
    ``_kernels.check``."""
    x = x.contiguous()
    _kernels.check(dev, name, x, dtype, shape)
    return x


def _uniforms(dev, u, r):
    if u.dim() != 2 or u.shape[0] != r:
        raise ValueError(f"u must be [{r}, ns], got {tuple(u.shape)}")
    return _arg(dev, "u", u, _F32)


@counted()
def bounce_head(scene, cam, state, u, mp):
    """``integrator._head`` on ``mp``, ``integrator.mat_pack``'s table:
    the closest-hit walk's near and far, the medium's free flight. Returns
    (near, far, far_eff, scat_dist, has_scatter, med)."""
    lib = _kernels.load()
    dev = _kernels.card(state.accum.device)
    r = state.height * state.width
    u = _uniforms(dev, u, r)
    out = torch.empty((4, r), dtype=_F32, device=dev)
    has_scatter = torch.empty(r, dtype=_BOOL, device=dev)
    med = torch.empty(r, dtype=_I32, device=dev)
    if r:
        ptrs = [_arg(dev, "path_depth", state.path_depth, _I32, (r,)),
                _arg(dev, "near", state.near, _F32, (r,)),
                _arg(dev, "far", state.far, _F32, (r,)),
                _arg(dev, "medium", state.medium, _I32, (r,)),
                u, _arg(dev, "mp", mp, _F32),
                _arg(dev, "near_far", cam.near_far, _F32, (2,)),
                out, has_scatter, med]
        _launch(bounce_head, lib.rz_bounce_head, dev,
                *_args(ptrs, [r, u.shape[1], mp.shape[0], scene.n_materials]))
    return out[0], out[1], out[2], out[3], has_scatter, med


@counted()
def bounce_surface(scene, state, u, hd, walk, lights):
    """``integrator._surface`` from the closest-hit walk's (t, tri_id,
    inst_id), with ``hd`` the head's ``integrator.Head`` and ``lights``
    ``integrator.light_samples``' ((spot lights, samples), (direct lights,
    samples)). Returns the ``integrator.Surface`` fields in order."""
    lib = _kernels.load()
    dev = _kernels.card(state.accum.device)
    o, d = state.origin, state.direction
    r = state.height * state.width
    u = _uniforms(dev, u, r)
    _, tid, inst = walk
    tid = _arg(dev, "tri_id", tid.to(_I32), _I32, (r,))
    if scene.two_level:
        inst = _arg(dev, "inst_id", inst.to(_I32), _I32, (r,))
    (n_spot, spot_s), (n_dir, dir_s) = lights
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
        mp = _arg(dev, "mp", hd.mp, _F32)
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
        ptrs = [_arg(dev, "origin", o, _F32, (r, 3)),
                _arg(dev, "direction", d, _F32, (r, 3)),
                _arg(dev, "throughput", state.throughput, _F32, (r, 3)),
                _arg(dev, "score", state.score, _F32, (r,)),
                _arg(dev, "path_depth", state.path_depth, _I32, (r,)),
                u,
                _arg(dev, "far", hd.far, _F32, (r,)),
                _arg(dev, "far_eff", hd.far_eff, _F32, (r,)),
                _arg(dev, "scat_dist", hd.scat_dist, _F32, (r,)),
                _arg(dev, "has_scatter", hd.has_scatter, _BOOL, (r,)),
                _arg(dev, "med", hd.med, _I32, (r,)),
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
        _launch(bounce_surface, lib.rz_bounce_surface, dev,
                *_args(ptrs, ints))
    return (t_final, any_hit, point, next_dir, thr, thr_next, contrib,
            metallic_tint, new_medium, new_depth, score, shadow_o,
            tuple(sh_d), tuple(sh_dist), tuple(sh_w), tuple(sh_rad))


def _stacked(parts, dev, r, width):
    """The per-sample tensors as one contiguous [S, r(, width)] tensor: the
    buffer they are views of where they are its rows in order (as the
    surface kernel's outputs are), else a stacked copy."""
    shape = (r,) if width is None else (r, width)
    parts = [_arg(dev, "a light sample's tensor", x, _F32, shape)
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


@counted()
def bounce_tail(scene, cam, state, u, sf, vis, lights, max_depth: int,
                row0: int = 0):
    """``integrator._tail``: the light samples (``lights`` as for
    :func:`bounce_surface`) under their visibility ``vis`` ((v_rgb, v_a)
    per sample), the accumulation, the depth and space buffers and the
    next state, with ``sf`` the surface's ``integrator.Surface``. Returns
    the next state's arrays by their ``RenderState`` field (fresh tensors:
    ``state`` stays valid)."""
    lib = _kernels.load()
    dev = _kernels.card(state.accum.device)
    h, w = state.height, state.width
    r = h * w
    u = _uniforms(dev, u, r)
    (n_spot, spot_s), (n_dir, dir_s) = lights
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
        ptrs = [_arg(dev, "accum", state.accum, _F32, (h, w, 4)),
                _arg(dev, "depth_buf", state.depth_buf, _F32, (h, w)),
                _arg(dev, "space_buf", state.space_buf, _F32, (h, w, 3)),
                _arg(dev, "origin", state.origin, _F32, vec),
                _arg(dev, "direction", state.direction, _F32, vec),
                _arg(dev, "path_depth", state.path_depth, _I32, (r,)),
                u,
                _arg(dev, "t_final", sf.t_final, _F32, (r,)),
                _arg(dev, "point", sf.point, _F32, vec),
                _arg(dev, "next_dir", sf.next_dir, _F32, vec),
                _arg(dev, "throughput", sf.throughput, _F32, vec),
                _arg(dev, "throughput_next", sf.throughput_next, _F32, vec),
                _arg(dev, "contrib", sf.contrib, _F32, vec),
                (_arg(dev, "metallic_tint", sf.metallic_tint, _F32, vec)
                 if nee else None),
                _arg(dev, "score", sf.score, _F32, (r,)),
                _arg(dev, "any_hit", sf.any_hit, _BOOL, (r,)),
                _arg(dev, "new_medium", sf.new_medium, _I32, (r,)),
                _arg(dev, "new_depth", sf.new_depth, _I32, (r,)),
                _stacked(sf.shadow_w, dev, r, 3),
                _stacked(sf.shadow_rad, dev, r, None),
                _stacked([v[0] for v in vis], dev, r, 3),
                _stacked([v[1] for v in vis], dev, r, None),
                *[_arg(dev, "the camera", x, _F32) for x in (
                    cam.position, cam.rot, cam.fov, cam.near_far,
                    cam.focal_distance, cam.aperture)],
                *out.values()]
        ints = [r, u.shape[1], w, row0, max_depth, cam.width, cam.height,
                int(nee), n_spot, spot_s, n_dir, dir_s]
        _launch(bounce_tail, lib.rz_bounce_tail, dev, *_args(ptrs, ints))
    return out
