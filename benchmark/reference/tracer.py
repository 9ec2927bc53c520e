"""A plain wavefront path tracer: the reference the benchmark holds the
renderer's output to.

It follows the RayZath integrator's semantics as the renderer states them
(one bounce of every path per pass, paths regenerated in place from the
camera once they end; Beer's law, scattering media, the uber-material
BSDF, next-event estimation with MIS for spot and direct lights, the sky
material, the five kinds of texture maps and normal mapping, transmission
filtered shadows), written on plain torch tensors for any set of pixels:

* intersection is Moller-Trumbore against every triangle that a
  conservative bounding-sphere test (float64) leaves, not the renderer's
  cluster walk and projection test;
* maps are read from each map's own texels, not from packed atlases;
* the uniforms are computed per pixel from the render seed (``rng.py``).

Everything is in ``dtype``: float32 is the reference, bfloat16 the
control. Gradients reach the scene's leaves (:attr:`Scene.leaves`) through
the hit coordinates, the material table, the maps and the light emissions;
hit ids and the bounding-sphere test carry none.
"""
from __future__ import annotations

import math

import torch

from . import rng

BIG = 3.402823466e38
PATH_LIMIT = 255
DET_EPS = 1e-7
TWO_PI = 2.0 * math.pi
#: the kinds of the scene's leaves that a training step updates
LEAVES = ("mat_color", "mat_metalness", "mat_roughness", "mat_emission",
          "mat_ior", "mat_scattering", "color_maps", "scalar_maps",
          "spot_emission", "dir_emission")


def big(dtype) -> float:
    """The open far end: BIG, or the largest number ``dtype`` holds."""
    return min(BIG, torch.finfo(dtype).max)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v):
    return v / torch.sqrt(torch.clamp(dot(v, v), min=1e-20))[..., None]


def local_frame(n):
    b = (n[..., 0].abs() > n[..., 1].abs()).to(n.dtype)
    x0 = torch.stack([1.0 - b, b, torch.zeros_like(b)], -1)
    vy = cross(n, x0)
    return cross(n, vy), vy


def sample_sphere(r1, r2, n):
    vx, vy = local_frame(n)
    phi = r1 * TWO_PI
    ct = 1.0 - 2.0 * r2
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=1e-12))
    return (vx * (st * torch.cos(phi))[..., None]
            + vy * (st * torch.sin(phi))[..., None] + n * ct[..., None])


def cosine_hemisphere(r1, r2, n):
    vx, vy = local_frame(n)
    phi = r1 * TWO_PI
    sq = torch.sqrt(r2)
    return (vx * (sq * torch.cos(phi))[..., None]
            + vy * (sq * torch.sin(phi))[..., None]
            + n * torch.sqrt(torch.clamp(1.0 - r2, min=1e-12))[..., None])


def sample_disk(r1, r2, n, radius):
    vx, vy = local_frame(n)
    ang = r1 * TWO_PI
    rad = torch.sqrt(r2) * radius
    return (vx * (torch.sin(ang) * rad)[..., None]
            + vy * (torch.cos(ang) * rad)[..., None])


def reflect(v, n):
    return v - 2.0 * dot(n, v)[..., None] * n


class Scene:
    """A flattened world (``world.flatten``) on ``device`` in ``dtype``.

    :attr:`leaves` holds the differentiable parameters (``LEAVES``): the
    material columns, the colour and scalar maps' texels (lists, one
    tensor per map) and the lights' emissions."""

    def __init__(self, flat: dict, device, dtype=torch.float32):
        self.dtype, self.device = dtype, torch.device(device)

        def f(x):
            return torch.as_tensor(x, device=device).to(dtype)

        v0 = torch.as_tensor(flat["v0"], device=device)          # float32
        e1 = torch.as_tensor(flat["v1"], device=device) - v0
        e2 = torch.as_tensor(flat["v2"], device=device) - v0
        self.v0, self.e1, self.e2 = v0.to(dtype), e1.to(dtype), e2.to(dtype)
        self.n_tri = v0.shape[0]
        self.normals = f(flat["normals"])                        # [T,3,3]
        self.texcrds = f(flat["texcrds"])                        # [T,3,2]
        self.tri_mat = torch.as_tensor(flat["tri_mat"], device=device).long()
        # bounding spheres, float64, widened past any float32 rounding of
        # the exact test
        v64 = [torch.as_tensor(flat[k], device=device).double()
               for k in ("v0", "v1", "v2")]
        c = (v64[0] + v64[1] + v64[2]) / 3.0
        r = torch.stack([(v - c).norm(dim=1) for v in v64], 1).amax(1)
        self.center, self.cc = c, (c * c).sum(1)
        self.r2 = (r * (1.0 + 1e-4) + 1e-4) ** 2
        self.mat_maps = torch.as_tensor(flat["mat_maps"], device=device).long()
        self.maps = flat["maps"]
        self.has_maps = len(self.maps) > 0
        self.n_mat = self.mat_maps.shape[0]
        for k in ("spot_pos", "spot_dir", "spot_color", "spot_size",
                  "spot_cos", "dir_dir", "dir_color", "dir_cos"):
            setattr(self, k, f(flat[k]))
        self.n_spot, self.n_dir = len(flat["spot_size"]), len(flat["dir_cos"])
        self.leaves = {
            k: f(flat[k]) for k in ("mat_color", "mat_metalness",
                                    "mat_roughness", "mat_emission", "mat_ior",
                                    "mat_scattering", "spot_emission",
                                    "dir_emission")}
        self.leaves["color_maps"] = [f(m["data"]) for m in self.maps
                                     if m["color"]]
        self.leaves["scalar_maps"] = [f(m["data"][..., 0]) for m in self.maps
                                      if not m["color"]]
        cam = flat["camera"]
        self.cam = dict(cam, position=f(cam["position"]), axes=f(cam["axes"]),
                        near_far=f(cam["near_far"]))

    def map_texels(self, m: int):
        """The texel tensor of map ``m`` ([h, w, 4] colour, [h, w] scalar)."""
        spec = self.maps[m]
        kind = "color_maps" if spec["color"] else "scalar_maps"
        k = sum(1 for s in self.maps[:m] if s["color"] == spec["color"])
        return self.leaves[kind][k]

    def n_streams(self, cfg: dict) -> int:
        """Uniforms a pass draws per pixel: 8, then 3 per spot and per
        direct light sample where the scene has such lights."""
        ns = 8
        if self.n_spot:
            ns += 3 * cfg["spot_light"]
        if self.n_dir:
            ns += 3 * cfg["direct_light"]
        return ns


# ---------------------------------------------------------------------------
# intersection
# ---------------------------------------------------------------------------

def moller_trumbore(o, d, v0, e1, e2):
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    det = det + (det.abs() < DET_EPS).to(det.dtype) * DET_EPS
    inv = 1.0 / det
    tvec = o - v0
    b1 = dot(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    b2 = dot(d, qvec) * inv
    t = dot(e2, qvec) * inv
    return t, b1, b2, det


#: triangle-ray products of one block of the bounding-sphere test
PAIR_BLOCK = 1 << 25


@torch.no_grad()
def _pairs(sc: Scene, o, d):
    """(triangle, ray) index pairs whose bounding sphere meets the ray's
    line: a superset of the hits."""
    chunk = max(1, PAIR_BLOCK // max(sc.n_tri, 1))
    o64 = o.detach().double()
    d64 = d.detach().double()
    d64 = d64 / d64.norm(dim=1, keepdim=True).clamp(min=1e-300)
    od, oo = (o64 * d64).sum(1), (o64 * o64).sum(1)
    tris, rays = [], []
    for i in range(0, o.shape[0], chunk):
        s = slice(i, i + chunk)
        cd = sc.center @ d64[s].T                      # [T, r]
        co = sc.center @ o64[s].T
        wd = cd - od[s][None]
        w2 = sc.cc[:, None] - 2.0 * co + oo[s][None]
        t_i, r_i = ((w2 - wd * wd) <= sc.r2[:, None]).nonzero(as_tuple=True)
        tris.append(t_i)
        rays.append(r_i + i)
    return torch.cat(tris), torch.cat(rays)


def closest_hit(sc: Scene, o, d, near, far):
    """(tri [R] long, -1 = miss; t, b1, b2, det): the nearest hit with t in
    (near, far), the lowest triangle index on a tie; (t, b1, b2, det) of
    the hit triangle are recomputed on ``o``, ``d`` so that they carry
    gradients."""
    r = o.shape[0]
    with torch.no_grad():
        tri, ray = _pairs(sc, o, d)
        t, b1, b2, _ = moller_trumbore(o[ray], d[ray], sc.v0[tri], sc.e1[tri],
                                       sc.e2[tri])
        ok = ((b1 >= 0) & (b1 <= 1) & (b2 >= 0) & (b1 + b2 <= 1)
              & (t > near[ray]) & (t < far[ray]))
        best = torch.full((r,), float("inf"), dtype=t.dtype, device=o.device)
        best = best.scatter_reduce(0, ray[ok], t[ok], "amin")
        win = ok & (t == best[ray])
        first = torch.full((r,), sc.n_tri, dtype=torch.long, device=o.device)
        first = first.scatter_reduce(0, ray[win], tri[win], "amin")
        hit_id = torch.where(first < sc.n_tri, first, -1)
    k = hit_id.clamp(min=0)
    t, b1, b2, det = moller_trumbore(o, d, sc.v0[k], sc.e1[k], sc.e2[k])
    return hit_id, t, b1, b2, det


def shadow(sc: Scene, o, d, dist):
    """Transmission of the segments (o, o + dist * d): over every hit with
    0 < t < dist, the product of the material's colour and of its opacity
    (1 - alpha), each times the hit's colour-map texel (rgb, 1 - alpha)
    where the material has a colour map. Returns (rgb [R,3], a [R])."""
    r = o.shape[0]
    with torch.no_grad():
        tri, ray = _pairs(sc, o, d)
        t, b1, b2, _ = moller_trumbore(o[ray], d[ray], sc.v0[tri], sc.e1[tri],
                                       sc.e2[tri])
        ok = ((b1 >= 0) & (b1 <= 1) & (b2 >= 0) & (b1 + b2 <= 1)
              & (t > 0) & (t < dist[ray]))
        tri, ray, b1, b2 = tri[ok], ray[ok], b1[ok], b2[ok]
        ray, order = torch.sort(ray, stable=True)
        tri, b1, b2 = tri[order], b1[order], b2[order]
        counts = torch.bincount(ray, minlength=r)
        start = torch.cumsum(counts, 0) - counts
        rank = torch.arange(ray.shape[0], device=o.device) - start[ray]
        width = int(counts.max()) if r else 0
    mat = sc.tri_mat[tri]
    color = sc.leaves["mat_color"][mat]
    f_rgb, f_a = color[:, :3], 1.0 - color[:, 3]
    if sc.has_maps:
        tex_id = sc.mat_maps[mat, 0]
        tc = sc.texcrds[tri]
        uv = (tc[:, 0] * (1.0 - b1 - b2)[:, None] + tc[:, 1] * b1[:, None]
              + tc[:, 2] * b2[:, None])
        tex = fetch(sc, tex_id, uv)
        has = (tex_id >= 0)[:, None]
        f_rgb = torch.where(has, f_rgb * tex[:, :3], f_rgb)
        f_a = torch.where(has[:, 0], f_a * (1.0 - tex[:, 3]), f_a)
    one = torch.ones((r, max(width, 1)), dtype=sc.dtype, device=o.device)
    a = one.index_put((ray, rank), f_a).prod(1)
    rgb = torch.stack([one.index_put((ray, rank), f_rgb[:, c]).prod(1)
                       for c in range(3)], 1)
    return rgb, a


# ---------------------------------------------------------------------------
# maps
# ---------------------------------------------------------------------------

def _address(x, mode: int):
    if mode == 0:
        c = torch.remainder(x, 1.0)
    elif mode == 2:
        p = torch.remainder(x, 2.0)
        c = torch.clamp(torch.where(p > 1.0, 2.0 - p, p), 0.0, 1.0 - 1e-6)
    else:
        c = torch.clamp(x, 0.0, 1.0 - 1e-6)
    border = ((x < 0.0) | (x >= 1.0)) if mode == 3 else torch.zeros_like(x, dtype=torch.bool)
    return c, border


def _fetch_one(sc: Scene, m: int, uv):
    """Map ``m`` at texture coordinates ``uv`` [R,2]: the transform
    ``uv += translation; rotate; *= scale``, the v axis flipped, point or
    bilinear filtering (texel centres at +0.5, the +1 neighbour clamped
    inside the map), wrap / clamp / mirror / border addressing (zero
    outside a border map). Returns [R, 4] (a scalar map broadcast)."""
    spec = sc.maps[m]
    data = sc.map_texels(m)
    h, w = data.shape[0], data.shape[1]
    u = uv[:, 0] + spec["translation"][0]
    v = uv[:, 1] + spec["translation"][1]
    c, s = math.cos(spec["rotation"]), math.sin(spec["rotation"])
    u, v = (u * c - v * s) * spec["scale"][0], (u * s + v * c) * spec["scale"][1]
    un, ub = _address(u, spec["address"])
    vn, vb = _address(v, spec["address"])
    vn = 1.0 - vn
    fx, fy = un * w - 0.5, vn * h - 0.5
    xl, yl = torch.floor(fx), torch.floor(fy)
    ax = torch.where(xl < 0, torch.zeros_like(fx), fx - xl)[:, None]
    ay = torch.where(yl < 0, torch.zeros_like(fy), fy - yl)[:, None]
    x0 = xl.long().clamp(0, w - 1)
    y0 = yl.long().clamp(0, h - 1)
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    tex = data if data.dim() == 3 else data[..., None]
    v00, v10, v01, v11 = tex[y0, x0], tex[y0, x1], tex[y1, x0], tex[y1, x1]
    if spec["filter"] == 0:
        out = torch.where(ay >= 0.5, torch.where(ax >= 0.5, v11, v01),
                          torch.where(ax >= 0.5, v10, v00))
    else:
        out = ((v00 * (1 - ax) + v10 * ax) * (1 - ay)
               + (v01 * (1 - ax) + v11 * ax) * ay)
    out = torch.where((ub | vb)[:, None], torch.zeros_like(out), out)
    return out.expand(-1, 4)


def fetch(sc: Scene, map_id, uv):
    """Per-ray map ``map_id`` [R] (< 0: zeros) at ``uv`` [R,2] -> [R,4]."""
    out = torch.zeros((uv.shape[0], 4), dtype=sc.dtype, device=uv.device)
    for m in range(len(sc.maps)):
        sel = (map_id == m)[:, None]
        out = torch.where(sel, _fetch_one(sc, m, uv), out)
    return out


# ---------------------------------------------------------------------------
# camera, sky
# ---------------------------------------------------------------------------

def camera_rays(sc: Scene, px, py, u):
    """Thin-lens rays through pixels (px, py) with jitter and aperture
    uniforms ``u`` [R,4]; both jitter axes scale by 0.5 / width."""
    cam = sc.cam
    w, h = float(cam["width"]), float(cam["height"])
    tana = math.tan(cam["fov"] * 0.5)
    dx = ((px + 0.5) / w - 0.5) * tana + (0.5 / w) * (u[:, 0] * 2.0 - 1.0)
    dy = (((py + 0.5) / h - 0.5) * (-tana / (w / h))
          + (0.5 / w) * (u[:, 1] * 2.0 - 1.0))
    focal = torch.stack([dx, dy, torch.ones_like(dx)], 1) * cam["focal_distance"]
    ang = u[:, 2] * TWO_PI
    rad = torch.sqrt(u[:, 3]) * cam["aperture"]
    lens = torch.stack([rad * torch.sin(ang), rad * torch.cos(ang),
                        torch.zeros_like(ang)], 1)
    return (rotate(lens, cam["axes"]) + cam["position"],
            normalize(rotate(focal - lens, cam["axes"])))


def rotate(v, axes):
    """``axes @ v`` for rows v [R,3] (the columns of ``axes`` are the
    camera's axes), written out so that no matrix unit rounds it."""
    return (v[:, 0:1] * axes[:, 0] + v[:, 1:2] * axes[:, 1]
            + v[:, 2:3] * axes[:, 2])


def primary_hits(sc: Scene, cam: dict, xs, ys):
    """(depth, point) of the pinhole ray through each pixel's centre
    (no jitter, no aperture) under ``cam``; a miss takes the far plane."""
    w, h = float(cam["width"]), float(cam["height"])
    tana = math.tan(cam["fov"] * 0.5)
    px, py = xs.to(sc.dtype), ys.to(sc.dtype)
    dx = ((px + 0.5) / w - 0.5) * tana
    dy = ((py + 0.5) / h - 0.5) * (-tana / (w / h))
    d = normalize(rotate(torch.stack([dx, dy, torch.ones_like(dx)], 1),
                         cam["axes"]))
    o = cam["position"].expand(d.shape[0], 3)
    near = cam["near_far"][0].expand(d.shape[0])
    far = cam["near_far"][1].expand(d.shape[0])
    tri, t, _, _, _ = closest_hit(sc, o, d, near, far)
    t = torch.where(tri >= 0, t, far)
    return t, o + d * t[:, None]


def reproject(sc: Scene, prev: dict, prev_accum, prev_depth, blend: float,
              xs, ys):
    """The accumulation a moved camera starts from at pixels (xs, ys): each
    pixel's primary hit under the new camera (``sc.cam``) projected into
    the previous camera ``prev``; where it lands in front, on screen, and
    within 1% of the previous depth buffer there, the previous
    accumulation [H, W, 4] of that pixel (the index truncated) times
    ``blend``, else zero."""
    h, w = prev_accum.shape[0], prev_accum.shape[1]
    _, point = primary_hits(sc, sc.cam, xs, ys)
    rel = point - prev["position"]
    # components along the previous camera's axes (the columns of axes)
    local = (rel[:, 0:1] * prev["axes"][0] + rel[:, 1:2] * prev["axes"][1]
             + rel[:, 2:3] * prev["axes"][2])
    lz = local[:, 2]
    front = lz > 0.0
    lz = torch.where(front, lz, torch.ones_like(lz))
    tana = math.tan(prev["fov"] * 0.5)
    fx = ((local[:, 0] / lz) / tana + 0.5) * w
    fy = ((local[:, 1] / lz) / (-tana / (w / h)) + 0.5) * h
    on = (fx >= 0.0) & (fx < w) & (fy >= 0.0) & (fy < h)
    ix = torch.clamp(fx, -1.0, float(w)).to(torch.int32).long().clamp(0, w - 1)
    iy = torch.clamp(fy, -1.0, float(h)).to(torch.int32).long().clamp(0, h - 1)
    dist = torch.sqrt(dot(rel, rel))
    ok = front & on & ((dist - prev_depth[iy, ix]).abs() < 0.01 * dist)
    return torch.where(ok[:, None], prev_accum[iy, ix] * blend,
                       torch.zeros((), dtype=sc.dtype, device=sc.device))


def sky_texcrd(d):
    """Sky-sphere texture coordinates of directions ``d``. A direction
    straight up or down has no finite derivative of its latitude: it
    passes none (a non-finite one would reach every leaf through the
    zero-weighted branches of the ``where`` that choose it away)."""
    u = -(0.5 + torch.atan2(d[:, 2], d[:, 0]) / TWO_PI)
    y = torch.clamp(d[:, 1], -1.0, 1.0)
    y = torch.where(y.abs() < 1.0, y, y.detach())
    v = 0.5 + torch.asin(y) / math.pi
    return torch.stack([u, v], 1)


# ---------------------------------------------------------------------------
# one bounce
# ---------------------------------------------------------------------------

def brdf(d_in, n, scattering, rough, alpha_op, refl, out):
    n_o = dot(n, out)
    n_i = dot(n, -d_in)
    h = normalize(out - d_in)
    n_h = torch.clamp(dot(n, h), -1.0, 1.0)
    b = n_h * n_h * (rough - 1.0) + 1.0001
    ndf = (rough + 1e-5) / (b * b)

    def att(c):
        c = torch.clamp(c, min=0.0)
        return c / (c * (1.0 - rough) + rough + 1e-7)

    diffuse = n_o * (alpha_op == 0.0).to(n_o.dtype)
    specular = ndf * att(n_i) * att(n_o) / torch.clamp(n_i * n_o, min=1e-7)
    val = diffuse + (specular * n_o - diffuse) * refl
    val = torch.where((n_o <= 0.0) | (n_i <= 0.0), torch.zeros_like(val), val)
    return torch.where(scattering > 0.0, torch.ones_like(val), val)


def fresnel(n, d, n1, n2):
    """(reflectance, ratio, b): the refracted direction is d * ratio + n * b;
    total internal reflection reflects all. Its gradient is that of the
    reflectance blended to 1 by sigmoid((sin^2 t - 1) / 0.05), the value
    the exact one."""
    ratio = n1 / torch.clamp(n2, min=1e-20)
    cosi = dot(d, n).abs()
    sin2 = ratio * ratio * (1.0 - cosi * cosi)
    cost = torch.sqrt(torch.clamp(1.0 - sin2, min=1e-12))
    rp = (n1 * cosi - n2 * cost) / torch.clamp(n1 * cosi + n2 * cost, min=1e-20)
    rs = (n2 * cosi - n1 * cost) / torch.clamp(n2 * cosi + n1 * cost, min=1e-20)
    f = 0.5 * (rs * rs + rp * rp)
    exact = torch.where(sin2 >= 1.0, torch.ones_like(f), f)
    smooth = f + (1.0 - f) * torch.sigmoid((sin2 - 1.0) / 0.05)
    return smooth + (exact - smooth).detach(), ratio, ratio * cosi - cost


def init_paths(sc: Scene, xs, ys):
    """Fresh paths of pixels (xs, ys): ended (depth PATH_LIMIT), so the
    first pass regenerates them; until then the ray is (0, +z) in the
    world medium with unit throughput, clip range (0, BIG) and no
    free-flight score."""
    k, dev, dt = xs.shape[0], sc.device, sc.dtype
    d = torch.zeros((k, 3), dtype=dt, device=dev)
    d[:, 2] = 1.0
    return dict(o=torch.zeros((k, 3), dtype=dt, device=dev), d=d,
                thr=torch.ones((k, 3), dtype=dt, device=dev),
                med=torch.zeros(k, dtype=torch.long, device=dev),
                depth=torch.full((k,), PATH_LIMIT, dtype=torch.long, device=dev),
                near=torch.zeros(k, dtype=dt, device=dev),
                far=torch.full((k,), big(dt), dtype=dt, device=dev),
                score=torch.zeros(k, dtype=dt, device=dev))


def _nee(sc: Scene, cfg, point, nxt, d, mn, scat, rough, alpha_op, refl,
         color, vs_pdf, med_scat, u):
    """Direct light at ``point``: per spot-light sample a point on the
    light's disk (or the sampled direction where it meets the disk), per
    direct-light sample a direction in its cone (or the sampled one),
    each weighted by MIS against the BSDF's pdf ``vs_pdf`` and filtered by
    the shadow's transmission."""
    total = torch.zeros_like(point)
    off = 8
    brdf_color = color + (1.0 - color) * refl[:, None]
    if sc.n_spot:
        n = cfg["spot_light"]
        for s in range(n):
            us = u[:, off + 3 * s: off + 3 * s + 3]
            li = torch.clamp((us[:, 0] * sc.n_spot).long(), max=sc.n_spot - 1)
            lpos, ldir, lcol = sc.spot_pos[li], sc.spot_dir[li], sc.spot_color[li]
            lsize, lcos = sc.spot_size[li], sc.spot_cos[li]
            lemit = sc.leaves["spot_emission"][li]
            v0 = lpos - point
            d0 = torch.sqrt(torch.clamp(dot(v0, v0), min=1e-20))
            vop = dot(v0, nxt)
            dpq = torch.sqrt(torch.clamp(d0 * d0 - vop * vop, min=1e-20))
            hits = (dpq < lsize) & (vop > 0.0)
            doq = torch.sqrt(torch.clamp(d0 * d0 - dpq * dpq, min=1e-20))
            vpl = torch.where(hits[:, None], nxt * torch.clamp(doq, min=1e-4)[:, None],
                              sample_disk(us[:, 1], us[:, 2], v0 / d0[:, None],
                                          lsize) + v0)
            se = torch.where(hits, lemit, torch.zeros_like(lemit))
            dist = torch.sqrt(torch.clamp(dot(vpl, vpl), min=1e-20))
            vn = vpl / dist[:, None]
            b = brdf(d, mn, scat, rough, alpha_op, refl, vn)
            solid = (lsize * lsize * math.pi) / ((dist + 1.0) * (dist + 1.0))
            beam = (lcos < dot(-vn, ldir)).to(sc.dtype)
            vsw = vs_pdf / (vs_pdf + 1.0 / torch.clamp(solid, min=1e-20))
            rad = ((lemit * solid * b) * (1.0 - vsw) + se * vsw) \
                * torch.exp(-dist * med_scat) * beam
            rad = torch.where((rad < 1e-4) | (b < 1e-4), torch.zeros_like(rad), rad)
            v_rgb, v_a = shadow(sc, point, vn, dist)
            total = total + lcol * brdf_color * (rad * v_a)[:, None] * v_rgb \
                / (n / float(sc.n_spot))
        off += 3 * n
    if sc.n_dir:
        n = cfg["direct_light"]
        for s in range(n):
            us = u[:, off + 3 * s: off + 3 * s + 3]
            li = torch.clamp((us[:, 0] * sc.n_dir).long(), max=sc.n_dir - 1)
            ldir, lcol, lcos = sc.dir_dir[li], sc.dir_color[li], sc.dir_cos[li]
            lemit = sc.leaves["dir_emission"][li]
            hits = dot(nxt, -ldir) > lcos
            cone = sample_sphere(us[:, 1], us[:, 2] * 0.5 * (1.0 - lcos), -ldir)
            vn = normalize(torch.where(hits[:, None], nxt, cone))
            se = torch.where(hits, lemit, torch.zeros_like(lemit))
            b = brdf(d, mn, scat, rough, alpha_op, refl, vn)
            solid = TWO_PI * (1.0 - lcos)
            vsw = vs_pdf / (vs_pdf + 1.0 / torch.clamp(solid, min=1e-20))
            rad = (lemit * solid * b) * (1.0 - vsw) + se * vsw
            rad = torch.where(rad < 1e-4, torch.zeros_like(rad), rad)
            v_rgb, v_a = shadow(sc, point, vn, torch.full_like(se, big(sc.dtype)))
            total = total + lcol * brdf_color * (rad * v_a)[:, None] * v_rgb \
                / (n / float(sc.n_dir))
    return total


def bounce(sc: Scene, cfg: dict, p: dict, u, px, py):
    """One pass for the paths ``p`` (``init_paths``'s keys) of pixels
    (px, py) with their uniforms ``u`` [R, ns]. Returns (the paths after
    the pass, the radiance added [R,3], the sample count added [R]: 1
    where the path ended, as the score ratio)."""
    dt = sc.dtype
    L = sc.leaves
    zero = torch.zeros((), dtype=dt, device=sc.device)
    o, d, depth0 = p["o"], p["d"], p["depth"]
    near = torch.where(depth0 == 0, sc.cam["near_far"][0], p["near"])
    far = torch.where(depth0 == 0, sc.cam["near_far"][1], p["far"])
    med = p["med"].clamp(0, sc.n_mat - 1)
    med_color, med_ior = L["mat_color"][med], L["mat_ior"][med]
    med_scat = L["mat_scattering"][med]

    sigma = torch.clamp(med_scat, min=1e-20)
    scat_dist = -torch.log(u[:, 0] + 1e-4) / sigma.detach()
    has_scat = med_scat > 1e-4
    far_eff = torch.where(has_scat, torch.minimum(far, scat_dist), far)
    tri, t, b1, b2, det = closest_hit(sc, o, d, near, far_eff)
    hit = tri >= 0
    scat_evt = has_scat & ~hit & (scat_dist < far)
    any_hit = hit | scat_evt
    t_final = torch.where(hit, t, torch.where(scat_evt, scat_dist, far_eff))
    external = det > 0.0
    # the free flight's outcome is a discrete function of sigma: its
    # gradient comes from the score function, the outcome's log-likelihood
    # (scatter pdf sigma exp(-sigma s), survival exp(-sigma t)) in a ratio
    # of value 1 on the throughput, and the path's summed log-likelihood in
    # a ratio on the sample count
    t_sg = t_final.detach()
    logp = torch.where(scat_evt, torch.log(sigma) - sigma * t_sg,
                       torch.where(has_scat, -sigma * t_sg, zero))
    score = p["score"] + logp
    event_ratio = torch.exp(logp - logp.detach())
    count_ratio = torch.exp(score - score.detach())

    k = tri.clamp(min=0)
    world = torch.zeros_like(med)
    surf = torch.where(hit, sc.tri_mat[k], torch.where(scat_evt, med, world))
    behind = torch.where(hit & external, surf, torch.where(scat_evt, med, world))

    b0 = 1.0 - b1 - b2
    tc, nv = sc.texcrds[k], sc.normals[k]
    e1, e2 = sc.e1[k], sc.e2[k]
    ext = torch.where(external, torch.ones_like(t), -torch.ones_like(t))[:, None]
    flat_n = normalize(cross(e1, e2)) * ext
    shade_n = normalize(nv[:, 0] * b0[:, None] + nv[:, 1] * b1[:, None]
                        + nv[:, 2] * b2[:, None])

    mid = surf.clamp(0, sc.n_mat - 1)
    base = L["mat_color"][mid]
    color, alpha_op = base[:, :3], 1.0 - base[:, 3]
    metal, rough = L["mat_metalness"][mid], L["mat_roughness"][mid]
    emis, scat = L["mat_emission"][mid], L["mat_scattering"][mid]
    mapped = shade_n
    if sc.has_maps:
        texcrd = torch.where(hit[:, None], tc[:, 0] * b0[:, None]
                             + tc[:, 1] * b1[:, None] + tc[:, 2] * b2[:, None],
                             torch.where(scat_evt[:, None], zero, sky_texcrd(d)))
        maps = sc.mat_maps[mid]
        tex = fetch(sc, maps[:, 0], texcrd)
        has = maps[:, 0] >= 0
        color = torch.where(has[:, None], color * tex[:, :3], color)
        alpha_op = torch.where(has, alpha_op * (1.0 - tex[:, 3]), alpha_op)
        metal = torch.where(maps[:, 2] >= 0, fetch(sc, maps[:, 2], texcrd)[:, 0], metal)
        rough = torch.where(maps[:, 3] >= 0, fetch(sc, maps[:, 3], texcrd)[:, 0], rough)
        emis = torch.where(maps[:, 4] >= 0, emis * fetch(sc, maps[:, 4], texcrd)[:, 0],
                           emis)
        # tangent-space normal mapping
        nm = fetch(sc, maps[:, 1], texcrd)[:, :3] * 2.0 - 1.0
        duv1, duv2 = tc[:, 1] - tc[:, 0], tc[:, 2] - tc[:, 0]
        det_uv = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
        inv_uv = 1.0 / torch.where(det_uv.abs() < 1e-12,
                                   torch.full_like(det_uv, 1e-12), det_uv)
        tangent = normalize((e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv_uv[:, None])
        tangent = normalize(tangent - mapped * dot(tangent, mapped)[:, None])
        bitangent = cross(tangent, mapped)
        bent = normalize(mapped * nm[:, 2:3] + tangent * nm[:, 0:1]
                         + bitangent * nm[:, 1:2])
        mapped = torch.where((maps[:, 1] >= 0)[:, None], bent, mapped)
    mapped = mapped * ext
    normal = torch.where(hit[:, None], flat_n, d)
    mn = torch.where(hit[:, None], mapped, d)

    thr = p["thr"] * med_color[:, :3] * (event_ratio * torch.pow(
        torch.clamp(1.0 - med_color[:, 3], min=1e-6), t_final))[:, None]
    contrib = torch.where((emis > 0.0)[:, None], thr * color * emis[:, None], zero)
    new_depth = torch.where(any_hit, depth0 + 1, torch.full_like(depth0, PATH_LIMIT))

    n2 = L["mat_ior"][behind.clamp(0, sc.n_mat - 1)]
    fres, ratio, refr_b = fresnel(mn, d, med_ior, n2)
    refl = fres + (1.0 - fres) * metal

    # the next direction
    r1, r2, lottery = u[:, 1], u[:, 2], u[:, 3]

    def above(v):
        c = dot(normal, v)[:, None]
        return torch.where(c < 0.0, v - 2.0 * c * normal, v)

    take_refr = fres < lottery
    trans_dir = torch.where(take_refr[:, None], d * ratio[:, None] + mn * refr_b[:, None],
                            above(reflect(d, mn)))
    vh = sample_sphere(r1, (1.0 - torch.pow(r2 + 1e-5, rough)) * 0.5, mn)
    is_trans = alpha_op > 0.0
    is_scat = is_trans & (scat > 0.0)
    is_diff = ~is_trans & (lottery > refl)
    nxt = torch.where(is_scat[:, None], sample_sphere(r1, r2, d),
                      torch.where(is_trans[:, None], trans_dir,
                                  torch.where(is_diff[:, None],
                                              above(cosine_hemisphere(r1, r2, mn)),
                                              above(reflect(d, vh)))))
    nxt = normalize(nxt)
    tint = torch.where(is_scat, metal,
                       torch.where(is_trans, torch.where(take_refr, torch.ones_like(metal),
                                                         metal),
                                   torch.where(is_diff, torch.ones_like(metal), metal)))
    refracted = is_trans & ~is_scat & take_refr
    nudge = torch.where(refracted[:, None], -normal, normal)
    point = o + d * t_final[:, None] + nudge * (1e-4 * t_final)[:, None]

    if sc.n_spot or sc.n_dir:
        pt = torch.where(any_hit[:, None], point, zero)
        vs_pdf = brdf(d, mn, scat, rough, alpha_op, refl, nxt)
        direct = _nee(sc, cfg, pt, nxt, d, mn, scat, rough, alpha_op, refl,
                      color, vs_pdf, med_scat, u)
        tint_m = 1.0 + (color - 1.0) * metal[:, None]
        contrib = contrib + torch.where(any_hit[:, None], direct * thr * tint_m, zero)

    thr_next = thr + (thr * color - thr) * tint[:, None]
    ended = new_depth >= cfg["max_depth"]
    cam_o, cam_d = camera_rays(sc, px, py, u[:, 4:8])
    e = ended[:, None]
    nf = sc.cam["near_far"]
    out = dict(o=torch.where(e, cam_o, point), d=torch.where(e, cam_d, nxt),
               thr=torch.where(e, torch.ones_like(thr_next), thr_next),
               med=torch.where(ended, world, torch.where(refracted, behind, med)),
               depth=torch.where(ended, torch.zeros_like(new_depth), new_depth),
               near=torch.where(ended, nf[0], zero),
               far=torch.where(ended, nf[1], torch.full_like(far, big(dt))),
               score=torch.where(ended, zero, score))
    return out, contrib, torch.where(ended, count_ratio, zero)


def trace(sc: Scene, cfg: dict, seed: int, first_pass: int, n_passes: int,
          xs, ys, paths=None):
    """``n_passes`` passes from pass ``first_pass`` of a render seeded with
    ``seed`` for the pixels (xs, ys) (int64 [R]), from ``paths`` (fresh
    when None). Returns (paths, radiance summed over the passes [R,3],
    paths ended over the passes [R])."""
    if paths is None:
        paths = init_paths(sc, xs, ys)
    ns = sc.n_streams(cfg)
    px, py = xs.to(sc.dtype), ys.to(sc.dtype)
    rad = torch.zeros((xs.shape[0], 3), dtype=sc.dtype, device=sc.device)
    count = torch.zeros(xs.shape[0], dtype=sc.dtype, device=sc.device)
    for i in range(n_passes):
        u = rng.pixel_uniforms(seed, first_pass + i, xs, ys, ns).to(sc.dtype)
        paths, c, n = bounce(sc, cfg, paths, u, px, py)
        rad = rad + c
        count = count + n
    return paths, rad, count
