"""The scene a world describes, as flat NumPy arrays for the plain tracer.

Reads the host world's public description (meshes, instances and their
transforms, materials, the five kinds of maps, lights, cameras) and works
out on its own what the renderer derives from it: world-space triangles,
per-triangle materials, vertex normals and texture coordinates, the
material table and the camera's axes. It imports nothing of the renderer.

Conventions (those of the RayZath engine the renderer follows):

* material 0 is the world's (sky and outer medium), 1 the default surface
  material, then the world's materials in order; an instance's empty or
  missing slot takes material 1;
* an instance places its mesh by ``R @ (v * scale) + position``, where R
  rotates about x, then y, then z (axis matrices in the axes-rotation
  convention); a normal goes through ``R @ (n / scale)``, normalised;
* a camera's axes are R = Ry @ Rx @ Rz of its Euler angles (z, then x,
  then y);
* a vertex without a normal takes the triangle's geometric normal, one
  without texture coordinates (0, 0).
"""
from __future__ import annotations

import numpy as np

KINDS = ("texture", "normal_map", "metalness_map", "roughness_map",
         "emission_map")
SLOTS = 64


def _rx(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, s], [0, -s, c]])


def _ry(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])


def _rz(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])


def _unit(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


def _placement(transform):
    """(R, scale, position) of a transform, float64."""
    r = np.asarray(transform.rotation, np.float64)
    rot = _rz(r[2]) @ _ry(r[1]) @ _rx(r[0])
    return (rot, np.asarray(transform.scale, np.float64),
            np.asarray(transform.position, np.float64))


def _chain(inst):
    """The instance's placement composed through its groups: the outer
    placement rotates and offsets the inner position; rotations and
    scales compose."""
    rot, scale, pos = _placement(inst.transform)
    g = inst.group
    while g is not None:
        orot, oscale, opos = _placement(g.transform)
        rot, scale, pos = orot @ rot, scale * oscale, orot @ pos + opos
        g = g.parent
    return rot, scale, pos


def camera_axes(rotation) -> np.ndarray:
    r = np.asarray(rotation, np.float64)
    return _ry(r[1]) @ _rx(r[0]) @ _rz(r[2])


def flatten(world, camera_index: int = 0) -> dict:
    """Flat arrays of ``world`` and its camera ``camera_index``."""
    materials = [world.material, world.default_material] + list(world.materials)
    mat_id = {id(m): i for i, m in enumerate(materials)}
    maps, map_id = [], {}
    for kind in ("textures", "normal_maps", "metalness_maps", "roughness_maps",
                 "emission_maps"):
        for m in getattr(world, kind):
            map_id[id(m)] = len(maps)
            maps.append(dict(
                data=np.asarray(m.data, np.float32),
                color=kind in ("textures", "normal_maps"),
                filter=int(m.filter_mode), address=int(m.address_mode),
                scale=tuple(float(x) for x in m.scale),
                rotation=float(m.rotation),
                translation=tuple(float(x) for x in m.translation)))

    def ref(m):
        return -1 if m is None else map_id[id(m)]

    v0s, v1s, v2s, ns, ts, mats = [], [], [], [], [], []
    for inst in world.instances:
        mesh = inst.mesh
        if mesh is None or len(mesh.tri_v) == 0:
            continue
        rot, scale, pos = _chain(inst)
        verts = ((np.asarray(mesh.vertices, np.float64) * scale) @ rot.T
                 + pos).astype(np.float32)
        tv = np.asarray(mesh.tri_v)
        v = [verts[tv[:, k]] for k in range(3)]
        geo = _unit(np.cross((v[1] - v[0]).astype(np.float64),
                             (v[2] - v[0]).astype(np.float64)))
        normals = np.asarray(mesh.normals, np.float64)
        tn = np.asarray(mesh.tri_n) if len(normals) else None
        if tn is not None:
            wn = _unit((normals / np.maximum(np.abs(scale), 1e-20)
                        * np.sign(scale)) @ rot.T)
        tri_n = []
        for k in range(3):
            n = geo.copy()
            if tn is not None:
                ok = tn[:, k] >= 0
                n[ok] = wn[tn[ok, k]]
            tri_n.append(n)
        uvs = np.asarray(mesh.texcrds, np.float32)
        tt = np.asarray(mesh.tri_t) if len(uvs) else None
        tri_t = []
        for k in range(3):
            t = np.zeros((len(tv), 2), np.float32)
            if tt is not None:
                ok = tt[:, k] >= 0
                t[ok] = uvs[tt[ok, k]]
            tri_t.append(t)
        slot_mat = np.ones(SLOTS, np.int64)
        for s, m in enumerate(inst.materials[:SLOTS]):
            if m is not None:
                slot_mat[s] = mat_id[id(m)]
        v0s.append(v[0]); v1s.append(v[1]); v2s.append(v[2])
        ns.append(np.stack(tri_n, 1)); ts.append(np.stack(tri_t, 1))
        mats.append(slot_mat[np.clip(np.asarray(mesh.tri_mat), 0, SLOTS - 1)])

    def cat(xs, shape):
        return np.concatenate(xs) if xs else np.zeros(shape, np.float32)

    cam = world.cameras[camera_index]
    spots, dirs = list(world.spot_lights), list(world.direct_lights)
    return dict(
        v0=cat(v0s, (0, 3)), v1=cat(v1s, (0, 3)), v2=cat(v2s, (0, 3)),
        normals=cat(ns, (0, 3, 3)), texcrds=cat(ts, (0, 3, 2)),
        tri_mat=(np.concatenate(mats) if mats else np.zeros(0, np.int64)),
        mat_color=np.stack([m.color for m in materials]).astype(np.float32),
        mat_metalness=np.array([m.metalness for m in materials], np.float32),
        mat_roughness=np.array([m.roughness for m in materials], np.float32),
        mat_emission=np.array([m.emission for m in materials], np.float32),
        mat_ior=np.array([m.ior for m in materials], np.float32),
        mat_scattering=np.array([m.scattering for m in materials], np.float32),
        mat_maps=np.array([[ref(getattr(m, k)) for k in KINDS]
                           for m in materials], np.int64).reshape(-1, 5),
        maps=maps,
        spot_pos=np.array([l.position for l in spots], np.float32).reshape(-1, 3),
        spot_dir=np.array([l.direction for l in spots], np.float32).reshape(-1, 3),
        spot_color=np.array([l.color for l in spots], np.float32).reshape(-1, 3),
        spot_size=np.array([l.size for l in spots], np.float32),
        spot_emission=np.array([l.emission for l in spots], np.float32),
        spot_cos=np.array([np.cos(l.beam_angle) for l in spots], np.float32),
        dir_dir=np.array([l.direction for l in dirs], np.float32).reshape(-1, 3),
        dir_color=np.array([l.color for l in dirs], np.float32).reshape(-1, 3),
        dir_emission=np.array([l.emission for l in dirs], np.float32),
        dir_cos=np.array([np.cos(l.angular_size) for l in dirs], np.float32),
        camera=dict(position=np.asarray(cam.position, np.float32),
                    axes=camera_axes(cam.rotation).astype(np.float32),
                    fov=float(cam.fov),
                    near_far=np.asarray(cam.near_far, np.float32),
                    focal_distance=float(cam.focal_distance),
                    aperture=float(cam.aperture),
                    exposure_time=float(cam.exposure_time),
                    width=int(cam.width), height=int(cam.height)))
