"""Host mesh model + procedural generators.

Mirrors the reference ``Engine::Mesh`` (RayZath/mesh.hpp:14-71): four component
arrays (vertices, texcrds, normals, triangles) where each triangle is an index
triple per component (texcrd/normal indices may be absent) plus a material slot
id (0..63). Flat triangle normals are recomputed on update (reference mesh.cpp).

Generators reproduce the behavior of ``World::generateMesh`` specializations
(reference world.cpp:129-560) — cube, N-sided plane, UV-/ico-sphere, cone,
cylinder, torus — as vectorized NumPy constructions.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.hostmath import normalize

NO_INDEX = -1


class Mesh:
    """Indexed triangle mesh in object space (NumPy, float32/int32)."""

    def __init__(
        self,
        name: str = "mesh",
        vertices: Optional[np.ndarray] = None,
        texcrds: Optional[np.ndarray] = None,
        normals: Optional[np.ndarray] = None,
        tri_v: Optional[np.ndarray] = None,
        tri_t: Optional[np.ndarray] = None,
        tri_n: Optional[np.ndarray] = None,
        tri_mat: Optional[np.ndarray] = None,
    ):
        self.name = name
        self.vertices = np.zeros((0, 3), np.float32) if vertices is None else np.asarray(vertices, np.float32)
        self.texcrds = np.zeros((0, 2), np.float32) if texcrds is None else np.asarray(texcrds, np.float32)
        self.normals = np.zeros((0, 3), np.float32) if normals is None else np.asarray(normals, np.float32)
        self.tri_v = np.zeros((0, 3), np.int32) if tri_v is None else np.asarray(tri_v, np.int32)
        n_tri = len(self.tri_v)
        self.tri_t = np.full((n_tri, 3), NO_INDEX, np.int32) if tri_t is None else np.asarray(tri_t, np.int32)
        self.tri_n = np.full((n_tri, 3), NO_INDEX, np.int32) if tri_n is None else np.asarray(tri_n, np.int32)
        self.tri_mat = np.zeros(n_tri, np.int32) if tri_mat is None else np.asarray(tri_mat, np.int32)
        self.version = 0  # bumped on edit; device mirror rebuilds when stale

    # -- incremental builder API (reference Mesh::createVertex/... mesh.hpp:30-50) --
    def create_vertex(self, v) -> int:
        self.vertices = np.vstack([self.vertices, np.asarray(v, np.float32)[None]])
        self.touch()
        return len(self.vertices) - 1

    def create_texcrd(self, t) -> int:
        self.texcrds = np.vstack([self.texcrds, np.asarray(t, np.float32)[None]])
        self.touch()
        return len(self.texcrds) - 1

    def create_normal(self, n) -> int:
        self.normals = np.vstack([self.normals, np.asarray(n, np.float32)[None]])
        self.touch()
        return len(self.normals) - 1

    def create_triangle(self, v_idx, t_idx=None, n_idx=None, material_id: int = 0) -> int:
        self.tri_v = np.vstack([self.tri_v, np.asarray(v_idx, np.int32)[None]])
        t = np.full(3, NO_INDEX, np.int32) if t_idx is None else np.asarray(t_idx, np.int32)
        n = np.full(3, NO_INDEX, np.int32) if n_idx is None else np.asarray(n_idx, np.int32)
        self.tri_t = np.vstack([self.tri_t, t[None]])
        self.tri_n = np.vstack([self.tri_n, n[None]])
        self.tri_mat = np.append(self.tri_mat, np.int32(material_id))
        self.touch()
        return len(self.tri_v) - 1

    def touch(self) -> None:
        self.version += 1

    @property
    def triangle_count(self) -> int:
        return len(self.tri_v)

    def flat_normals(self) -> np.ndarray:
        """Per-triangle flat normals = normalize(cross(e1, e2)) (reference mesh_component.cpp)."""
        v0 = self.vertices[self.tri_v[:, 0]]
        e1 = self.vertices[self.tri_v[:, 1]] - v0
        e2 = self.vertices[self.tri_v[:, 2]] - v0
        return normalize(np.cross(e1, e2)).astype(np.float32)

    def transform(self, transform) -> None:
        """Bake a transform into the vertex/normal data (reference Mesh::transform)."""
        self.vertices = transform.points_l2g(self.vertices).astype(np.float32)
        if len(self.normals):
            self.normals = transform.normals_l2g(self.normals).astype(np.float32)
        self.touch()

    def bounding_box(self) -> tuple[np.ndarray, np.ndarray]:
        if len(self.vertices) == 0:
            return np.zeros(3, np.float32), np.zeros(3, np.float32)
        return self.vertices.min(0), self.vertices.max(0)


# ---------------------------------------------------------------------------
# Procedural generators (reference world.cpp:129-560)
# ---------------------------------------------------------------------------

def generate_cube(name: str = "default cube") -> Mesh:
    """Unit cube centered at origin (reference world.cpp:129-167: 8 verts, 12 tris)."""
    v = np.array([
        [-0.5, +0.5, -0.5], [-0.5, +0.5, +0.5], [+0.5, +0.5, +0.5], [+0.5, +0.5, -0.5],
        [-0.5, -0.5, -0.5], [-0.5, -0.5, +0.5], [+0.5, -0.5, +0.5], [+0.5, -0.5, -0.5],
    ], np.float32)
    t = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)
    tri_v = np.array([
        [1, 2, 0], [3, 0, 2], [4, 7, 5], [6, 5, 7], [0, 3, 4], [7, 4, 3],
        [2, 1, 6], [5, 6, 1], [3, 2, 7], [6, 7, 2], [1, 0, 5], [4, 5, 0],
    ], np.int32)
    tri_t = np.array([[1, 2, 0], [3, 0, 2]] * 6, np.int32)
    return Mesh(name, vertices=v, texcrds=t, tri_v=tri_v, tri_t=tri_t)


def generate_plane(sides: int = 4, width: float = 1.0, height: float = 1.0,
                   name: str = "generated plane") -> Mesh:
    """Regular polygon fan in the XZ plane (reference world.cpp:168-201)."""
    if sides < 3:
        raise ValueError("plane needs at least 3 sides")
    i = np.arange(sides, dtype=np.float32)
    ang = (2 * np.pi / sides) * (i + 0.5)
    # vec2(1,0).Rotate(angle) -> (cos, sin); placed at (x, 0, z)*(width, 0, height)
    px, pz = np.cos(ang), np.sin(ang)
    v = np.stack([px * width, np.zeros(sides, np.float32), pz * height], axis=1).astype(np.float32)
    t = np.stack([px * 0.5 + 0.5, pz * 0.5 + 0.5], axis=1).astype(np.float32)
    k = np.arange(sides - 2, dtype=np.int32)
    tri_v = np.stack([np.zeros_like(k), k + 2, k + 1], axis=1)
    return Mesh(name, vertices=v, texcrds=t, tri_v=tri_v, tri_t=tri_v.copy())


def generate_uv_sphere(resolution: int = 16, normals: bool = True,
                       texcrds: bool = True, name: str = "generated sphere") -> Mesh:
    """Unit UV sphere (reference world.cpp:202-341): ``resolution`` longitudes,
    ``resolution/2`` latitude bands, pole fans."""
    if resolution < 4:
        raise ValueError("sphere needs resolution >= 4")
    n_lon = resolution
    n_lat = resolution // 2 - 1  # interior rings
    theta = np.pi / (resolution // 2) * (np.arange(n_lat) + 1)  # from +Y pole
    phi = 2 * np.pi / n_lon * np.arange(n_lon)
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    sp, cp = np.sin(phi)[None, :], np.cos(phi)[None, :]
    x = (st * sp).ravel()
    y = np.broadcast_to(ct, (n_lat, n_lon)).ravel()
    z = (st * cp).ravel()
    ring = np.stack([x, y, z], 1).astype(np.float32)
    verts = np.vstack([ring, [[0, 1, 0]], [[0, -1, 0]]]).astype(np.float32)
    top, bot = len(verts) - 2, len(verts) - 1

    def ring_idx(r, c):
        return r * n_lon + (c % n_lon)

    tris = []
    c = np.arange(n_lon)
    # top fan
    tris.append(np.stack([np.full(n_lon, top), ring_idx(0, c + 1), ring_idx(0, c)], 1))
    # quads between rings
    for r in range(n_lat - 1):
        a, b = ring_idx(r, c), ring_idx(r, c + 1)
        d, e = ring_idx(r + 1, c), ring_idx(r + 1, c + 1)
        tris.append(np.stack([a, b, d], 1))
        tris.append(np.stack([b, e, d], 1))
    # bottom fan
    tris.append(np.stack([np.full(n_lon, bot), ring_idx(n_lat - 1, c), ring_idx(n_lat - 1, c + 1)], 1))
    tri_v = np.vstack(tris).astype(np.int32)

    mesh = Mesh(name, vertices=verts, tri_v=tri_v)
    if normals:
        mesh.normals = verts.copy()
        mesh.tri_n = tri_v.copy()
    if texcrds:
        u = 0.5 + np.arctan2(verts[:, 0], verts[:, 2]) / (2 * np.pi)
        vt = 0.5 + np.arcsin(np.clip(verts[:, 1], -1, 1)) / np.pi
        mesh.texcrds = np.stack([u, vt], 1).astype(np.float32)
        mesh.tri_t = tri_v.copy()
    return mesh


def generate_icosphere(subdivisions: int = 2, normals: bool = True,
                       texcrds: bool = True, name: str = "generated sphere") -> Mesh:
    """Icosphere by midpoint subdivision of an icosahedron (reference world.cpp:202-341)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float32)
    verts = normalize(verts)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int32)
    for _ in range(max(0, subdivisions)):
        edge_mid: dict[tuple[int, int], int] = {}
        verts_list = [v for v in verts]

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = normalize((verts_list[a] + verts_list[b])[None])[0]
                verts_list.append(m.astype(np.float32))
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list, np.float32)
        faces = np.asarray(new_faces, np.int32)

    mesh = Mesh(name, vertices=verts, tri_v=faces)
    if normals:
        mesh.normals = verts.copy()
        mesh.tri_n = faces.copy()
    if texcrds:
        u = 0.5 + np.arctan2(verts[:, 0], verts[:, 2]) / (2 * np.pi)
        vt = 0.5 + np.arcsin(np.clip(verts[:, 1], -1, 1)) / np.pi
        mesh.texcrds = np.stack([u, vt], 1).astype(np.float32)
        mesh.tri_t = faces.copy()
    return mesh


def generate_cone(side_faces: int = 16, normals: bool = True, texcrds: bool = True,
                  name: str = "generated cone") -> Mesh:
    """Unit cone: apex at (0,1,0), unit-radius base at y=0 (reference world.cpp:342-398)."""
    if side_faces < 3:
        raise ValueError("cone needs at least 3 side faces")
    n = side_faces
    ang = 2 * np.pi / n * np.arange(n)
    rim = np.stack([np.sin(ang), np.zeros(n), np.cos(ang)], 1).astype(np.float32)
    verts = np.vstack([rim, [[0, 1, 0]]]).astype(np.float32)
    apex = n
    c = np.arange(n)
    side = np.stack([np.full(n, apex), c, (c + 1) % n], 1)
    k = np.arange(n - 2)
    base = np.stack([np.zeros_like(k), k + 1, k + 2], 1)
    tri_v = np.vstack([side, base]).astype(np.int32)
    mesh = Mesh(name, vertices=verts, tri_v=tri_v)
    if normals:
        # smooth side normals: rim normal tilted up by slope (unit cone slope = 45 deg)
        rim_n = normalize(rim + np.array([0, 1, 0], np.float32) * 0.0)
        side_n = normalize(rim_n + np.array([0, 1, 0], np.float32))
        mesh.normals = np.vstack([side_n, [[0, 1, 0]]]).astype(np.float32)
        tri_n = np.vstack([side, np.full_like(base, NO_INDEX)]).astype(np.int32)
        mesh.tri_n = tri_n
    if texcrds:
        u = np.concatenate([np.arange(n) / n, [0.5]]).astype(np.float32)
        vt = np.concatenate([np.zeros(n), [1.0]]).astype(np.float32)
        mesh.texcrds = np.stack([u, vt], 1)
        mesh.tri_t = tri_v.copy()
    return mesh


def generate_cylinder(faces: int = 16, normals: bool = True,
                      name: str = "generated cylinder") -> Mesh:
    """Unit-radius cylinder from y=-1 to y=+1 (reference world.cpp:399-480)."""
    if faces < 3:
        raise ValueError("cylinder needs at least 3 faces")
    n = faces
    ang = 2 * np.pi / n * np.arange(n)
    x, z = np.sin(ang), np.cos(ang)
    bottom = np.stack([x, -np.ones(n), z], 1)
    top = np.stack([x, np.ones(n), z], 1)
    verts = np.vstack([bottom, top]).astype(np.float32)
    c = np.arange(n)
    cn = (c + 1) % n
    side1 = np.stack([c, cn, n + c], 1)
    side2 = np.stack([cn, n + cn, n + c], 1)
    k = np.arange(n - 2)
    cap_bot = np.stack([np.zeros_like(k), k + 1, k + 2], 1)
    cap_top = np.stack([np.full_like(k, n), n + k + 2, n + k + 1], 1)
    tri_v = np.vstack([side1, side2, cap_bot, cap_top]).astype(np.int32)
    mesh = Mesh(name, vertices=verts, tri_v=tri_v)
    if normals:
        rim_n = np.stack([x, np.zeros(n), z], 1).astype(np.float32)
        mesh.normals = np.vstack([rim_n, rim_n]).astype(np.float32)
        tri_n = np.vstack([side1, side2,
                           np.full_like(cap_bot, NO_INDEX),
                           np.full_like(cap_top, NO_INDEX)]).astype(np.int32)
        mesh.tri_n = tri_n
    return mesh


def generate_torus(major_resolution: int = 32, minor_resolution: int = 16,
                   major_radius: float = 1.0, minor_radius: float = 0.25,
                   normals: bool = True, texcrds: bool = True,
                   name: str = "generated torus") -> Mesh:
    """Torus in the XZ plane (reference world.cpp:481-560)."""
    if major_resolution < 3 or minor_resolution < 3:
        raise ValueError("torus needs resolution >= 3")
    M, m = major_resolution, minor_resolution
    u = 2 * np.pi * np.arange(M) / M  # around main ring
    v = 2 * np.pi * np.arange(m) / m  # around tube
    cu, su = np.cos(u)[:, None], np.sin(u)[:, None]
    cv, sv = np.cos(v)[None, :], np.sin(v)[None, :]
    r = major_radius + minor_radius * cv
    x, y, z = (r * su), (minor_radius * sv) * np.ones_like(su), (r * cu)
    verts = np.stack([x.ravel(), y.ravel(), z.ravel()], 1).astype(np.float32)
    nx, ny, nz = cv * su, sv * np.ones_like(su), cv * cu
    norms = np.stack([nx.ravel(), ny.ravel(), nz.ravel()], 1).astype(np.float32)

    def idx(i, j):
        return (i % M) * m + (j % m)

    i, j = np.meshgrid(np.arange(M), np.arange(m), indexing="ij")
    a, b = idx(i, j).ravel(), idx(i + 1, j).ravel()
    cc, d = idx(i + 1, j + 1).ravel(), idx(i, j + 1).ravel()
    tri_v = np.vstack([np.stack([a, b, d], 1), np.stack([b, cc, d], 1)]).astype(np.int32)
    mesh = Mesh(name, vertices=verts, tri_v=tri_v)
    if normals:
        mesh.normals = norms
        mesh.tri_n = tri_v.copy()
    if texcrds:
        uu = (np.broadcast_to(u[:, None] / (2 * np.pi), (M, m))).ravel()
        vv = (np.broadcast_to(v[None, :] / (2 * np.pi), (M, m))).ravel()
        mesh.texcrds = np.stack([uu, vv], 1).astype(np.float32)
        mesh.tri_t = tri_v.copy()
    return mesh


GENERATORS = {
    "cube": generate_cube,
    "plane": generate_plane,
    "sphere": generate_uv_sphere,
    "uvsphere": generate_uv_sphere,
    "icosphere": generate_icosphere,
    "cone": generate_cone,
    "cylinder": generate_cylinder,
    "torus": generate_torus,
}
