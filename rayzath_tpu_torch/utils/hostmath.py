"""Host-side (NumPy) 3D math: rotations, coordinate systems, TRS transforms.

Behavioral spec follows the reference engine's external Math library as used by
``RayZath/render_parts.cpp`` (CoordSystem/Transformation):

* ``rotation_xyz(rot)`` — rotate about X, then Y, then Z (``CoordSystem::applyRotation``,
  reference render_parts.cpp:52-57).
* ``rotation_look_at(rot)`` — rotate about Z, then X, then Y
  (``CoordSystem::lookAt``, reference render_parts.cpp:58-63).
* Axis matrices use the axes-rotation (clockwise-for-vectors) convention so that
  ``Transformation::lookInDirection`` (reference render_parts.cpp:94-101) with
  ``x = asin(dir.y)``, ``y = -atan2(dir.x, dir.z)`` yields a z-axis equal to ``dir``.

A coordinate system is stored as a 3x3 matrix whose COLUMNS are the x/y/z axes;
``forward(v) = M @ v`` mirrors ``CoordSystem::transformForward`` and
``backward(v) = M.T @ v`` mirrors ``transformBackward``.
"""
from __future__ import annotations

import numpy as np

Vec3 = np.ndarray  # shape (3,), float32


def vec3(x=0.0, y=0.0, z=0.0) -> Vec3:
    return np.array([x, y, z], dtype=np.float32)


def normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(n, 1e-20)


def _rx(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, s], [0, -s, c]], dtype=np.float32)


def _ry(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], dtype=np.float32)


def _rz(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], dtype=np.float32)


def rotation_xyz(rotation) -> np.ndarray:
    """Rotation matrix applying X, then Y, then Z rotation (columns = axes)."""
    rx, ry, rz = float(rotation[0]), float(rotation[1]), float(rotation[2])
    return (_rz(rz) @ _ry(ry) @ _rx(rx)).astype(np.float32)


def rotation_look_at(rotation) -> np.ndarray:
    """Rotation matrix applying Z, then X, then Y rotation (camera convention)."""
    rx, ry, rz = float(rotation[0]), float(rotation[1]), float(rotation[2])
    return (_ry(ry) @ _rx(rx) @ _rz(rz)).astype(np.float32)


def look_at_rotation(position, target, roll: float = 0.0) -> np.ndarray:
    """Euler rotation (x, y, z) looking from ``position`` toward ``target``.

    Mirrors ``Transformation::lookInDirection`` (reference render_parts.cpp:94-101).
    """
    d = normalize(np.asarray(target, np.float32) - np.asarray(position, np.float32))
    x_angle = float(np.arcsin(np.clip(d[1], -1.0, 1.0)))
    y_angle = float(-np.arctan2(d[0], d[2]))
    return np.array([x_angle, y_angle, roll], dtype=np.float32)


class Transform:
    """TRS transform mirroring the reference ``Transformation`` (render_parts.hpp).

    ``rot`` is the 3x3 coordinate-system matrix (columns = axes).
    Local->global point: ``M @ (v * scale) + position``.
    """

    __slots__ = ("position", "rotation", "scale", "rot")

    def __init__(self, position=(0, 0, 0), rotation=(0, 0, 0), scale=(1, 1, 1)):
        self.position = np.asarray(position, dtype=np.float32).copy()
        self.rotation = np.asarray(rotation, dtype=np.float32).copy()
        self.scale = np.asarray(scale, dtype=np.float32).copy()
        self.rot = rotation_xyz(self.rotation)

    def compose_with(self, outer: "Transform") -> "Transform":
        """Return self composed inside ``outer`` (reference Transformation::operator*=,
        render_parts.cpp:77-84): position is rotated by outer and offset; rotations
        and scales compose."""
        t = Transform()
        t.position = (outer.rot @ self.position) + outer.position
        t.rot = (outer.rot @ self.rot).astype(np.float32)
        t.scale = self.scale * outer.scale
        t.rotation = self.rotation  # euler no longer meaningful after composition
        return t

    def points_l2g(self, pts: np.ndarray) -> np.ndarray:
        """Transform points local->global: rotate(scale * p) + position."""
        return (pts * self.scale) @ self.rot.T + self.position

    def normals_l2g(self, nrm: np.ndarray) -> np.ndarray:
        """Transform normals local->global with inverse-transpose semantics
        (reference transformL2G: divide by scale then rotate, render_parts.cpp:110-114)."""
        return normalize((nrm / np.maximum(np.abs(self.scale), 1e-20) * np.sign(self.scale)) @ self.rot.T)

    def copy(self) -> "Transform":
        t = Transform(self.position, self.rotation, self.scale)
        t.rot = self.rot.copy()
        return t


def transform_matrices(tr) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(A_fwd[3,4], A_inv[3,4], N[3,3]) for a hostmath Transform:
    world = A_fwd[:, :3] @ obj + A_fwd[:, 3]; obj = A_inv[:, :3] @ world
    + A_inv[:, 3]; world normal ∝ N @ obj normal (reference normals_l2g
    semantics: divide by scale then rotate, render_parts.cpp:110-114)."""
    rot = np.asarray(tr.rot, np.float64)
    scale = np.asarray(tr.scale, np.float64)
    pos = np.asarray(tr.position, np.float64)
    s_safe = np.where(np.abs(scale) < 1e-20, 1e-20, scale)
    a_fwd = rot * scale[None, :]                    # rot @ diag(scale)
    a_inv_lin = (1.0 / s_safe)[:, None] * rot.T     # diag(1/s) @ rot.T
    b_inv = -a_inv_lin @ pos
    n_mat = rot * (np.sign(s_safe) / np.maximum(np.abs(s_safe), 1e-20))[None, :]
    fwd = np.concatenate([a_fwd, pos[:, None]], axis=1)
    inv = np.concatenate([a_inv_lin, b_inv[:, None]], axis=1)
    return (fwd.astype(np.float32), inv.astype(np.float32),
            n_mat.astype(np.float32))

