"""Camera trajectories (wobble, interpolation, spin) in numpy.

Counterpart of transplat_tpu/visualization/trajectory.py: the rotation
interpolation follows the SO(3) log / exp map.
"""

from __future__ import annotations

import numpy as np


def generate_wobble_transformation(
    radius: np.ndarray, t: np.ndarray, num_rotations: int = 1, scale_radius_with_t: bool = True
) -> np.ndarray:
    """(..., T, 4, 4) circular translations in the image plane."""
    radius = np.asarray(radius)[..., None]
    t = np.asarray(t)
    if scale_radius_with_t:
        radius = radius * t
    tf = np.broadcast_to(np.eye(4, dtype=np.float32), (*radius.shape, 4, 4)).copy()
    tf[..., 0, 3] = np.sin(2 * np.pi * num_rotations * t) * radius
    tf[..., 1, 3] = -np.cos(2 * np.pi * num_rotations * t) * radius
    return tf


def generate_wobble(extrinsics: np.ndarray, radius, t) -> np.ndarray:
    tf = generate_wobble_transformation(radius, t)
    return np.asarray(extrinsics)[..., None, :, :] @ tf


def _so3_log(r: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos)
    if theta < 1e-8:
        return np.zeros(3)
    w = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]) / (2.0 * np.sin(theta))
    return w * theta


def _so3_exp(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    if theta < 1e-8:
        return np.eye(3)
    k = w / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


def interpolate_extrinsics(initial: np.ndarray, final: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Geodesic rotation and linear translation between two cameras. t: (T,)."""
    r0, r1 = initial[:3, :3], final[:3, :3]
    p0, p1 = initial[:3, 3], final[:3, 3]
    w = _so3_log(r1 @ r0.T)
    out = []
    for ti in np.asarray(t):
        e = np.eye(4, dtype=np.float32)
        e[:3, :3] = _so3_exp(w * ti) @ r0
        e[:3, 3] = (1 - ti) * p0 + ti * p1
        out.append(e)
    return np.stack(out)


def interpolate_intrinsics(initial: np.ndarray, final: np.ndarray, t: np.ndarray) -> np.ndarray:
    t = np.asarray(t)[:, None, None]
    return (1 - t) * initial[None] + t * final[None]


def generate_spin(num_frames: int, elevation_deg: float = 10.0, radius: float = 2.0) -> np.ndarray:
    """Orbiting cameras that look at the origin."""
    angles = np.linspace(0, 2 * np.pi, num_frames, endpoint=False)
    el = np.radians(elevation_deg)
    out = []
    for a in angles:
        cam_pos = radius * np.array([np.cos(a) * np.cos(el), np.sin(el), np.sin(a) * np.cos(el)])
        forward = -cam_pos / np.linalg.norm(cam_pos)
        right = np.cross(np.array([0.0, 1.0, 0.0]), forward)
        right /= np.linalg.norm(right)
        up = np.cross(forward, right)
        e = np.eye(4, dtype=np.float32)
        e[:3, 0], e[:3, 1], e[:3, 2], e[:3, 3] = right, up, forward, cam_pos
        out.append(e)
    return np.stack(out)
