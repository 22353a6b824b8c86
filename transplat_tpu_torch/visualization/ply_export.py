"""Export Gaussians to a 3DGS-standard binary .ply.

Counterpart of transplat_tpu/visualization/ply_export.py, in numpy: the
Gaussians recentred on their median and scaled to ~[-1, 1], turned z-up,
opacity through the inverse sigmoid, log scales, wxyz quaternions, the
f_dc / f_rest attribute layout, written little-endian float32.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _z_up_rotation() -> np.ndarray:
    rotation = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    a = np.radians(-45.0)
    adjustment = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
    return adjustment @ rotation


def quaternion_to_matrix(quaternions: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """(..., 4) xyzw quaternions -> (..., 3, 3) rotation matrices, float32."""
    q = np.asarray(quaternions, np.float32)
    i, j, k, r = np.moveaxis(q, -1, 0)
    two_s = np.float32(2.0) / (np.sum(q * q, axis=-1) + np.float32(eps))
    one = np.float32(1.0)
    o = np.stack(
        [
            one - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            one - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            one - two_s * (i * i + j * j),
        ],
        axis=-1,
    )
    return o.reshape(*o.shape[:-1], 3, 3)


def ply_rows(
    means: np.ndarray,  # (g, 3)
    scales: np.ndarray,  # (g, 3)
    rotations: np.ndarray,  # (g, 4) xyzw
    harmonics: np.ndarray,  # (g, 3, d_sh)
    opacities: np.ndarray,  # (g,)
) -> tuple[list[str], np.ndarray]:
    """The .ply's property names and its (g, properties) little-endian float32 rows."""
    means = np.asarray(means, np.float32)
    scales = np.asarray(scales, np.float32)
    rotations = np.asarray(rotations, np.float32)
    harmonics = np.asarray(harmonics, np.float32)
    opacities = np.asarray(opacities, np.float32)

    # Shift so the median Gaussian is at the origin; rescale to ~[-1, 1].
    means = means - np.median(means, axis=0)
    scale_factor = np.quantile(np.abs(means), 0.95, axis=0).max()
    means = means / scale_factor
    scales = scales / scale_factor

    rotation = _z_up_rotation()
    means = means @ rotation.T

    # Rotate the quaternions by composing with the world rotation.
    r_new = rotation[None] @ quaternion_to_matrix(rotations)
    rotations_wxyz = _matrix_to_quaternion_wxyz(r_new)

    f_dc = harmonics[..., 0]  # (g, 3)
    f_rest = harmonics[..., 1:].reshape(len(means), -1)

    fields = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )

    eps = 1e-8
    inv_sigmoid_opacity = np.log(np.clip(opacities, eps, 1 - eps) / np.clip(1 - opacities, eps, 1 - eps))
    data = np.concatenate(
        [
            means,
            np.zeros_like(means),
            f_dc,
            f_rest,
            inv_sigmoid_opacity[:, None],
            np.log(np.clip(scales, eps, None)),
            rotations_wxyz,
        ],
        axis=1,
    ).astype("<f4")
    return fields, data


def export_ply(
    means: np.ndarray,  # (g, 3)
    scales: np.ndarray,  # (g, 3)
    rotations: np.ndarray,  # (g, 4) xyzw
    harmonics: np.ndarray,  # (g, 3, d_sh)
    opacities: np.ndarray,  # (g,)
    path: str | Path,
) -> None:
    fields, data = ply_rows(means, scales, rotations, harmonics, opacities)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(data)}\n"
        + "".join(f"property float {name}\n" for name in fields)
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())


def read_ply(path: str | Path) -> tuple[list[str], np.ndarray]:
    """(property names, (n, properties) float32) of a .ply written by export_ply."""
    raw = Path(path).read_bytes()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    lines = raw[:end].decode("ascii").splitlines()
    if lines[:2] != ["ply", "format binary_little_endian 1.0"]:
        raise ValueError(f"{path}: not a binary little-endian .ply")
    count = next(int(x.split()[2]) for x in lines if x.startswith("element vertex "))
    names = [x.split()[2] for x in lines if x.startswith("property float ")]
    return names, np.frombuffer(raw[end:], "<f4").reshape(count, len(names))


def _matrix_to_quaternion_wxyz(r: np.ndarray) -> np.ndarray:
    """(g, 3, 3) -> (g, 4) wxyz quaternions, each from the branch of the
    largest of the trace and the diagonal, in float32."""
    m = np.asarray(r, np.float32)
    one, two, quarter = np.float32(1.0), np.float32(2.0), np.float32(0.25)
    m00, m11, m22 = m[:, 0, 0], m[:, 1, 1], m[:, 2, 2]
    tr = np.trace(m, axis1=1, axis2=2)
    with np.errstate(invalid="ignore", divide="ignore"):
        s0 = np.sqrt(tr + one) * two
        s1 = np.sqrt(one + m00 - m11 - m22) * two
        s2 = np.sqrt(one + m11 - m00 - m22) * two
        s3 = np.sqrt(one + m22 - m00 - m11) * two
        cases = [
            (quarter * s0, (m[:, 2, 1] - m[:, 1, 2]) / s0, (m[:, 0, 2] - m[:, 2, 0]) / s0, (m[:, 1, 0] - m[:, 0, 1]) / s0),
            ((m[:, 2, 1] - m[:, 1, 2]) / s1, quarter * s1, (m[:, 0, 1] + m[:, 1, 0]) / s1, (m[:, 0, 2] + m[:, 2, 0]) / s1),
            ((m[:, 0, 2] - m[:, 2, 0]) / s2, (m[:, 0, 1] + m[:, 1, 0]) / s2, quarter * s2, (m[:, 1, 2] + m[:, 2, 1]) / s2),
            ((m[:, 1, 0] - m[:, 0, 1]) / s3, (m[:, 0, 2] + m[:, 2, 0]) / s3, (m[:, 1, 2] + m[:, 2, 1]) / s3, quarter * s3),
        ]
    branch = np.where(tr > 0, 0, np.where((m00 > m11) & (m00 > m22), 1, np.where(m11 > m22, 2, 3)))
    q = np.zeros((len(m), 4), np.float32)
    for b, case in enumerate(cases):
        sel = branch == b
        q[sel] = np.stack(case, axis=-1)[sel]
    return q
