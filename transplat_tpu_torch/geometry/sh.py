"""Real spherical harmonics: evaluation and rotation (degrees 0..4).

Counterpart of transplat_tpu/geometry/sh.py: the graphics SH basis of the
INRIA 3DGS rasterizer, and exact per-degree rotation matrices from the
Ivanic-Ruedenberg recursion (with published errata).
"""

from __future__ import annotations

import numpy as np
import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def _basis_l0(d):
    return torch.full(d.shape[:-1] + (1,), _C0, dtype=d.dtype, device=d.device)


def _basis_l1(d):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([-_C1 * y, _C1 * z, -_C1 * x], dim=-1)


def _basis_l2(d):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack(
        [
            _C2[0] * x * y,
            _C2[1] * y * z,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * x * z,
            _C2[4] * (xx - yy),
        ],
        dim=-1,
    )


def _basis_l3(d):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack(
        [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * x * y * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ],
        dim=-1,
    )


def _basis_l4(d):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack(
        [
            _C4[0] * x * y * (xx - yy),
            _C4[1] * y * z * (3.0 * xx - yy),
            _C4[2] * x * y * (7.0 * zz - 1.0),
            _C4[3] * y * z * (7.0 * zz - 3.0),
            _C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            _C4[5] * x * z * (7.0 * zz - 3.0),
            _C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            _C4[7] * x * z * (xx - 3.0 * yy),
            _C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ],
        dim=-1,
    )


def num_sh_coeffs(degree: int) -> int:
    """Coefficients of a degree-`degree` expansion: (degree + 1)^2."""
    return (degree + 1) ** 2


_BASIS_FNS = (_basis_l0, _basis_l1, _basis_l2, _basis_l3, _basis_l4)


def sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """Degree-`degree` basis values at unit directions (..., 3) -> (..., 2l+1)."""
    return _BASIS_FNS[degree](dirs)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH coefficients (..., C, n) at unit directions (..., 3) -> (..., C).

    Does NOT add the 3DGS ``+ 0.5`` color offset; the rasterizer does.
    """
    degree = int(np.sqrt(sh.shape[-1])) - 1
    basis = torch.cat([sh_basis(l, dirs) for l in range(degree + 1)], dim=-1)
    return torch.matmul(sh, basis.unsqueeze(-1)).squeeze(-1)


def _degree1_rotation(rotations: torch.Tensor) -> torch.Tensor:
    """Rotation of the degree-1 real SH basis (y, z, x): permuted R."""
    perm = [1, 2, 0]
    return rotations[..., perm, :][..., :, perm]


def _ivanic_next_degree(l: int, r1: torch.Tensor, d_prev: torch.Tensor) -> torch.Tensor:
    """Build the degree-l real SH rotation from the degree-(l-1) one.

    r1: (..., 3, 3) degree-1 rotation in (y, z, x) basis, (i, j) at [i+1, j+1];
    d_prev: (..., 2l-1, 2l-1), (m, n) at [m + l - 1, n + l - 1].
    Returns (..., 2l+1, 2l+1).
    """

    def r(i, j):
        return r1[..., i + 1, j + 1]

    def dp(a, b):
        return d_prev[..., a + l - 1, b + l - 1]

    def P(i, a, b):
        if b == l:
            return r(i, 1) * dp(a, l - 1) - r(i, -1) * dp(a, -l + 1)
        if b == -l:
            return r(i, 1) * dp(a, -l + 1) + r(i, -1) * dp(a, l - 1)
        return r(i, 0) * dp(a, b)

    rows = []
    for m in range(-l, l + 1):
        row = []
        for n in range(-l, l + 1):
            denom = float((l + n) * (l - n)) if abs(n) < l else float(2 * l * (2 * l - 1))
            delta_m0 = 1.0 if m == 0 else 0.0
            u_c = np.sqrt((l + m) * (l - m) / denom)
            v_c = (
                0.5
                * np.sqrt((1.0 + delta_m0) * (l + abs(m) - 1) * (l + abs(m)) / denom)
                * (1.0 - 2.0 * delta_m0)
            )
            w_c = -0.5 * np.sqrt((l - abs(m) - 1) * (l - abs(m)) / denom) * (1.0 - delta_m0)

            term = torch.zeros_like(r1[..., 0, 0])
            if u_c != 0.0:
                term = term + u_c * P(0, m, n)
            if v_c != 0.0:
                if m == 0:
                    v_val = P(1, 1, n) + P(-1, -1, n)
                elif m > 0:
                    v_val = P(1, m - 1, n) * np.sqrt(1.0 + (1.0 if m == 1 else 0.0)) - P(
                        -1, -m + 1, n
                    ) * (1.0 - (1.0 if m == 1 else 0.0))
                else:
                    v_val = P(1, m + 1, n) * (1.0 - (1.0 if m == -1 else 0.0)) + P(
                        -1, -m - 1, n
                    ) * np.sqrt(1.0 + (1.0 if m == -1 else 0.0))
                term = term + v_c * v_val
            if w_c != 0.0:
                if m > 0:
                    w_val = P(1, m + 1, n) + P(-1, -m - 1, n)
                else:
                    w_val = P(1, m - 1, n) - P(-1, -m + 1, n)
                term = term + w_c * w_val
            row.append(term)
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


# Per-degree sign flips relating the Ivanic basis (no Condon-Shortley phase)
# to the graphics basis above: sign(m) = (-1)^|m|.
_SIGNS = tuple(
    np.asarray([(-1.0) ** abs(m) for m in range(-l, l + 1)], np.float32) for l in range(5)
)


def sh_rotation_matrices(degree: int, rotations: torch.Tensor) -> list[torch.Tensor]:
    """Per-degree rotation matrices [D_0, ..., D_degree] in the graphics basis.

    Satisfies: eval with coeffs (D_l @ c_l) at d == eval with c_l at R^T d.
    """
    mats = [torch.ones(rotations.shape[:-2] + (1, 1), dtype=rotations.dtype, device=rotations.device)]
    if degree >= 1:
        d = _degree1_rotation(rotations)
        mats.append(d)
        for l in range(2, degree + 1):
            d = _ivanic_next_degree(l, mats[1], d)
            mats.append(d)
    out = []
    for l, d in enumerate(mats):
        s = torch.as_tensor(_SIGNS[l], dtype=d.dtype, device=d.device)
        out.append(d * s[:, None] * s[None, :])
    return out


def rotate_sh(sh: torch.Tensor, rotations: torch.Tensor) -> torch.Tensor:
    """Rotate SH coefficients (..., n) by rotations (..., 3, 3) (broadcasting).

    Returns (..., n) with eval(rotated, d) == eval(sh, R^T d).
    """
    degree = int(np.sqrt(sh.shape[-1])) - 1
    mats = sh_rotation_matrices(degree, rotations)
    out = []
    for l in range(degree + 1):
        block = sh[..., l**2 : (l + 1) ** 2]
        out.append(torch.matmul(mats[l], block.unsqueeze(-1)).squeeze(-1))
    return torch.cat(out, dim=-1)
