"""Per-Gaussian screen-space preparation for the tile rasterizer.

Counterpart of transplat_tpu/ops/rasterizer/projection.py, batched over
views instead of vmapped. The EWA-splatting conventions are kept exactly:

  * camera-space cull at z <= 0.2
  * perspective Jacobian with tan-fov clamping at 1.3x the frustum
  * +0.3 screen-space low-pass on the 2D covariance diagonal
  * radius = ceil(3 * sqrt(max eigenvalue of 2D covariance))
  * color = max(SH(view direction) + 0.5, 0)
  * integer pixel centres and a circular radius cutoff (gaussian_alpha)

Two routes give the render its depth-sort keys, geometry rows, colours and
radii. Where every input is float32 on the card and no gradient is recorded
(serving, evaluation, media), one launch of csrc/project.cu
(`project_rows_kernel`, counted as `project`); otherwise (the CPU, training's
autograd) the plain chain, differentiable: `project_views` ->
`project_gaussians` -> `eval_sh`, then `pack_rows` (`project_rows_plain`
gives the kernel's outputs this way, for the tests).
`projection_kernel_applies` decides; api.py `render` counts the two as
`render.project.fused` / `render.project.plain`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ... import kernels
from ...geometry.projection import get_fov
from ...geometry.sh import eval_sh


ALPHA_MIN = 1.0 / 255.0  # below it a Gaussian does not touch the pixel
ALPHA_MAX = 0.99  # cap of a single Gaussian's alpha

# The geometry rows' columns (float32, 8 per Gaussian so a row is two 16-byte
# loads), as binning and compositing read them.
MEAN_X, MEAN_Y, CONIC_A, CONIC_B, CONIC_C, RADIUS, OPACITY = range(7)
GFEAT_WIDTH = 8


class ProjectedGaussians(NamedTuple):
    """Screen-space Gaussian data, (B, G, ...) for B views."""

    mean2d: torch.Tensor  # (B, G, 2) pixel coordinates
    depth: torch.Tensor  # (B, G) camera-space z
    conic: torch.Tensor  # (B, G, 3) inverse 2D covariance (a, b, c) of [[a,b],[b,c]]
    radius: torch.Tensor  # (B, G) screen-space radius in pixels (0 for culled)
    rgb: torch.Tensor  # (B, G, 3) view-dependent color (SH evaluated)
    opacity: torch.Tensor  # (B, G)
    valid: torch.Tensor  # (B, G) bool

    def view(self, i: int) -> "ProjectedGaussians":
        """The (G, ...) slice of view i."""
        return ProjectedGaussians(*(f[i] for f in self))


def project_gaussians(
    means: torch.Tensor,  # (B, G, 3) world positions
    covariances: torch.Tensor,  # (B, G, 3, 3)
    sh: torch.Tensor,  # (B, G, 3, n_sh)
    opacities: torch.Tensor,  # (B, G)
    extrinsics: torch.Tensor,  # (B, 4, 4) camera-to-world
    tan_fovx: torch.Tensor,  # (B,)
    tan_fovy: torch.Tensor,  # (B,)
    image_shape: tuple[int, int],
    near_cull: float = 0.2,
    eps: float = 1e-6,
) -> ProjectedGaussians:
    """Project world-space Gaussians into B cameras (symmetric frustum:
    focal length from the field of view, principal point at the image centre)."""
    h, w = image_shape
    w2c = torch.linalg.inv(extrinsics)
    rot = w2c[:, :3, :3]
    trans = w2c[:, :3, 3]

    t = torch.matmul(means, rot.transpose(-1, -2)) + trans[:, None, :]  # (B, G, 3)
    depth = t[..., 2]
    valid = depth > near_cull

    fx = ((0.5 * w) / tan_fovx)[:, None]
    fy = ((0.5 * h) / tan_fovy)[:, None]
    cx = (w - 1.0) / 2.0
    cy = (h - 1.0) / 2.0

    z = torch.where(valid, depth, torch.ones_like(depth))
    mean2d = torch.stack([fx * t[..., 0] / z + cx, fy * t[..., 1] / z + cy], dim=-1)

    # EWA: 2D covariance = J W Sigma W^T J^T with a frustum-clamped Jacobian.
    limx = (1.3 * tan_fovx)[:, None]
    limy = (1.3 * tan_fovy)[:, None]
    txtz = torch.clamp(t[..., 0] / z, -limx, limx)
    tytz = torch.clamp(t[..., 1] / z, -limy, limy)
    tx = txtz * z
    ty = tytz * z

    # Rows of J W: u = (fx/z) r0 - (fx tx/z^2) r2, v = (fy/z) r1 - (fy ty/z^2) r2.
    pu = fx / z
    qu = -fx * tx / (z * z)
    pv = fy / z
    qv = -fy * ty / (z * z)
    u = [pu * rot[:, 0, k, None] + qu * rot[:, 2, k, None] for k in range(3)]
    v = [pv * rot[:, 1, k, None] + qv * rot[:, 2, k, None] for k in range(3)]
    s = [[covariances[..., k, l] for l in range(3)] for k in range(3)]

    def quad(x, y):  # x^T Sigma y, Sigma symmetric
        return sum(x[k] * sum(s[k][l] * y[l] for l in range(3)) for k in range(3))

    a = quad(u, u) + 0.3
    b = quad(u, v)
    c = quad(v, v) + 0.3

    det = a * c - b * b
    valid = valid & (det > 0.0)
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))
    radius = torch.where(valid, radius, torch.zeros_like(radius))

    campos = extrinsics[:, None, :3, 3]
    dirs = means - campos
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=eps)
    rgb = torch.clamp(eval_sh(sh, dirs) + 0.5, min=0.0)

    return ProjectedGaussians(
        mean2d=mean2d, depth=depth, conic=conic, radius=radius, rgb=rgb,
        opacity=opacities, valid=valid,
    )


def project_views(
    extrinsics, intrinsics, near, means, covariances, sh, opacities,
    image_shape: tuple[int, int], scale_invariant: bool = True,
) -> ProjectedGaussians:
    """Project (B, G) Gaussians into B cameras (optionally rescaled by 1/near)."""
    if scale_invariant:
        scale = 1.0 / near
        extrinsics = extrinsics.clone()
        extrinsics[:, :3, 3] = extrinsics[:, :3, 3] * scale[:, None]
        covariances = covariances * (scale**2)[:, None, None, None]
        means = means * scale[:, None, None]
    fov = get_fov(intrinsics)
    return project_gaussians(
        means, covariances, sh, opacities, extrinsics,
        torch.tan(0.5 * fov[:, 0]), torch.tan(0.5 * fov[:, 1]), image_shape,
    )


def live_mask(proj: ProjectedGaussians) -> torch.Tensor:
    """The Gaussians the tiles see: valid, radius > 0."""
    return proj.valid & (proj.radius > 0.0)


def depth_keys(proj: ProjectedGaussians, live: torch.Tensor) -> torch.Tensor:
    """The depth sort's keys (B, G): a live Gaussian's depth, +inf for the rest."""
    return torch.where(live, proj.depth, torch.full_like(proj.depth, float("inf")))


def geometry_rows(proj: ProjectedGaussians, live: torch.Tensor) -> torch.Tensor:
    """The unsorted geometry rows (B, G, GFEAT_WIDTH): a dead row has radius
    and opacity 0 and its mean at 1e9, and keeps its conic."""
    big = torch.full_like(proj.depth, 1e9)
    zero = torch.zeros_like(proj.depth)
    return torch.stack(
        [
            torch.where(live, proj.mean2d[..., 0], big),
            torch.where(live, proj.mean2d[..., 1], big),
            proj.conic[..., 0],
            proj.conic[..., 1],
            proj.conic[..., 2],
            torch.where(live, proj.radius, zero),
            torch.where(live, proj.opacity, zero),
            zero,
        ],
        dim=-1,
    )


def pack_rows(proj: ProjectedGaussians) -> tuple[torch.Tensor, torch.Tensor]:
    """Projected Gaussians -> the depth sort's keys (B, G) and unsorted
    geometry rows (B, G, GFEAT_WIDTH), as the kernel writes them."""
    live = live_mask(proj)
    return depth_keys(proj, live), geometry_rows(proj, live)


def views_per_set(cameras: int, sets: int) -> int:
    """Cameras that see each of `sets` Gaussian sets: camera i sees set i // views."""
    if sets < 1 or cameras % sets:
        raise ValueError(f"{cameras} cameras do not divide among {sets} Gaussian sets")
    return cameras // sets


def repeat_sets(x: torch.Tensor, views: int) -> torch.Tensor:
    """(b, ...) -> (b * views, ...): each set once for each of its cameras."""
    if views == 1:
        return x
    return x[:, None].expand(x.shape[0], views, *x.shape[1:]).reshape(x.shape[0] * views, *x.shape[1:])


def sh_degree(sh: torch.Tensor) -> int | None:
    """The SH degree of coefficients (..., 3, n), or None where n is no (d + 1)^2 for d in 0..4."""
    n = sh.shape[-1] if sh.ndim >= 2 and sh.shape[-2] == 3 else 0
    return {1: 0, 4: 1, 9: 2, 16: 3, 25: 4}.get(n)


def projection_kernel_applies(*tensors: torch.Tensor | None, sh: torch.Tensor) -> bool:
    """Whether a render's projection takes csrc/project.cu: the kernels'
    route (`kernels.kernel_route`) for every tensor given, and SH of a degree
    0-4."""
    return kernels.kernel_route(*tensors, sh) and sh_degree(sh) is not None


def project_rows_plain(
    extrinsics, intrinsics, near, means, covariances, sh, opacities,
    image_shape: tuple[int, int], scale_invariant: bool = True, with_color: bool = True,
):
    """The projection's outputs by the plain chain: B = b * views cameras
    (extrinsics (B, 4, 4), intrinsics (B, 3, 3), near (B,)), b Gaussian sets
    (means (b, G, 3), covariances (b, G, 3, 3), sh (b, G, 3, n), opacities
    (b, G)), camera i seeing set i // views. Returns keys (B, G), rows (B, G,
    8) (`pack_rows`), colours (B, G, 3) (None without `with_color`) and radii
    (B, G), 0 where not valid."""
    views = views_per_set(extrinsics.shape[0], means.shape[0])
    proj = project_views(
        extrinsics, intrinsics, near, *(repeat_sets(x, views) for x in (means, covariances, sh, opacities)),
        image_shape, scale_invariant,
    )
    keys, rows = pack_rows(proj)
    radii = torch.where(proj.valid, proj.radius, torch.zeros_like(proj.radius))
    return keys, rows, proj.rgb if with_color else None, radii


def project_rows_kernel(
    extrinsics, intrinsics, near, means, covariances, sh, opacities,
    image_shape: tuple[int, int], scale_invariant: bool = True, with_color: bool = True,
):
    """project_rows_plain's outputs in one launch of csrc/project.cu (counted
    as `project`). Every input a contiguous float32 CUDA tensor; without
    `with_color` the SH are not read (the caller composites its own feature)."""
    h, w = image_shape
    cams, sets = extrinsics.shape[0], means.shape[0]
    g = means.shape[1] if means.ndim == 3 else -1
    degree = sh_degree(sh)
    want = {
        "extrinsics": (extrinsics, (cams, 4, 4)), "intrinsics": (intrinsics, (cams, 3, 3)), "near": (near, (cams,)),
        "means": (means, (sets, g, 3)), "covariances": (covariances, (sets, g, 3, 3)),
        "sh": (sh, (sets, g, 3, sh.shape[-1])), "opacities": (opacities, (sets, g)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"project_rows_kernel: {name} has shape {tuple(t.shape)}, expected {shape}")
    if degree is None:
        raise ValueError(f"project_rows_kernel: {sh.shape[-1]} SH coefficients (the kernel takes degrees 0-4)")
    views = views_per_set(cams, sets)
    if sets > 65535:
        raise ValueError(f"project_rows_kernel: {sets} Gaussian sets (at most 65535)")
    for name, (t, _) in want.items():
        if t.dtype != torch.float32:
            raise ValueError(f"project_rows_kernel: {name} is {t.dtype}, expected torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"project_rows_kernel: {name} is not contiguous")
    for name, (t, _) in want.items():
        kernels.check_cuda_tensor(name, t, torch.float32)
    dev = means.device
    keys = torch.empty((cams, g), dtype=torch.float32, device=dev)
    rows = torch.empty((cams, g, GFEAT_WIDTH), dtype=torch.float32, device=dev)
    colors = torch.empty((cams, g, 3), dtype=torch.float32, device=dev) if with_color else None
    radii = torch.empty((cams, g), dtype=torch.float32, device=dev)
    kernels.call(
        "tp_project_gaussians", "project",
        extrinsics.data_ptr(), intrinsics.data_ptr(), near.data_ptr(), means.data_ptr(), covariances.data_ptr(),
        sh.data_ptr(), opacities.data_ptr(), keys.data_ptr(), rows.data_ptr(),
        colors.data_ptr() if with_color else None, radii.data_ptr(),
        sets, views, g, degree, h, w, int(scale_invariant),
    )
    return keys, rows, colors, radii


def gaussian_alpha(
    conic: torch.Tensor,
    mean2d: torch.Tensor,
    opacity: torch.Tensor,
    pixel_xy: torch.Tensor,
    radius: torch.Tensor | None = None,
    alpha_min: float = ALPHA_MIN,
    alpha_max: float = ALPHA_MAX,
) -> torch.Tensor:
    """Alpha of Gaussians at pixels (broadcasting): clamped at 0.99, zeroed
    below 1/255, for power > 0, and outside the circular radius cutoff."""
    dx = pixel_xy[..., 0] - mean2d[..., 0]
    dy = pixel_xy[..., 1] - mean2d[..., 1]
    power = -0.5 * (conic[..., 0] * dx * dx + conic[..., 2] * dy * dy) - conic[..., 1] * dx * dy
    alpha = torch.clamp(opacity * torch.exp(power), max=alpha_max)
    keep = (power <= 0.0) & (alpha >= alpha_min)
    if radius is not None:
        keep = keep & (dx * dx + dy * dy <= radius * radius)
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def pixel_centers(image_shape: tuple[int, int], device=None, dtype=torch.float32) -> torch.Tensor:
    """Integer pixel-centre coordinates (h, w, 2) in pixel units (x = col, y = row)."""
    h, w = image_shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=dtype, device=device),
        torch.arange(w, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([xs, ys], dim=-1)
