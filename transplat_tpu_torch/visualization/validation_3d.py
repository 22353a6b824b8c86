"""3D validation visuals: orthographic Gaussian projections and camera wires.

Counterpart of transplat_tpu/visualization/validation_3d.py. The orthographic
view is approximated as the JAX package does it: the camera moves far back
along its axis with a tiny field of view (0.1 deg: about 573x the view's
width), and the Gaussians render unscaled (`scale_invariant=False`) through
the port's `render`, so on the card the view runs the tile binning (K1) and
compositing (K3) kernels. `draw_cameras` draws on numpy images, as JAX's does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.projection import project
from ..model.types import Gaussians
from ..ops.rasterizer.api import RasterizeConfig, render
from .trajectory import generate_wobble


# The Trainer's three axis-aligned looks: (name, rotation of the camera).
AXIS_LOOKS = (
    ("xy", np.eye(3)),
    ("xz", np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0.0]])),
    ("yz", np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0.0]])),
)


def axis_looks(means: np.ndarray) -> tuple[list[tuple[str, np.ndarray]], float]:
    """The looks along AXIS_LOOKS through the centre of the 2-98 percentile
    box of `means` (G, 3), each camera one extent back from it: ([(name,
    float64 extrinsics)], the box's largest side + 1e-3)."""
    lo, hi = np.percentile(means, [2, 98], axis=0)
    center, extent = (lo + hi) / 2, float((hi - lo).max()) + 1e-3
    looks = []
    for name, rot in AXIS_LOOKS:
        e = np.eye(4)
        e[:3, :3] = rot
        e[:3, 3] = center - rot[:, 2] * extent
        looks.append((name, e))
    return looks, extent


def validation_wobble(cams: np.ndarray, n_frames: int = 14) -> np.ndarray:
    """The Trainer's wobble around context camera 0 of `cams` (v, 4, 4):
    radius a quarter of the distance from the first to the last context
    camera, t = 0.5 + 0.5 sin over one turn. (n_frames, 4, 4)."""
    t = np.sin(np.linspace(0.0, 2.0 * np.pi, n_frames, endpoint=False)) * 0.5 + 0.5
    radius = float(np.linalg.norm(cams[0, :3, 3] - cams[-1, :3, 3])) * 0.25 + 1e-3
    return generate_wobble(cams[0], radius, t)


def orthographic_cameras(extrinsics: torch.Tensor, width: float, height: float, near: float, far: float,
                         fov_degrees: float = 0.1):
    """(extrinsics, intrinsics, near, far) of the quasi-orthographic views of
    the (b, 4, 4) looks `extrinsics`, on their device: the camera moved back
    along its axis until a `fov_degrees` view is `width` wide. The numbers
    follow JAX's: the field of view, the distance and the focal lengths in
    float64, then the intrinsics and the move-back matrix cast to float32
    and multiplied onto the float32 looks."""
    dev, b = extrinsics.device, extrinsics.shape[0]
    tan_fov_x = np.tan(0.5 * np.radians(fov_degrees))
    distance = (0.5 * width) / tan_fov_x
    tan_fov_y = 0.5 * height / distance
    fx, fy = 0.5 / tan_fov_x, 0.5 / tan_fov_y
    intr = torch.tensor([[fx, 0, 0.5], [0, fy, 0.5], [0, 0, 1.0]], dtype=torch.float32, device=dev)
    move_back = torch.eye(4, dtype=torch.float32, device=dev)
    move_back[2, 3] = -distance
    return (
        extrinsics.to(torch.float32) @ move_back,
        intr.expand(b, 3, 3).contiguous(),
        torch.full((b,), near + distance, dtype=torch.float32, device=dev),
        torch.full((b,), far + distance, dtype=torch.float32, device=dev),
    )


def render_orthographic(
    gaussians: Gaussians,  # (b, G, ...) on the device to render on
    extrinsics: torch.Tensor,  # (b, 4, 4) look direction
    width: float,
    height: float,
    near: float,
    far: float,
    image_shape: tuple[int, int] = (256, 256),
    fov_degrees: float = 0.1,
    cfg: RasterizeConfig = RasterizeConfig(),
) -> torch.Tensor:
    """Quasi-orthographic render of the Gaussian cloud. Returns (b, h, w, 3)."""
    dev = gaussians.means.device
    extr, intr, near_t, far_t = orthographic_cameras(extrinsics.to(dev), width, height, near, far, fov_degrees)
    out = render(
        extr, intr, near_t, far_t, image_shape,
        torch.zeros((extr.shape[0], 3), dtype=torch.float32, device=dev),
        gaussians.means, gaussians.covariances, gaussians.harmonics, gaussians.opacities,
        scale_invariant=False, cfg=cfg,
    )
    return out.color


def draw_line(image: np.ndarray, p0, p1, color=(1.0, 0.0, 0.0)) -> None:
    """Draw a line segment (normalized [0, 1] coordinates) in place; points
    outside the image are clipped onto its border."""
    h, w = image.shape[:2]
    n = int(max(abs(p1[0] - p0[0]) * w, abs(p1[1] - p0[1]) * h, 1)) + 1
    ts = np.linspace(0.0, 1.0, n)
    xs = np.clip(((p0[0] + ts * (p1[0] - p0[0])) * w).astype(int), 0, w - 1)
    ys = np.clip(((p0[1] + ts * (p1[1] - p0[1])) * h).astype(int), 0, h - 1)
    image[ys, xs] = color


def draw_cameras(
    image: np.ndarray,
    extrinsics: np.ndarray,  # (n, 4, 4) cameras to draw
    view_extrinsics: np.ndarray,  # (4, 4) viewing camera
    view_intrinsics: np.ndarray,  # (3, 3)
    frustum_depth: float = 0.3,
    colors=((1.0, 0, 0), (0, 1.0, 0), (0, 0, 1.0), (1.0, 1.0, 0)),
) -> np.ndarray:
    """Overlay wireframe camera frusta onto an image. Returns a copy.

    The frusta's corners are built in float64 and projected in float32 on
    the CPU, as the JAX package does; a camera with a corner behind the
    viewing camera is not drawn."""
    out = np.asarray(image).copy()
    corners_cam = np.array([[0, 0, 0], [-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.5, 0.5, 1.0], [-0.5, 0.5, 1.0]]) * frustum_depth
    view_e = torch.as_tensor(np.asarray(view_extrinsics), dtype=torch.float32)
    view_k = torch.as_tensor(np.asarray(view_intrinsics), dtype=torch.float32)
    for ci, e in enumerate(np.asarray(extrinsics)):
        world = (e[:3, :3] @ corners_cam.T).T + e[:3, 3]
        xy, valid = project(torch.as_tensor(world, dtype=torch.float32), view_e, view_k)
        if not bool(valid.all()):
            continue
        xy = xy.numpy()
        color = colors[ci % len(colors)]
        apex, quad = xy[0], xy[1:]
        for i in range(4):
            draw_line(out, apex, quad[i], color)
            draw_line(out, quad[i], quad[(i + 1) % 4], color)
    return out
