"""Visual smoke test: spin a camera around random Gaussians and save frames.

Counterpart of scripts/test_splatter.py (the reference's
src/scripts/test_splatter.py): a few random Gaussians rendered along a
spinning trajectory through the port's `render` (K1 and K3 on the card),
with a check of the SH rotation on the way. Writes PNG frames and an mp4
(OpenCV's mp4v, as utils/image_io.py writes every video) under --output.

    python -m transplat_tpu_torch.tools.test_splatter [--frames 24] [--gaussians 8] [--resolution 128]
        [--output outputs/splatter] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..geometry.gaussians import build_covariance
from ..geometry.sh import rotate_sh
from ..model.types import Gaussians
from ..ops.rasterizer.api import render
from ..utils.image_io import save_image, save_video
from ..visualization.trajectory import generate_spin

INTRINSICS = ((1.2, 0.0, 0.5), (0.0, 1.2, 0.5), (0.0, 0.0, 1.0))


def random_gaussians(num: int, device, seed: int = 0) -> Gaussians:
    """(1, num) Gaussians drawn as the JAX script draws them (numpy, `seed`):
    means in [-0.5, 0.5]^3, scales 0.05-0.15, random rotations, SH degree 4
    with a DC term of 0.5-2.0, opacities 0.6-1.0."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-0.5, 0.5, (num, 3))
    scales = rng.uniform(0.05, 0.15, (num, 3))
    quats = rng.normal(size=(num, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    sh = rng.normal(size=(num, 3, 25)) * 0.2
    sh[:, :, 0] = rng.uniform(0.5, 2.0, (num, 3))
    opac = rng.uniform(0.6, 1.0, num)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    cov = build_covariance(t(scales), t(quats))
    return Gaussians(t(means)[None], cov[None], t(sh)[None], t(opac)[None])


def spin_cameras(frames: int, device) -> tuple[torch.Tensor, ...]:
    """(extrinsics, intrinsics, near, far) of `frames` views on a spin of radius 2."""
    extr = torch.as_tensor(generate_spin(frames, radius=2.0), dtype=torch.float32, device=device)
    intr = torch.tensor(INTRINSICS, dtype=torch.float32, device=device).expand(frames, 3, 3)
    return extr, intr, torch.full((frames,), 0.1, device=device), torch.full((frames,), 10.0, device=device)


def render_spin(gaussians: Gaussians, frames: int, resolution: int):
    """Every frame of the spin in one render call (unscaled, as the JAX
    script renders it): RenderOutput with colour (frames, r, r, 3)."""
    cams = spin_cameras(frames, gaussians.means.device)
    background = torch.zeros((frames, 3), device=gaussians.means.device)
    fields = (x.expand(frames, *x.shape[1:]) for x in gaussians)
    return render(*cams, (resolution, resolution), background, *fields, scale_invariant=False)


def check_sh_rotation(gaussians: Gaussians) -> float:
    """The identity rotation leaves the SH coefficients as they are; returns the largest change."""
    sh = gaussians.harmonics[0].reshape(-1, 25)
    rotated = rotate_sh(sh, torch.eye(3, device=sh.device).expand(sh.shape[0], 3, 3))
    err = float((rotated - sh).abs().max())
    if err > 1e-4:
        raise RuntimeError(f"SH rotation by the identity moved the coefficients by {err}")
    return err


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m transplat_tpu_torch.tools.test_splatter", description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--gaussians", type=int, default=8)
    parser.add_argument("--resolution", type=int, default=128)
    parser.add_argument("--output", default="outputs/splatter")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to render on the CPU")
    gaussians = random_gaussians(args.gaussians, torch.device(args.device))
    check_sh_rotation(gaussians)
    with torch.no_grad():
        out = render_spin(gaussians, args.frames, args.resolution)
    frames = out.color.clamp(0.0, 1.0).cpu().numpy()
    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(frames):
        save_image(frame, outdir / f"frame_{i:03d}.png")
    save_video(list(frames), outdir / "spin.mp4")
    print(f"wrote {len(frames)} frames and spin.mp4 to {outdir}, mean luminance {float(frames.mean()):.3f}, "
          f"radii>0: {int((out.radii > 0).sum())}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
