"""Epipolar sampling locality and reuse of the matcher's sampling coordinates.

    python -m transplat_tpu_torch.tools.analyze_sampling_locality [--h 64 --w 64 --d 128 --c 128 --points 4]
        [--out outputs/sampling_locality.json] [--device cuda|cpu]

Counterpart of scripts/analyze_sampling_locality.py, on the port's
geometry/epipolar.py: for the epipolar grids of a fixed camera pair (a
0.1 rad yaw and a 0.3 sideways step, focal 1.2 x the image side, D inverse
depth candidates between 1 and 100) it reports the statistics the JAX
script reports, under its keys: adjacent-pixel coordinate deltas per depth
candidate (small deltas: neighbouring queries read neighbouring memory),
adjacent-depth deltas along each pixel's epipolar segment, the share of
samples inside the frustum, the share of in-frustum samples whose 2x2
bilinear footprint stays inside one (8, 128) block of the value grid (the
JAX package's tile; the key keeps its name), and the bytes of per-sample
C-vector gathers against the hoisted S = K V^T product and scalar sampling
(the split of K5's inputs). They are properties of the coordinates, not of
a device: the CPU and the card give the same numbers up to float32 rounding.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..geometry.epipolar import epipolar_sample_grid, inverse_depth_candidates, relative_pose
from ..utils.stage_timing import add_device_arg, resolve_device


def camera_pair(h: int, w: int, angle: float = 0.1, tx: float = 0.3):
    """(pixel intrinsics, reference extrinsics, target extrinsics), float32 numpy."""
    intr = np.array([[1.2 * w, 0, 0.5 * w], [0, 1.2 * h, 0.5 * h], [0, 0, 1.0]], np.float32)
    e0 = np.eye(4, dtype=np.float32)
    c, s = np.cos(angle), np.sin(angle)
    e1 = np.array([[c, 0, s, tx], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], np.float32)
    return intr, e0, e1


def sampling_grid(h: int, w: int, d: int, device="cpu") -> np.ndarray:
    """(D, H*W, 2) sample locations in pixels of the target view."""
    intr, e0, e1 = (torch.from_numpy(a).to(device) for a in camera_pair(h, w))
    rel = relative_pose(e0, e1)
    disp = inverse_depth_candidates(torch.tensor(1.0, device=device), torch.tensor(100.0, device=device), d)
    grid01 = epipolar_sample_grid(intr, rel, 1.0 / disp, h, w)
    return grid01.cpu().numpy() * np.array([w - 1, h - 1], np.float32)


def locality(h: int, w: int, d: int, c: int, points: int, device="cpu") -> dict:
    px = sampling_grid(h, w, d, device)
    px_map = px.reshape(d, h, w, 2)
    dx = np.linalg.norm(px_map[:, :, 1:] - px_map[:, :, :-1], axis=-1)
    dy = np.linalg.norm(px_map[:, 1:] - px_map[:, :-1], axis=-1)
    adj_pixel = np.concatenate([dx.ravel(), dy.ravel()])
    dd = np.linalg.norm(px_map[1:] - px_map[:-1], axis=-1).ravel()
    x0, y0 = np.floor(px[..., 0]), np.floor(px[..., 1])
    same_tile = ((x0 % 128) <= 126) & ((y0 % 8) <= 6)
    inside = (px[..., 0] >= 0) & (px[..., 0] <= w - 1) & (px[..., 1] >= 0) & (px[..., 1] <= h - 1)
    # Per-sample gathers of C-vectors at 4 bilinear taps (float32) against one
    # (Q, C) x (C, HW) product whose operands are read once and Q*D*P scalar samples.
    q = h * w
    naive_bytes = q * d * points * 4 * c * 4
    hoisted_bytes = (q * c + c * q + q * q) * 4 + q * d * points * 4 * 4
    return {
        "adjacent_pixel_delta_px": {
            "mean": float(adj_pixel.mean()),
            "p50": float(np.percentile(adj_pixel, 50)),
            "p95": float(np.percentile(adj_pixel, 95)),
            "frac_below_1px": float((adj_pixel < 1.0).mean()),
            "frac_below_2px": float((adj_pixel < 2.0).mean()),
        },
        "adjacent_depth_delta_px": {
            "mean": float(dd.mean()),
            "p50": float(np.percentile(dd, 50)),
            "frac_below_1px": float((dd < 1.0).mean()),
        },
        "in_frustum_fraction": float(inside.mean()),
        "bilinear_footprint_single_vmem_tile_fraction": float((same_tile & inside).sum() / max(inside.sum(), 1)),
        "gather_traffic_bytes": int(naive_bytes),
        "hoisted_traffic_bytes": int(hoisted_bytes),
        "traffic_reduction_x": float(naive_bytes / hoisted_bytes),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--h", type=int, default=64)
    parser.add_argument("--w", type=int, default=64)
    parser.add_argument("--d", type=int, default=128)
    parser.add_argument("--c", type=int, default=128, help="feature channels")
    parser.add_argument("--points", type=int, default=4, help="deformable points")
    parser.add_argument("--out", default="outputs/sampling_locality.json")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device, "analyze_sampling_locality")
    stats = locality(args.h, args.w, args.d, args.c, args.points, device)
    print(json.dumps(stats, indent=2))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(stats, indent=2))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
