"""Cases and tolerances that the CPU tests and the card tests
(tests/test_torch_cuda.py) share: seeded inputs of the Gaussian adapter
stage and of the render's projection, a synthetic scene, a seeded LPIPS
state dict, and the checks that hold a kernel to its plain version.

Imports nothing of JAX, so the card tests collect it on a machine that has
only PyTorch (`pytest --noconftest`).
"""

from __future__ import annotations

import numpy as np
import torch

# Gradients are compared on values scaled to the gradient's largest entry.
# K6 (fixed-point sums), K8 and K2 repeat their plain versions' float32 sums
# in another order: 1e-5. K4 sums an entry's 256 pixels in another order than the
# plain version's chunked cumsum, 1 / (1 - alpha) reaches 100, and where T
# crosses 1e-4 the two forwards (sequential product vs cumprod) can gate an
# entry differently: 1e-4.
GRAD_TOL = {"deform": 1e-5, "bin": 1e-5, "composite": 1e-4}
# nvJPEG's chroma upsampling is not libjpeg's: a decode is held against the
# source pixels of the images its route encoded at quality 95, 4:2:0 (mean
# absolute error, of 1). Measured on an H100 machine (nvJPEG, 12.8 toolkit):
# 2.48-2.58 / 255 on chunks.panorama_frames; a decoder that shifts or
# swaps channels reads tens of levels.
JPEG_MAE_TOL = 3.0 / 255.0
# The staged encoder against the fused one on the card: the largest
# |staged - fused| / (1 + |fused|) over the Gaussians' tensors. Both run the
# same operations in the same order on one stream, so they agree bit for bit
# where every kernel repeats its bits from call to call.
STAGED_TOL = 1e-6


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def scaled_err(a, b) -> float:
    """Max abs error of `a` against `b`, both scaled to b's largest entry."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def assert_composite(a, b, label: str) -> tuple[float, float]:
    """The compositing kernel's `a` against its plain version's `b`: all
    values within 1e-5, but for the few pixels where the transmittance
    crosses the 1e-4 gate between two entries. There the kernel's running
    product and the plain version's chunked cumprod can disagree on whether
    one more entry counts; that entry adds at most T alpha c < 1e-4. So:
    at most 1e-4 of the values beyond 1e-5, none beyond 1e-4. Returns (max
    abs error, share beyond 1e-5)."""
    diff = (a.float() - b.float()).abs()
    err, share = float(diff.max()), float((diff > 1e-5).float().mean())
    assert err <= 1e-4 and share <= 1e-4, f"{label}: max abs err {err}, share beyond 1e-5 {share}"
    return err, share


def synthetic_scene(g: int, views: int, dev, seed: int):
    """g Gaussians in front of `views` cameras, a third of them needle-like."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-3, 3, g), rng.uniform(-3, 3, g), rng.uniform(2.0, 10.0, g)], 1)
    s = rng.uniform(0.003, 0.02, (g, 3))
    s[: g // 3, 0] *= 20.0
    q = rng.standard_normal((g, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    rot = np.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
         2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
         2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], 1,
    ).reshape(g, 3, 3)
    cov = rot @ (s[:, :, None] ** 2 * rot.transpose(0, 2, 1))
    t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    rep = lambda a: t(np.broadcast_to(a, (views,) + a.shape))  # noqa: E731
    extr = np.tile(np.eye(4), (views, 1, 1))
    extr[:, 0, 3] = np.linspace(-0.3, 0.3, views)
    intr = np.tile(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]), (views, 1, 1))
    cams = (t(extr), t(intr), torch.ones(views, device=dev), torch.full((views,), 100.0, device=dev))
    gs = (rep(means), rep(cov), rep(rng.standard_normal((g, 3, 4)) * 0.4), rep(rng.uniform(0.5 / 255, 0.9, g)))
    return cams, gs


def _rotation(rng, kind: str) -> np.ndarray:
    """A proper rotation: the identity, a turn of pi - 1e-3 about a random
    axis ("near_180"), or a random turn about a random axis."""
    if kind == "identity":
        return np.eye(3)
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    angle = np.pi - 1e-3 if kind == "near_180" else rng.uniform(0.0, np.pi)
    k = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]], [-axis[1], axis[0], 0.0]])
    return np.eye(3) + np.sin(angle) * k + (1.0 - np.cos(angle)) * k @ k


def adapter_case(dev, b: int, v: int, shape, degree: int, step: int, seed: int, planar: bool = True,
                 samples: int = 1):
    """Inputs of the encoder's stage 5 (model/encoder.py `adapt_stage`) at b
    x v views of `shape`, SH `degree`, `samples` Gaussians a pixel (and as
    many in the configuration's `gaussians_per_pixel`): cameras turned in
    turn by the identity, a turn of pi - 1e-3 and a random rotation;
    off-centre intrinsics with a skew; depths in [0.5, 50], densities in
    (0, 1) for each sample; raw
    channels N(0, 1), laid out as the encoder's (`planar`: one channel of
    consecutive pixels contiguous) or as rows; an opacity warm-up of 10
    steps from exponent 0.5 to 2, at `step`. Returns (EncoderCfg, the
    arguments of adapt_stage after the configuration)."""
    from transplat_tpu_torch.model.adapter import GaussianAdapterCfg
    from transplat_tpu_torch.model.encoder import EncoderCfg, OpacityMappingCfg

    cfg = EncoderCfg(gaussian_adapter=GaussianAdapterCfg(sh_degree=degree),
                     opacity_mapping=OpacityMappingCfg(-1.0, 1.0, 10), gaussians_per_pixel=samples)
    rng = np.random.default_rng(seed)
    r = shape[0] * shape[1]
    kinds = ("identity", "near_180", "random")
    extr = np.tile(np.eye(4), (b, v, 1, 1))
    for i in range(b * v):
        extr[i // v, i % v, :3, :3] = _rotation(rng, kinds[i % 3])
        extr[i // v, i % v, :3, 3] = rng.standard_normal(3)
    intr = np.tile(np.eye(3), (b, v, 1, 1))
    intr[..., 0, 0], intr[..., 1, 1] = rng.uniform(0.8, 1.4, (b, v)), rng.uniform(0.8, 1.4, (b, v))
    intr[..., 0, 1] = rng.uniform(-0.02, 0.02, (b, v))
    intr[..., 0, 2], intr[..., 1, 2] = rng.uniform(0.3, 0.7, (b, v)), rng.uniform(0.3, 0.7, (b, v))
    channels = 2 + cfg.gaussian_adapter.d_in
    if planar:
        raw = torch.from_numpy(rng.standard_normal((b, v, channels, r))).transpose(-1, -2)
    else:
        raw = torch.from_numpy(rng.standard_normal((b, v, r, channels)))
    depth, density = rng.uniform(0.5, 50.0, (b, v, r, samples)), rng.uniform(0.0, 1.0, (b, v, r, samples))
    f32 = lambda a: torch.as_tensor(a).to(dev, torch.float32)  # noqa: E731 (keeps raw's layout)
    return cfg, (f32(extr), f32(intr), f32(raw), f32(depth), f32(density), step, tuple(shape))


# The stage's kernel against the plain stage: the same float32 operations,
# the plain version's small matmuls and inverses in their library's order.
# Per field, max |kernel - plain| over max |plain|.
ADAPTER_TOL = 1e-5


def adapter_errors(got: dict, ref: dict) -> dict:
    """Each field's largest gap over the plain field's largest value."""
    return {k: scaled_err(got[k], ref[k].reshape(got[k].shape)) for k in got}


def project_case(dev, sets: int, views: int, g: int, degree: int, seed: int, exact: bool = False,
                 dtype=torch.float32):
    """Inputs of the render's projection (ops/rasterizer/projection.py
    `project_rows_kernel`) for `sets` Gaussian sets of g, each seen by `views`
    cameras: (extrinsics, intrinsics, near, means, covariances, sh,
    opacities). Cameras turned in turn by the identity, a turn of pi - 1e-3
    and a random rotation, off-centre intrinsics with a skew, near in [0.5,
    2]; with `exact`, cameras whose inverses and rays every algorithm rounds
    alike (synthetic_scene's: unturned, centred, focal length 1, shifted
    along x; near 1 or 2). The Gaussians lie in front of a set's first
    camera, a tenth behind it (z in [-3, 0.2]); a third needle-like, a
    twentieth with an indefinite covariance (det <= 0 on screen for many);
    SH N(0, 0.5) at `degree`, opacities in (0, 1)."""
    rng = np.random.default_rng(seed)
    cams = sets * views
    kinds = ("identity", "near_180", "random")
    extr = np.tile(np.eye(4), (cams, 1, 1))
    intr = np.tile(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]), (cams, 1, 1))
    if exact:
        extr[:, 0, 3] = np.linspace(-0.3, 0.3, cams)
        near = np.where(np.arange(cams) % 2 == 0, 1.0, 2.0)
    else:
        for i in range(cams):
            extr[i, :3, :3] = _rotation(rng, kinds[i % 3])
            extr[i, :3, 3] = rng.standard_normal(3)
        intr[:, 0, 0], intr[:, 1, 1] = rng.uniform(0.8, 1.4, cams), rng.uniform(0.8, 1.4, cams)
        intr[:, 0, 1] = rng.uniform(-0.02, 0.02, cams)
        intr[:, 0, 2], intr[:, 1, 2] = rng.uniform(0.3, 0.7, cams), rng.uniform(0.3, 0.7, cams)
        near = rng.uniform(0.5, 2.0, cams)
    local = np.stack([rng.uniform(-3, 3, (sets, g)), rng.uniform(-3, 3, (sets, g)), rng.uniform(1.0, 10.0, (sets, g))], -1)
    local[:, : g // 10, 2] = rng.uniform(-3.0, 0.2, (sets, g // 10))
    first = extr[::views]  # each set's first camera, camera-to-world
    means = np.einsum("bij,bgj->bgi", first[:, :3, :3], local) + first[:, None, :3, 3]
    s = rng.uniform(0.003, 0.02, (sets, g, 3))
    s[:, : g // 3, 0] *= 20.0
    sign = np.ones((sets, g, 3))
    sign[:, g // 3 : g // 3 + g // 20, 1] = -1.0
    s[:, g // 3 : g // 3 + g // 20, 1] *= 40.0
    q = rng.standard_normal((sets, g, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = np.moveaxis(q, -1, 0)
    rot = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                    2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                    2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1).reshape(sets, g, 3, 3)
    cov = rot @ ((sign * s * s)[..., :, None] * np.swapaxes(rot, -1, -2))
    sh = rng.standard_normal((sets, g, 3, (degree + 1) ** 2)) * 0.5
    opac = rng.uniform(0.0, 1.0, (sets, g))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)  # noqa: E731
    return tuple(t(a) for a in (extr, intr, near, means, cov, sh, opac))


# The projection kernel against the plain chain. On cameras every algorithm
# inverts alike (project_case's `exact`) the geometry is the same float32
# arithmetic in the same order: keys, rows and radii equal bit for bit. Else
# the plain chain's torch.linalg.inv and the kernel's inverse in double round
# apart by an ulp, and the EWA conic's cancellation (det = ac - b^2) grows a
# gap by its condition number ac / det (up to ~1e4 for a needle). So each
# field is held to the float64 chain: keys, means and opacities within
# PROJECT_TOL of (|x| + 1), each conic within PROJECT_TOL of (|x| + 1) times
# its condition number, or within PROJECT_GROWTH times the float32 chain's
# own gap where that is larger (a mean far off the axis, t = R m + T
# cancelling, reads ~3e-5 in float32 on turned cameras; over a few thousand
# Gaussians the two chains' largest gaps part by up to 2.3x either way).
# Colours (no cancellation): within PROJECT_COLOR_TOL of the float32 chain.
# A radius or a live flag may flip where ceil or a cull sits on its edge: at
# most PROJECT_FLIPS of the Gaussians (or 2). The depth order equals the
# float32 chain's but where two keys lie within PROJECT_TIE of each other.
PROJECT_TOL = 1e-5
PROJECT_GROWTH = 4.0
PROJECT_COLOR_TOL = 1e-5
PROJECT_FLIPS = 1e-4
PROJECT_TIE = 1e-5


def project_errors(got, plain, exact64=None) -> dict:
    """The kernel's outputs (keys, rows, colours, radii) against the float32
    plain chain's and, where given, the float64 chain's: the largest gaps,
    the flips, the order's mismatches beyond a tie. Fails (assert) where a
    reading is beyond its limit."""
    keys, rows, colors, radii = got
    pk, pr, pc, pradii = plain
    n = keys.numel()
    live, plive = torch.isfinite(keys), torch.isfinite(pk)
    out = {"gaussians": n, "live": int(live.sum()), "live_flips": int((live != plive).sum())}
    both = live & plive
    out["radius_flips"] = int((both & (rows[..., 5] != pr[..., 5])).sum())
    out["radius_flip_max"] = float((rows[..., 5] - pr[..., 5])[both].abs().max()) if out["radius_flips"] else 0.0
    out["radii_flips"] = int((radii != pradii).sum())
    if colors is not None:
        out["color_max_abs"] = max_err(colors, pc)
    order, porder = torch.argsort(keys, dim=-1, stable=True), torch.argsort(pk, dim=-1, stable=True)
    ka, kb = torch.take_along_dim(pk, order, -1), torch.take_along_dim(pk, porder, -1)
    apart = (order != porder) & ~((ka - kb).abs() <= PROJECT_TIE * kb.abs()) & torch.isfinite(kb)
    out["order_mismatch"] = int(apart.sum())
    if exact64 is None:
        out["equal"] = bool(torch.equal(keys, pk) and torch.equal(rows, pr) and torch.equal(radii, pradii))
        assert out["equal"], f"project: keys, rows or radii differ from the plain chain's on exact cameras: {out}"
    else:
        k64, r64 = exact64[0], exact64[1].double()
        same = both & torch.isfinite(k64)
        ca, cb, cc = r64[..., 2], r64[..., 3], r64[..., 4]
        cond = ((ca * cc).abs() / (ca * cc - cb * cb).abs()).nan_to_num(nan=float("inf")).clamp(min=1.0)
        fields = {
            "keys": (lambda t: t[0], k64, same, 1.0),
            "mean": (lambda t: t[1][..., 0:2], r64[..., 0:2], same[..., None], 1.0),
            "conic": (lambda t: t[1][..., 2:5], r64[..., 2:5], (same | (~live & ~plive & ~torch.isfinite(k64)))[..., None],
                      cond[..., None]),
            "opacity": (lambda t: t[1][..., 6], r64[..., 6], same, 1.0),
        }
        for name, (pick, ref, mask, scale) in fields.items():
            def gap(x):
                g = (pick(x).double() - ref).abs() / ((ref.abs() + 1.0) * scale)
                return float(g[mask.expand_as(g)].max()) if bool(mask.any()) else 0.0

            out[f"{name}_gap"], out[f"{name}_gap_plain"] = gap((keys, rows)), gap((pk, pr))
            limit = max(PROJECT_TOL, PROJECT_GROWTH * out[f"{name}_gap_plain"])
            assert out[f"{name}_gap"] <= limit, (f"project: {name} {out[f'{name}_gap']} from the float64 chain "
                                                 f"(the float32 chain's {out[f'{name}_gap_plain']}), beyond {limit}")
    flips = max(PROJECT_FLIPS * n, 2)
    assert (out["live_flips"] <= flips and out["radius_flips"] <= flips and out["radii_flips"] <= 2 * flips
            and out["radius_flip_max"] <= 1.0), f"project: flips beyond {flips:.0f}: {out}"
    assert out.get("color_max_abs", 0.0) <= PROJECT_COLOR_TOL, f"project: colours {out.get('color_max_abs')}"
    assert out["order_mismatch"] == 0, f"project: the depth order differs beyond ties: {out}"
    return out


VGG_PLAN = ((3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256), (256, 512), (512, 512),
            (512, 512), (512, 512), (512, 512), (512, 512))
VGG_FEATURE_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def seeded_lpips_state(naming: str = "torchvision", prefix: str = "", seed: int = 0) -> dict:
    """A seeded lpips(net='vgg') state dict, as numpy arrays, in torchvision's
    naming (`net.features.N`) or the lpips package's (`net.sliceK.N`), with
    the heads `lin{i}.model.1.weight`: He-scaled convs, small biases, heads
    in [0, 1)."""
    rng = np.random.RandomState(seed)
    state = {}
    for (cin, cout), idx in zip(VGG_PLAN, VGG_FEATURE_INDEX):
        if naming == "torchvision":
            name = f"{prefix}net.features.{idx}"
        else:
            name = f"{prefix}net.slice{1 + sum(idx > b for b in (3, 8, 15, 22))}.{idx}"
        state[f"{name}.weight"] = (rng.randn(cout, cin, 3, 3) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        state[f"{name}.bias"] = (0.01 * rng.randn(cout)).astype(np.float32)
    for i, ch in enumerate((64, 128, 256, 512, 512)):
        state[f"{prefix}lin{i}.model.1.weight"] = rng.rand(1, ch, 1, 1).astype(np.float32)
    return state
