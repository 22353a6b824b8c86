"""Multi-rank runs of the training step and of the view-sharded decode.

`dryrun_multichip(n)` is the counterpart of `__graft_entry__.dryrun_multichip`:
n ranks (sp = 2 when n is even, dp = n // sp) take one full training step of
the tiny configuration with two target views, then the rasterizer's forward
and backward (K1 -> K3, K4 -> K2 on a card) through the sharded decode.

    python -m transplat_tpu_torch.parallel.dryrun [--ranks 2] [--device cpu|cuda]

`step_rank` / `reference_step` are the parity runs that the tests and
chip_smoke.py hold against each other: the same seeded state and global
batch through a dp x sp step on spawned ranks and through the one-process
step on the joined batch. Ranks on the CPU talk over gloo; on one card
(`device="cuda"`) gloo too, since NCCL takes a card per rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import kernels
from ..dataset import batch_to_device, synthetic_batch
from ..inference import init_random, re10k_decoder_cfg, re10k_encoder_cfg
from ..loss import LPIPS, LossCfg
from ..model.decoder import decode_splatting
from ..model.layers import _FlaxBatchNorm
from ..model.types import Gaussians
from ..training.schedule import make_lr_schedule
from ..training.step import ClipAdam, create_train_state, make_optimizer, make_train_step
from ..train_demo import tiny_encoder_cfg
from ..training.trainer import dropout_seed
from . import launch
from .mesh import all_reduce_ms, constrain, make_mesh, shard_batch, view_slice

CAMERA_KEYS = ("extrinsics", "intrinsics", "near", "far")


SEED = 0  # the batch, the weights, LPIPS and the dropout masks
LR = 2e-4


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """One parity run. `full_width`: the re10k encoder at 256^2 (else the
    tiny configuration of __graft_entry__.py at 64^2); the global batch holds
    dp examples of 2 context and `num_target` target views. `dropout` off
    makes a dp step comparable with the joined batch's (each dp group draws
    its own masks). `device` "cuda" (the default) or "cpu"."""

    dp: int = 1
    sp: int = 1
    device: str = "cuda"
    backend: str | None = None  # default: NCCL on a card, gloo on the CPU
    full_width: bool = False
    num_target: int = 2
    dropout: bool = False
    return_params: bool = False
    decode_check: bool = False
    float64: bool = False  # the state, the batch and every step computation in float64 (CPU only)

    @property
    def image(self) -> tuple[int, int]:
        return (256, 256) if self.full_width else (64, 64)


def _setup(spec: StepSpec, device: torch.device, mesh=None):
    """(state, train_step, global batch on the device)."""
    cfg = re10k_encoder_cfg() if spec.full_width else tiny_encoder_cfg()
    optimizer = make_optimizer(make_lr_schedule(LR, 1000), grad_clip=0.5)
    state = create_train_state(cfg, optimizer, LPIPS(device=device, seed=SEED), device=device)
    init_random(state.encoder, SEED)
    with torch.no_grad():  # keep depths off the 1/far clip, where 1/disparity amplifies rounding (chip_smoke.py)
        state.encoder.depth_predictor.to_disparity_2.weight[0] *= 0.01
    step = make_train_step(cfg, LossCfg(), re10k_decoder_cfg(), optimizer, spec.image,
                           deterministic=not spec.dropout, mesh=mesh)
    batch = batch_to_device(synthetic_batch(SEED, batch_size=spec.dp, num_context=2, num_target=spec.num_target,
                                            image_shape=spec.image), device)
    if spec.float64:
        state.encoder.double()
        state.lpips.double()
        state.opt_state = optimizer.init(state.trainable())
        batch = {side: {k: v.double() for k, v in views.items()} for side, views in batch.items()}
    return state, step, batch


def _norm_stats(encoder) -> dict:
    return {name: {"running_mean": m.running_mean.cpu(), "running_var": m.running_var.cpu(),
                   "batch_mean": m.batch_stats[0].cpu(), "batch_var": m.batch_stats[1].cpu()}
            for name, m in encoder.named_modules() if isinstance(m, _FlaxBatchNorm)}


def _run_step(spec: StepSpec, state, step, batch, device, dp_rank: int) -> dict:
    """One step from `state`; the record every parity run returns."""
    gen = torch.Generator(device=device).manual_seed(dropout_seed(SEED, state.step, dp_rank))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    before = {k: p.detach().clone() for k, p in state.trainable().items()} if spec.return_params else None
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, metrics = step(state, batch, gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rec = {"ms_per_step": (time.perf_counter() - t0) * 1e3, "launches": dict(kernels.launches),
           "metrics": {k: float(v) for k, v in metrics.items()}, "norms": _norm_stats(state.encoder),
           "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None}
    if spec.return_params:
        rec["update"] = {k: (p.detach() - before[k]).cpu() for k, p in state.trainable().items()}
        # After one step from zero moments Adam's first moment is (1 - b1) x the clipped gradient.
        rec["clipped_grads"] = {k: (m / (1.0 - ClipAdam.b1)).cpu() for k, m in state.opt_state.mu.items()}
    return rec


def step_rank(spec: StepSpec) -> dict:
    """One rank of a dp x sp training step (run it through `launch.spawn`):
    the seeded state, broadcast from rank 0 (`replicated`), takes one step
    on the rank's dp slice of the global batch. With `decode_check` the
    rank also renders its views from its slice of the eval-mode Gaussians
    through the sharded decode, against the unsharded decode of the same
    Gaussians."""
    from .mesh import replicated

    device = torch.device(spec.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(spec.dp, spec.sp, device=device, backend=spec.backend)
    device = mesh.device
    state, step, batch = _setup(spec, device, mesh)
    replicated(state, mesh)
    local = shard_batch(batch, mesh, is_global=True)
    rec = _run_step(spec, state, step, local, device, mesh.dp_rank)
    if mesh.rank != 0:
        rec.pop("update", None)
        rec.pop("clipped_grads", None)
    rec.update(rank=mesh.rank, dp_rank=mesh.dp_rank, sp_rank=mesh.sp_rank, traffic=dict(mesh.traffic),
               all_reduce={"bytes": mesh.last_all_reduce.get("gradients", {}).get("bytes", 0),
                           "ms": all_reduce_ms(mesh)},
               backend=mesh.backend)
    if spec.decode_check:
        rec["decode"] = _decode_check(state, local, spec.image, mesh)
    return rec


@torch.no_grad()
def _decode_check(state, batch: dict, image: tuple[int, int], mesh) -> dict:
    from ..dataset.loader import CONTEXT_KEYS
    from ..ops.rasterizer import api, binning

    ctx, tgt = batch["context"], batch["target"]
    gaussians = state.encoder(*(ctx[k] for k in CONTEXT_KEYS))
    cams = [tgt[k] for k in CAMERA_KEYS]
    local = constrain(gaussians, mesh)
    kernels.reset_launches()
    sharded = decode_splatting(local, *cams, image, mesh=mesh).color
    launches = dict(kernels.launches)
    views = view_slice(cams[0].shape[1], mesh)
    whole = decode_splatting(gaussians, *(c[:, views] for c in cams), image).color
    b, v = sharded.shape[:2]
    rep = lambda x: x[:, None].expand(b, v, *x.shape[1:]).reshape(b * v, *x.shape[1:])  # noqa: E731
    flat = [c[:, views].reshape(b * v, *c.shape[2:]) for c in cams]
    proj = binning.sort_by_depth(api.project_views(*flat[:3], *(rep(x) for x in gaussians), image))
    pairs = int(binning.bin_gaussians(proj[0], image).idx.numel()) if sharded.is_cuda else None
    return {"views": [views.start, views.stop], "max_abs_err": float((sharded - whole).abs().max()),
            "finite": bool(torch.isfinite(sharded).all()), "launches": launches, "pairs": pairs,
            "gaussians_local": int(local.means.shape[1]), "gaussians": int(gaussians.means.shape[1])}


def reference_step(spec: StepSpec) -> dict:
    """The one-process step on the joined batch (all dp examples), from the
    same seeded state, in this process."""
    device = torch.device(spec.device)
    state, step, batch = _setup(spec, device)
    return _run_step(dataclasses.replace(spec, dp=1), state, step, batch, device, dp_rank=0)


def _flat(tensors: dict) -> torch.Tensor:
    return torch.cat([tensors[k].reshape(-1).double() for k in sorted(tensors)])


# The share of the clipped gradient's norm from which a leaf's own relative
# error is held. At the tiny width 30 of its 459 leaves are 0 by
# construction (biases just before a normalisation) and read rounding: up
# to 6e-9 of the norm in float32 and 1.2e-16 in float64, where the smallest
# leaf that carries a gradient reads 8.7e-9. In float32 the leaves from
# 1e-6 of the norm (420) are held; float64 runs pass 1e-12 and hold all 429.
CARRYING_LEAF = 1e-6


def step_errors(ranks: list[dict], ref: dict, carrying: float = CARRYING_LEAF) -> dict:
    """A dp x sp step's ranks (`step_rank` records, `return_params`)
    against the one-process step (`reference_step`) from the same state.
    The clipped gradient G is compared whole (relative L2 distance), leaf
    by leaf (the worst relative distance among the leaves that carry at
    least `carrying` of |G|, so that a fault confined to a small
    subnetwork shows) and by its largest leaf distance over |G|. The
    update (parameters after the step less before) by its cosine and
    largest difference."""
    m, mr = ranks[0]["metrics"], ref["metrics"]
    got, want = ranks[0]["clipped_grads"], ref["clipped_grads"]
    norm = float(_flat(want).norm())
    leaves = {k: (float((got[k].double() - want[k].double()).norm()), float(want[k].double().norm())) for k in want}
    u_got, u_ref = _flat(ranks[0]["update"]), _flat(ref["update"])
    color = [r["decode"]["max_abs_err"] for r in ranks if "decode" in r]
    return {
        "finite": all(np.isfinite(list(r["metrics"].values())).all() for r in ranks),
        "same_metrics_on_every_rank": all(r["metrics"] == m for r in ranks),
        "same_keys": got.keys() == want.keys(),
        "loss_rel_err": abs(m["loss"] - mr["loss"]) / abs(mr["loss"]),
        "grad_norm_rel_err": abs(m["grad_norm"] - mr["grad_norm"]) / mr["grad_norm"],
        "clipped_grad_rel_l2": float((_flat(got) - _flat(want)).norm()) / norm,
        "clipped_grad_worst_leaf_rel": max(d / n for d, n in leaves.values() if n >= carrying * norm),
        "leaves_held": sum(n >= carrying * norm for _, n in leaves.values()),
        "clipped_grad_max_leaf_err_over_norm": max(d for d, _ in leaves.values()) / norm,
        "update_cosine": float(torch.nn.functional.cosine_similarity(u_got, u_ref, dim=0)),
        "update_max_abs_diff": float((u_got - u_ref).abs().max()),
        "batch_norm_max_abs_err": max(float((r["norms"][n][k] - v).abs().max())
                                      for r in ranks for n, st in ref["norms"].items() for k, v in st.items()),
        "color_max_abs_err": max(color) if color else None,
    }


def decode_rank(scene: dict, dp: int, sp: int, image: tuple[int, int], device: str = "cuda",
                backend: str | None = None) -> dict:
    """One rank of a dp x sp decode of a numpy scene ({means, covariances,
    harmonics, opacities}: (dp * b, g, ...); {extrinsics, intrinsics, near,
    far}: (dp * b, tv, ...)): the rank's dp slice, its slice of the
    Gaussians as leaves, the sharded decode, loss = sum of its views'
    squared colours, backward. Returns its views, their colours, the
    gradients of its slice (after the reduce-scatter) and its kernel
    launches."""
    mesh = make_mesh(dp, sp, device=device, backend=backend)
    dev = mesh.device
    scene = shard_batch(scene, mesh, is_global=True)
    full = Gaussians(*(torch.as_tensor(scene[k], device=dev) for k in Gaussians._fields))
    local = Gaussians(*(x.clone().requires_grad_(True) for x in constrain(full, mesh)))
    cams = [torch.as_tensor(scene[k], device=dev) for k in CAMERA_KEYS]
    kernels.reset_launches()
    color = decode_splatting(local, *cams, image, mesh=mesh).color
    (color**2).sum().backward()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    views = view_slice(cams[0].shape[1], mesh)
    return {"rank": mesh.rank, "dp_rank": mesh.dp_rank, "sp_rank": mesh.sp_rank, "views": [views.start, views.stop],
            "color": color.detach().cpu(), "grads": {k: getattr(local, k).grad.cpu() for k in Gaussians._fields},
            "launches": dict(kernels.launches), "traffic": dict(mesh.traffic)}


def dryrun_scene(dp: int, g: int = 4096, views: int = 2, seed: int = 2) -> dict:
    """The JAX dry run's decode scene: g Gaussians around z = 5, two identity
    cameras (fx = 1.2), near 1, far 100; numpy, from `seed`."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "means": (rng.normal(size=(dp, g, 3)) * 2 + [0, 0, 5.0]).astype(f32),
        "covariances": np.broadcast_to(np.eye(3, dtype=f32) * 0.01, (dp, g, 3, 3)).copy(),
        "harmonics": (rng.uniform(size=(dp, g, 3, 25)) * 0.3).astype(f32),
        "opacities": (rng.uniform(size=(dp, g)) * 0.8).astype(f32),
        "extrinsics": np.broadcast_to(np.eye(4, dtype=f32), (dp, views, 4, 4)).copy(),
        "intrinsics": np.broadcast_to(np.array([[1.2, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], f32), (dp, views, 3, 3)).copy(),
        "near": np.ones((dp, views), f32),
        "far": np.full((dp, views), 100.0, f32),
    }


def _dryrun_rank(n: int, device: str) -> dict:
    sp = 2 if n % 2 == 0 and n > 1 else 1
    dp = n // sp
    rec = step_rank(StepSpec(dp=dp, sp=sp, device=device, backend="gloo", dropout=True))
    if not np.isfinite(rec["metrics"]["loss"]) or rec["metrics"]["grad_norm"] <= 0.0:
        raise RuntimeError(f"dry run step: {rec['metrics']}")
    out = {"step": rec, "sp": sp, "dp": dp}
    if sp > 1:  # K1 -> K3 and K4 -> K2 through the sharded decode, on the step's process group
        dec = decode_rank(dryrun_scene(dp), dp, sp, (64, 64), device=device, backend="gloo")
        grad = torch.cat([g.reshape(-1) for g in dec["grads"].values()])
        if not bool(torch.isfinite(grad).all()) or float(grad.norm()) <= 0.0:
            raise RuntimeError("dry run decode: gradients not finite or all zero")
        out["decode"] = {"launches": dec["launches"], "grad_norm": float(grad.norm()), "traffic": dec["traffic"]}
    return out


def dryrun_multichip(n: int, device: str = "cuda", timeout_s: float = 600.0) -> list[dict]:
    """n ranks, sp = 2 when n is even and dp = n // sp: one full training
    step of the tiny configuration (two target views, dropout on), then K1 ->
    K3 and K4 -> K2 through the sharded decode of 4096 Gaussians at 64^2.
    Ranks are spawned on the card (the default: every rank on it, over
    gloo), or on the CPU over gloo with device="cpu". Returns the ranks'
    records."""
    recs = launch.spawn(_dryrun_rank, n, n, device, timeout_s=timeout_s, local_ranks=False)
    loss = recs[0]["step"]["metrics"]["loss"]
    msg = f"dryrun_multichip ok: {n} ranks (dp={recs[0]['dp']}, sp={recs[0]['sp']}) on {device}, loss={loss:.4f}"
    if "decode" in recs[0]:
        msg += f"; sharded fwd+bwd grad_norm={recs[0]['decode']['grad_norm']:.3f}"
    print(msg, flush=True)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one dp x sp training step and a sharded decode on spawned ranks")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default: every rank on card 0, over gloo) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to run the ranks on the CPU")
    dryrun_multichip(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
