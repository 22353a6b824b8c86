"""Training-step stage attribution: the step's sub-graphs, forward and
forward + backward, each with its allocator peak.

    python -m transplat_tpu_torch.bench_train_stages [--iters 10] [--tiny] [--device cuda|cpu]

Counterpart of scripts/bench_train_stages.py: the seeded re10k encoder and
a random-init LPIPS (the JAX script's: the FLOPs of the calibrated one) on
one synthetic batch (b = 1, 2 context and 2 target views at 256x256; the
tiny configuration at 64x64 with --tiny). Rows: the encoder's forward and
forward + backward (the gradient of sum(x^2) * 1e-6 over the Gaussians with
respect to its trainable parameters; the frozen DAv2 has none), the
render's forward and forward + backward (decode_splatting; the gradient of
sum((colour - target)^2) with respect to the Gaussians), LPIPS's forward
and forward + backward (the sum of its distances between the rendered and
the target views; the gradient with respect to the rendered views). Each
row gives host ms, device ms, the card's busy ms and idle share, launches
per call and, through `Benchmarker.memory`, the allocator's peak while the
sub-graph runs (utils/stage_timing.py `time_rows`): which sub-graph sets a
step's peak.
"""

from __future__ import annotations

import argparse
import json

import torch

from .utils.stage_timing import (
    add_device_arg,
    device_name,
    gradient_of,
    print_rows,
    resolve_device,
    scalarize,
    seeded_encoder,
    time_rows,
    trainable,
)

ROWS = ("encoder fwd", "encoder fwd+bwd", "render fwd", "render fwd+bwd", "lpips fwd", "lpips fwd+bwd")
CONTEXT_KEYS = ("image", "intrinsics", "extrinsics", "near", "far")
CAMERA_KEYS = ("extrinsics", "intrinsics", "near", "far")


def build(tiny: bool, device, seed: int = 0):
    """(encoder, lpips, batch): the seeded encoder, a random-init LPIPS and one synthetic batch."""
    from .dataset import synthetic_batch
    from .loss import LPIPS

    batch = synthetic_batch(seed, batch_size=1, image_shape=(64, 64) if tiny else (256, 256))
    return seeded_encoder(tiny, device, seed), LPIPS(device=device, seed=seed), batch


def subgraphs(encoder, lpips, batch: dict, device) -> dict:
    """{row name: fn()}: forward rows return the outputs (the Gaussians, the
    colours, LPIPS's sum), forward + backward rows the gradients: the
    encoder's by parameter name, the render's by Gaussian field, LPIPS's
    under "pred"."""
    from .inference import re10k_decoder_cfg
    from .model.decoder import decode_splatting
    from .model.types import Gaussians

    decoder_cfg = re10k_decoder_cfg()
    ctx = [torch.as_tensor(batch["context"][k], device=device) for k in CONTEXT_KEYS]
    cams = [torch.as_tensor(batch["target"][k], device=device) for k in CAMERA_KEYS]
    target = torch.as_tensor(batch["target"]["image"], device=device)
    shape = tuple(target.shape[2:4])

    def render(gaussians):
        return decode_splatting(gaussians, *cams, shape, cfg=decoder_cfg).color

    def lpips_sum(pred):
        return torch.sum(lpips(pred.reshape(-1, *pred.shape[2:]), target.reshape(-1, *target.shape[2:])))

    with torch.no_grad():
        gaussians = encoder(*ctx)
        color = render(gaussians)
    g_leaves = {k: v.detach().requires_grad_() for k, v in gaussians._asdict().items()}
    pred = {"pred": color.detach().requires_grad_()}

    return dict(zip(ROWS, (
        torch.no_grad()(lambda: encoder(*ctx)),
        gradient_of(lambda: scalarize(encoder(*ctx)), trainable(encoder)),
        torch.no_grad()(lambda: render(gaussians)),
        gradient_of(lambda: torch.sum((render(Gaussians(**g_leaves)) - target) ** 2), g_leaves),
        torch.no_grad()(lambda: lpips_sum(color)),
        gradient_of(lambda: lpips_sum(pred["pred"]), pred),
    )))


def run(device, iters: int = 10, tiny: bool = False, seed: int = 0) -> dict:
    encoder, lpips, batch = build(tiny, device, seed)
    rows = time_rows(subgraphs(encoder, lpips, batch, device).items(), device, iters)
    return {"tool": "bench_train_stages", "device": device_name(device), "iters": iters, "rows": rows}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--tiny", action="store_true", help="the tiny configuration at 64x64 (CPU runs)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device, "bench_train_stages")
    result = run(device, args.iters, args.tiny)
    print_rows(result["rows"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
