"""Command line of the port: python -m transplat_tpu_torch.main <mode> [options].

Counterpart of transplat_tpu/main.py, with its parser and every flag, plus
`--device` (default cuda: every mode that computes runs on the card unless
`--device cpu` is given, and fails without a card):

  train           fit on the configured dataset (<root>/train/*.torch),
                  validating on <root>/test/*.torch; a run directory under
                  outputs/runs/<stamp> (or --output) and the outputs/latest-run
                  link; `--checkpoint latest` follows the previous run
  test            evaluate a checkpoint (--checkpoint, a run's checkpoints
                  directory) on the test chunks through --evaluation-index;
                  scores into --output
  generate-index  an evaluation index by view overlap over <root>/test/*.torch
                  (--output, default outputs/evaluation_index.json;
                  --video-index for dense targets)
  bench           the rasterizer and training-step benchmark (bench.py)
  compute-metrics not ported yet: exits non-zero and names what it waits for

`main(argv)` runs in the caller's process and returns the exit code, so a
script can read the kernels' launch counts around it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

MODES = ("train", "test", "generate-index", "bench", "compute-metrics")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m transplat_tpu_torch.main", description="transplat_tpu_torch")
    parser.add_argument("mode", choices=MODES)
    parser.add_argument("--experiment", default="re10k")
    parser.add_argument("--config", default=None, help="YAML override file")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--max-scenes", type=int, default=None)
    parser.add_argument("--evaluation-index", default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--dp", type=int, default=None, help="data-parallel size (1 only)")
    parser.add_argument("--sp", type=int, default=1, help="splat-parallel size (1 only)")
    parser.add_argument("--dataset-root", default=None)
    parser.add_argument("--method", action="append", default=[], help="compute-metrics: name=render_dir (repeatable)")
    parser.add_argument("--ground-truth", default=None, help="compute-metrics: GT render dir")
    parser.add_argument("--side-by-side", action="store_true", help="compute-metrics: write comparison panels")
    parser.add_argument("--animate", action="store_true", help="compute-metrics: side-by-side videos per scene")
    parser.add_argument("--video-index", action="store_true", help="generate-index: dense targets for video rendering")
    parser.add_argument("--save-image", action="store_true", help="test: save rendered targets")
    parser.add_argument("--save-video", action="store_true", help="test: trajectory videos per scene")
    parser.add_argument("--save-ply", action="store_true", help="test: per-scene 3DGS .ply")
    parser.add_argument("--analyze", action="store_true", help="test: per-scene workload analysis")
    parser.add_argument("--stage-timing", action="store_true", help="test: stage-resolved encoder timing")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card: the port runs on the card; pass --device cpu to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def _train(cfg, args, device: torch.device) -> int:
    import datetime
    from pathlib import Path

    from .training.trainer import Trainer

    # A run directory per run (--output resumes into an existing one) and the
    # outputs/latest-run link to it.
    if args.output:
        run_dir = Path(args.output)
    else:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        run_dir = Path("outputs/runs") / stamp
    run_dir.mkdir(parents=True, exist_ok=True)
    cfg.checkpointing.save_dir = str(run_dir / "checkpoints")
    latest = Path("outputs/latest-run")
    latest.parent.mkdir(parents=True, exist_ok=True)
    # `--checkpoint latest` follows the previous run: resolve it before the link moves.
    if cfg.checkpointing.load == "latest":
        cfg.checkpointing.load = str(latest.resolve() / "checkpoints") if latest.exists() else None
    if latest.is_symlink() or latest.exists():
        latest.unlink()
    latest.symlink_to(run_dir.resolve())
    print(f"run dir: {run_dir}", flush=True)

    if args.dp not in (None, 1) or args.sp != 1:
        raise NotImplementedError(
            f"--dp {args.dp} --sp {args.sp}: the device mesh (transplat_tpu/parallel/mesh.py) is not ported yet; "
            "the port trains on one card"
        )
    trainer = Trainer(cfg, device=device, log_fn=lambda m: print(m, flush=True))
    state = trainer.fit(max_steps=args.max_steps)
    print(f"trained to step {state.step}; checkpoints in {cfg.checkpointing.save_dir}", flush=True)
    return 0


def _test(cfg, args, device: torch.device) -> int:
    from .evaluation.evaluator import Evaluator
    from .loss.vgg import LPIPS
    from .training.checkpointing import CheckpointManager
    from .training.schedule import make_lr_schedule
    from .training.step import create_train_state, make_optimizer

    if cfg.test.save_image:
        raise NotImplementedError("--save-image: saving renders needs utils/image_io.py, which is not ported yet")
    if cfg.checkpointing.pretrained_model or cfg.checkpointing.dav2_weights or cfg.checkpointing.lpips_weights:
        raise NotImplementedError(
            "checkpointing.pretrained_model / dav2_weights / lpips_weights: loading weight files "
            "(training/pretrained.py of the JAX package) is not ported yet"
        )
    optimizer = make_optimizer(make_lr_schedule(cfg.optimizer.lr, 1000))
    state = create_train_state(cfg.encoder, optimizer, None, device=device, seed=0)
    if cfg.checkpointing.load:
        restored = CheckpointManager(cfg.checkpointing.load).restore(state)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {cfg.checkpointing.load}")
        state = restored
        print(f"loaded checkpoint at step {state.step}", flush=True)
    state.encoder.eval()
    # LPIPS with random-init weights (calibrated ones load with the pretrained loader, not ported yet).
    lpips = LPIPS(device=device, seed=0)
    print("lpips: random-init weights", flush=True)
    scores = Evaluator(cfg, state.encoder, lpips, device=device).run(max_scenes=args.max_scenes)
    print(json.dumps(dict(list(scores.items())[:5]), indent=2), flush=True)
    return 0


def _generate_index(cfg, args, device: torch.device) -> int:
    from pathlib import Path

    import numpy as np

    from .dataset.re10k import convert_poses
    from .evaluation.index_generator import EvaluationIndexGenerator, IndexGeneratorCfg

    gen = EvaluationIndexGenerator(IndexGeneratorCfg(dense_targets=args.video_index), device=device)
    for root in cfg.dataset.roots:
        for chunk_path in sorted((Path(root) / "test").glob("*.torch")):
            for raw in torch.load(chunk_path, weights_only=False):
                extr, intr = convert_poses(np.asarray(raw["cameras"], np.float32))
                gen.process_scene(raw["key"], extr, intr)
    out = args.output or "outputs/evaluation_index.json"
    gen.save(out)
    print(f"wrote {out} with {len(gen.index)} scenes", flush=True)
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mode == "compute-metrics":
        print(
            "compute-metrics is not ported yet: it waits for evaluation/metric_computer.py, utils/image_io.py and "
            "visualization/ (transplat_tpu/ has them)",
            file=sys.stderr,
        )
        return 2

    from .config import load_config

    cfg = load_config(args.experiment, yaml_path=args.config)
    if args.dataset_root:
        cfg.dataset.roots = [args.dataset_root]
    if args.evaluation_index:
        cfg.test.evaluation_index = args.evaluation_index
    if args.checkpoint:
        cfg.checkpointing.load = args.checkpoint
    if args.output:
        cfg.test.output_path = args.output
    for flag in ("save_image", "save_video", "save_ply", "analyze", "stage_timing"):
        if getattr(args, flag):
            setattr(cfg.test, flag, True)

    device = _device(args.device)
    if args.mode == "train":
        return _train(cfg, args, device)
    if args.mode == "test":
        return _test(cfg, args, device)
    if args.mode == "generate-index":
        return _generate_index(cfg, args, device)
    from .bench import main as bench_main

    return bench_main(device=device.type)


if __name__ == "__main__":
    raise SystemExit(main())
