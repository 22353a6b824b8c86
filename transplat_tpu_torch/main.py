"""Command line of the port: python -m transplat_tpu_torch.main <mode> [options].

Counterpart of transplat_tpu/main.py, with its parser and every flag, plus
`--device` (default cuda: every mode that computes runs on the card unless
`--device cpu` is given, and fails without a card):

  train           fit on the configured dataset (<root>/train/*.torch),
                  validating on <root>/test/*.torch; a run directory under
                  outputs/runs/<stamp> (or --output) and the outputs/latest-run
                  link; `--checkpoint latest` follows the previous run. With
                  --dp N --sp M under `torchrun --nproc-per-node N*M`, every
                  rank trains (parallel/mesh.py): NCCL, a card per rank
                  (cuda:LOCAL_RANK), or gloo on the CPU with --device cpu
  test            evaluate a checkpoint (--checkpoint, a run's checkpoints
                  directory) or weight files (checkpointing.pretrained_model,
                  .dav2_weights, .lpips_weights: .npy trees in the JAX
                  package's layout) on the test chunks through
                  --evaluation-index; scores and, as asked, renders
                  (--save-image), videos, PLY, stage timing and analysis into
                  --output
  generate-index  an evaluation index by view overlap over <root>/test/*.torch
                  (--output, default outputs/evaluation_index.json;
                  --video-index for dense targets)
  bench           the rasterizer and training-step benchmark (bench.py)
  compute-metrics PSNR / SSIM of saved renders (--method name=dir, repeatable)
                  against --ground-truth's, into --output/summary.json
                  (default outputs/metrics); --side-by-side, --animate

Besides the flags, config fields can be set as `section.field=value`
arguments (the value read as YAML), after the --config file: e.g.
`checkpointing.pretrained_model=tree.npy test.save_ply=true`.

`main(argv)` runs in the caller's process and returns the exit code, so a
script can read the kernels' launch counts around it.
"""

from __future__ import annotations

import argparse
import json

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
    parser.add_argument("--dp", type=int, default=None, help="train: data-parallel size (under torchrun)")
    parser.add_argument("--sp", type=int, default=1, help="train: splat-parallel size (under torchrun)")
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
    parser.add_argument("overrides", nargs="*", default=[], metavar="section.field=value",
                        help="config fields, each value read as YAML")
    return parser


def parse_overrides(items: list[str]) -> dict:
    """["a.b=1", "c.d=x"] -> {"a": {"b": 1}, "c": {"d": "x"}}, values read as YAML."""
    import yaml

    nested: dict = {}
    for item in items:
        key, sep, value = item.partition("=")
        if not sep or not key:
            raise ValueError(f"config override {item!r} is not of the form section.field=value")
        node = nested
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = yaml.safe_load(value)
    return nested


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card: the port runs on the card; pass --device cpu to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def _mesh(args, device: torch.device):
    """The dp x sp mesh of `--dp/--sp` under torchrun (WORLD_SIZE ranks,
    each on cuda:LOCAL_RANK over NCCL, or on the CPU over gloo with
    --device cpu); None for one process with no flags, as before."""
    import os

    world = int(os.environ.get("WORLD_SIZE", 1))
    if args.dp is None and args.sp == 1 and "WORLD_SIZE" not in os.environ:
        return None
    dp = args.dp if args.dp is not None else world // args.sp
    if dp < 1 or dp * args.sp != world:
        raise SystemExit(
            f"--dp {args.dp} --sp {args.sp}: dp * sp must equal the number of ranks ({world}); run under "
            f"torchrun --nproc-per-node {max(dp, 1) * args.sp} -m transplat_tpu_torch.main train --dp ... --sp ..."
        )
    from .parallel import make_mesh

    return make_mesh(dp, args.sp, device="cpu" if device.type == "cpu" else None)


def _train(cfg, args, device: torch.device) -> int:
    import datetime
    from pathlib import Path

    import torch.distributed as dist

    from .training.trainer import Trainer

    mesh = _mesh(args, device)
    writer = mesh is None or mesh.is_writer
    # A run directory per run (--output resumes into an existing one) and the
    # outputs/latest-run link to it; under a mesh rank 0 names and links it.
    run_dir = load = None
    if writer:
        if args.output:
            run_dir = Path(args.output)
        else:
            stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
            run_dir = Path("outputs/runs") / stamp
        run_dir.mkdir(parents=True, exist_ok=True)
        latest = Path("outputs/latest-run")
        latest.parent.mkdir(parents=True, exist_ok=True)
        # `--checkpoint latest` follows the previous run: resolve it before the link moves.
        load = cfg.checkpointing.load
        if load == "latest":
            load = str(latest.resolve() / "checkpoints") if latest.exists() else None
        if latest.is_symlink() or latest.exists():
            latest.unlink()
        latest.symlink_to(run_dir.resolve())
        print(f"run dir: {run_dir}", flush=True)
    if mesh is not None and mesh.world > 1:
        shared = [run_dir, load]
        dist.broadcast_object_list(shared, src=0)
        run_dir, load = shared
    cfg.checkpointing.save_dir = str(Path(run_dir) / "checkpoints")
    cfg.checkpointing.load = load

    try:
        trainer = Trainer(cfg, mesh=mesh, device=device, log_fn=lambda m: print(m, flush=True))
        state = trainer.fit(max_steps=args.max_steps)
        if writer:
            print(f"trained to step {state.step}; checkpoints in {cfg.checkpointing.save_dir}", flush=True)
    finally:
        if mesh is not None:
            mesh.close()
    return 0


def _test(cfg, args, device: torch.device) -> int:
    import numpy as np

    from .evaluation.evaluator import Evaluator
    from .loss.vgg import LPIPS, init_lpips
    from .training.checkpointing import CheckpointManager
    from .training.schedule import make_lr_schedule
    from .training.step import create_train_state, make_optimizer

    ckpt = cfg.checkpointing
    optimizer = make_optimizer(make_lr_schedule(cfg.optimizer.lr, 1000))
    state = create_train_state(cfg.encoder, optimizer, None, device=device, seed=0, ckpt_cfg=ckpt)
    if ckpt.pretrained_model or ckpt.dav2_weights:
        print(f"loaded pretrained weights: model={ckpt.pretrained_model} dav2={ckpt.dav2_weights}", flush=True)
    if ckpt.load:
        restored = CheckpointManager(ckpt.load).restore(state)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt.load}")
        state = restored
        print(f"loaded checkpoint at step {state.step}", flush=True)
    state.encoder.eval()
    lpips = state.lpips  # a Lightning tree's embedded LPIPS, if any
    if ckpt.lpips_weights:
        lpips = init_lpips(np.load(ckpt.lpips_weights, allow_pickle=True).item(), device)
        print(f"lpips: weights from {ckpt.lpips_weights}", flush=True)
    elif lpips is not None:
        print("lpips: weights embedded in the pretrained tree", flush=True)
    else:
        # Without weights the port still scores LPIPS, with a seeded random
        # initialisation (the JAX command line leaves LPIPS out then).
        lpips = LPIPS(device=device, seed=0)
        print("lpips: random-init weights", flush=True)
    evaluator = Evaluator(cfg, state.encoder, lpips, device=device)
    scores = evaluator.run(max_scenes=args.max_scenes, save_images=cfg.test.save_image)
    print(json.dumps(dict(list(scores.items())[:5]), indent=2), flush=True)
    return 0


def _compute_metrics(args, device: torch.device) -> int:
    from pathlib import Path

    from .evaluation.metric_computer import MetricComputer, MetricComputerCfg

    mc_cfg = MetricComputerCfg(
        methods=dict(m.split("=", 1) for m in args.method),
        ground_truth=args.ground_truth,
        output_path=args.output or "outputs/metrics",
        side_by_side=args.side_by_side,
        animate_side_by_side=args.animate,
    )
    computer = MetricComputer(mc_cfg, device=device)
    for scene in sorted(p.name for p in Path(args.ground_truth).iterdir() if p.is_dir()):
        computer.process_scene(scene)
    print(json.dumps(computer.summarize(), indent=2), flush=True)
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
    args = parser.parse_intermixed_args(argv)
    if args.mode == "compute-metrics":
        if not args.ground_truth or not args.method:
            parser.error("compute-metrics requires --ground-truth and at least one --method name=dir")
        return _compute_metrics(args, _device(args.device))

    from .config import _apply_overrides, load_config

    cfg = load_config(args.experiment, yaml_path=args.config)
    try:
        cfg = _apply_overrides(cfg, parse_overrides(args.overrides))
    except (AttributeError, TypeError, ValueError) as e:
        parser.error(f"config overrides {args.overrides}: {e}")
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
