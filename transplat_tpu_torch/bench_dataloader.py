"""Data-path throughput: examples per second of the threaded loader and of
2, 4 and 8 worker processes, against a training step's budget.

    python -m transplat_tpu_torch.bench_dataloader --step-ms MS [--dp 1] [--batch-size 2] [--chunks 8]
        [--measure-batches 40] [--device cuda|cpu]

Counterpart of scripts/bench_dataloader.py. With no dataset here it writes
RE10K-format chunks from a seed with the port's own writer
(dataset/chunks.py `make_scene`, `write_chunk`: `--chunks` chunks of 6
scenes x 40 frames at 360x640, JPEGs from the machine's JPEG route) into a
temporary directory, and runs the real ChunkDataset -> view sampler ->
batch path over them: `DataLoader` (one prefetch thread) and
`MultiWorkerLoader` with 2, 4 and 8 forked workers, as
`Trainer.train_batches` builds them (where the route is nvJPEG the workers
send JPEG bytes and this process decodes, `finish_example`). A worker with
no chunk of its own ends at once, so the default of 8 chunks gives each of
8 workers one.

The budget: a step of `--step-ms` consumes `--dp` x `--batch-size`
examples, so the loader must give dp * batch_size / step seconds examples
per second. `--step-ms` has no default: pass a training step measured on
the card (train_demo.py or the re10k-train cell reads one). `--device cpu`
runs on a host with libjpeg, with no card; without it the tool needs one.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import torch

from .utils.stage_timing import add_device_arg, device_name, resolve_device

WORKERS = (2, 4, 8)
SCENES_PER_CHUNK = 6
FRAMES = 40
FRAME_SHAPE = (360, 640)


def write_chunks(root: str | Path, chunks: int, scenes: int = SCENES_PER_CHUNK, frames: int = FRAMES,
                 hw: tuple[int, int] = FRAME_SHAPE, route: str | None = None) -> list[Path]:
    """`chunks` seeded training chunks under `root`/train."""
    from .dataset.chunks import make_scene, write_chunk

    return [
        write_chunk(Path(root) / "train" / f"{c:06d}.torch",
                    [make_scene(f"scene{c}_{s}", frames, seed=c * scenes + s, hw=hw, jpeg_route=route)
                     for s in range(scenes)])
        for c in range(chunks)
    ]


def loaders(root: str | Path, batch_size: int, route: str, workers=WORKERS) -> dict:
    """{name: loader}: "threaded" and "workers_<n>" over the chunks under `root`."""
    from . import native
    from .config import BoundedCfg, DatasetCfg
    from .dataset.loader import DataLoader, MultiWorkerLoader
    from .dataset.re10k import ChunkDataset, finish_example
    from .dataset.view_samplers import ViewSamplerBounded

    cfg = DatasetCfg(roots=[str(root)], image_shape=(256, 256))

    def endless(ds, decode: bool = True):
        while True:
            yield from ds.iter_examples(lambda: 0, decode=decode)

    in_workers = native.route_runs_in_workers(route)
    finish = None if in_workers else (lambda pending: finish_example(pending, cfg.image_shape, route))
    out = {"threaded": DataLoader(endless(ChunkDataset(cfg, "train", ViewSamplerBounded(BoundedCfg()),
                                                       jpeg_route=route)), batch_size)}
    for nw in workers:
        def make_worker_iter(w, nw=nw):
            ds = ChunkDataset(cfg, "train", ViewSamplerBounded(BoundedCfg()), seed=1234 + w, shard_id=w,
                              num_shards=nw, jpeg_route=route)
            return endless(ds, in_workers) if ds.chunks else iter(())

        out[f"workers_{nw}"] = MultiWorkerLoader(make_worker_iter, nw, batch_size, finish=finish)
    return out


def examples_per_s(loader, batches: int) -> float:
    """Examples per second over `batches` batches after the first (workers started, queue warm)."""
    it = iter(loader)
    try:
        next(it)
        t0 = time.perf_counter()
        got = 0
        for _ in range(batches):
            got += next(it)["context"]["image"].shape[0]
        return got / (time.perf_counter() - t0)
    finally:
        it.close()


def run(step_ms: float, device: torch.device, dp: int = 1, batch_size: int = 2, chunks: int = 8,
        measure_batches: int = 40, workers=WORKERS, frames: int = FRAMES) -> dict:
    """{"examples_per_s": {loader: rate}, "need_examples_per_s", ...} over
    freshly written chunks (see the module's docstring)."""
    from . import native

    route = native.jpeg_route()
    if device.type == "cpu" and not native.route_runs_in_workers(route):
        raise SystemExit(f"bench_dataloader: --device cpu needs the host JPEG route; this machine has {route}")
    with tempfile.TemporaryDirectory(prefix="dl_bench_") as tmp:
        t0 = time.perf_counter()
        write_chunks(tmp, chunks, frames=frames, route=route)
        write_s = time.perf_counter() - t0
        rates = {name: examples_per_s(loader, measure_batches)
                 for name, loader in loaders(tmp, batch_size, route, workers).items()}
    need = dp * batch_size / (step_ms / 1e3)
    return {"tool": "bench_dataloader", "device": device_name(device), "jpeg_route": route, "step_ms": step_ms,
            "dp": dp, "batch_size": batch_size, "chunks": chunks, "frames": [SCENES_PER_CHUNK, frames, *FRAME_SHAPE],
            "write_chunks_s": write_s, "examples_per_s": rates, "need_examples_per_s": need,
            "ratio_to_need": {k: v / need for k, v in rates.items()}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--step-ms", type=float, required=True, help="a training step's ms (measured on the card)")
    parser.add_argument("--dp", type=int, default=1, help="data-parallel ranks a step feeds")
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--chunks", type=int, default=8)
    parser.add_argument("--measure-batches", type=int, default=40)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device, "bench_dataloader")
    result = run(args.step_ms, device, args.dp, args.batch_size, args.chunks, args.measure_batches)
    need = result["need_examples_per_s"]
    print(f"{'loader':<12} {'examples/s':>11} {f'vs dp={args.dp} need {need:.1f}/s':>24}")
    for name, rate in result["examples_per_s"].items():
        print(f"{name:<12} {rate:>11.1f} {rate / need:>23.2f}x")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
