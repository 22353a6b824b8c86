"""Run one cell of the benchmark of transplat_tpu_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations, traffic mixes and metrics are those of
BENCHMARK.json at the root of the checkout. The last line of standard
output is one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device, with
--trace 1 a breakdown, and last the numbers compared with the reference
beside their limits, which also end standard error. A run needs as many
CUDA cards as the cell asks for and exits with status 2 without a result
when it finds fewer; it exits with status 3 without a result when JAX or
the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# Every build and kernel cache at a fixed place inside the checkout (the
# program's own CUDA build lands in transplat_tpu_torch/_build/ there).
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
    os.makedirs(os.environ[var], exist_ok=True)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cellrun, spec

    cell = spec.cell(spec.load_spec(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found {count}", file=sys.stderr)
        return 2
    result = cellrun.run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    loaded = cellrun.forbidden_modules()
    if loaded:
        print(f"modules of JAX or the JAX package were loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checked"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
