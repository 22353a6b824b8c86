"""What profile_stages.py and the bench_*_stages.py modules share: the
device flag, the scalarised loss, one row of timing per sub-graph, and the
bytes a run of operations moves.

A row (`time_rows`) calls its sub-graph once to warm it, then `iters` times,
each call after a synchronize: `host_ms` is the host clock from the call to
the card's completion of it (a `torch.cuda.synchronize`), `device_ms` the
time between two CUDA events recorded around it on the stream. Their
difference, `host_share`, is the time before the card starts the call's
first kernel and after it ends its last. The events also span the gaps in
between, where the card waits for the host to launch the next kernel, so
one more call runs under torch.profiler (CUDA activity): `busy_ms` is the
union of its device events' intervals, and `idle_share` = 1 - busy_ms /
host_ms the share of the call the card had nothing to do. One more call
runs inside `Benchmarker.memory` for its allocator peak, and the launches of
each hand-written kernel (`kernels.launches`) during the timed calls are
divided by `iters`. On the CPU the device columns are None (there is no
device clock) and the plain versions of the kernels run, which launch
nothing.

`OpBytes` counts the bytes a run moves, the counterpart of XLA's
`cost_analysis()["bytes accessed"]`: every aten operation's tensor operands
and outputs, each once (a view or an empty allocation moves nothing;
an operand broadcast along a dimension counts once along it). XLA counts the
operands of its fused computations, so this is an unfused upper bound: a
chain of elementwise operations counts its intermediate tensors, which a
fusion keeps in registers. The hand-written kernels take raw pointers, which
no dispatch mode sees; each launch is counted through `kernels.observers` as
the bytes of the tensors whose pointers it is given (each read or written
once: K5 and K6 read only the sectors their samples touch, which the bound
of PERF.md's kernel table counts instead).
"""

from __future__ import annotations

import argparse
import time
from collections import Counter

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from .. import kernels
from .benchmarker import Benchmarker

_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="the card (default; exits without one) or the CPU with the kernels' plain versions")


def resolve_device(name: str, prog: str) -> torch.device:
    """The device of `--device`: the card, TF32 off; without a card, exit."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"{prog}: no CUDA card: the port runs on the card; pass --device cpu to run on the CPU")
        kernels.strict_float32()
    return device


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def seeded_encoder(tiny: bool, device, seed: int = 0, compute_dtype: str | None = None):
    """The tools' encoder: re10k's (or train_demo.py's tiny one) with random
    weights from `seed`, in eval mode; `compute_dtype` overrides the
    configuration's ("float32" / "bfloat16")."""
    import dataclasses

    from ..inference import init_random, re10k_encoder_cfg
    from ..model.encoder import EncoderTranSplat
    from ..train_demo import tiny_encoder_cfg

    cfg = tiny_encoder_cfg() if tiny else re10k_encoder_cfg()
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype, s2d_unet=False)
    encoder = EncoderTranSplat(cfg, device=device)
    init_random(encoder, seed)
    return encoder


def scalarize(tree) -> torch.Tensor:
    """sum(x^2) * 1e-6 over the tensors of `tree`, in float32: the JAX
    scripts' cheap scalar head, so that a backward covers the sub-graph."""
    return sum(torch.sum(x.float() ** 2) * 1e-6 for x in tree_leaves(tree) if torch.is_tensor(x))


def gradient_of(loss_fn, params: dict[str, torch.Tensor]):
    """A function of the sub-graph's inputs that returns d loss / d params
    ({name: tensor}, zeros where the loss does not reach), as jax.grad."""
    names = list(params)

    def grad(*args):
        with torch.enable_grad():
            grads = torch.autograd.grad(loss_fn(*args), [params[n] for n in names], allow_unused=True)
        return {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)}

    return grad


def trainable(module: torch.nn.Module, prefix: str = "") -> dict[str, torch.Tensor]:
    """The parameters of `module`'s submodule `prefix` that take gradients, by their names in `module`."""
    sub = module.get_submodule(prefix)
    return {f"{prefix}.{n}" if prefix else n: p for n, p in sub.named_parameters() if p.requires_grad}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def union_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def busy_ms(fn) -> float:
    """The card's busy ms during one call of `fn`: the union of the device
    events' intervals in a torch.profiler trace of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    intervals = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    return union_us(intervals) / 1e3


def time_rows(rows, device: torch.device, iters: int, benchmarker: Benchmarker | None = None) -> list[dict]:
    """Time each (name, fn) of `rows`, as the module's docstring says; the
    peaks go into `benchmarker` (a new one if None) under the row's name."""
    bench = benchmarker or Benchmarker(device)
    out = []
    for name, fn in rows:
        fn()
        _sync(device)
        before = Counter(kernels.launches)
        host, dev = [], []
        for _ in range(iters):
            _sync(device)
            t0 = time.perf_counter()
            if device.type == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize(device)
                dev.append(start.elapsed_time(end))
            else:
                fn()
            host.append((time.perf_counter() - t0) * 1e3)
        launched = Counter(kernels.launches) - before
        busy = busy_ms(fn) if device.type == "cuda" else None
        with bench.memory(name):
            fn()
        memory = bench.memory_stats[name]
        host_ms = sum(host) / iters
        device_ms = sum(dev) / iters if dev else None
        out.append({
            "stage": name, "host_ms": host_ms, "device_ms": device_ms,
            "host_share": None if device_ms is None else 1.0 - device_ms / host_ms,
            "busy_ms": busy, "idle_share": None if busy is None else 1.0 - busy / host_ms,
            "host_ms_all": host, "device_ms_all": dev or None,
            "launches": {k: v / iters for k, v in sorted(launched.items())},
            "peak_bytes": memory.get("peak_bytes_in_use"), "peak_rise_bytes": memory.get("stage_peak_delta"),
        })
    return out


def print_rows(rows: list[dict]) -> None:
    width = max(len(r["stage"]) for r in rows) + 2
    print(f"{'stage':<{width}}{'host ms':>10}{'device ms':>11}{'host share':>12}{'busy ms':>9}{'idle':>8}"
          f"{'peak MB':>10}  launches per call")

    def cell(value, spec: str, width: int) -> str:
        return f"{'--' if value is None else format(value, spec):>{width}}"

    for r in rows:
        peak = None if r["peak_bytes"] is None else r["peak_bytes"] / 1e6
        launched = " ".join(f"{k}={v:g}" for k, v in r["launches"].items())
        print(f"{r['stage']:<{width}}{r['host_ms']:>10.2f}{cell(r['device_ms'], '.2f', 11)}"
              f"{cell(r['host_share'], '.1%', 12)}{cell(r['busy_ms'], '.2f', 9)}{cell(r['idle_share'], '.1%', 8)}"
              f"{cell(peak, '.1f', 10)}  {launched}")


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements of `t`: a dimension of stride 0 counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


class OpBytes(TorchDispatchMode):
    """Counts the bytes of the operations run under it (see the module's
    docstring): `aten_bytes`, `kernel_bytes` and their sum, `bytes`."""

    def __init__(self):
        super().__init__()
        self.aten_bytes = 0
        self.kernel_bytes = 0
        self._sizes: dict[int, int] = {}  # data pointer -> bytes of the tensor last seen there

    @property
    def bytes(self) -> int:
        return self.aten_bytes + self.kernel_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = [t for t in tree_leaves((args, kwargs, out)) if isinstance(t, torch.Tensor)]
        if not (func.is_view or func.__name__.split(".")[0] in _ALLOCATIONS):
            self.aten_bytes += sum(_distinct_bytes(t) for t in seen)
        for t in seen:
            if t.device.type == "cuda" and t.is_contiguous():
                self._sizes[t.data_ptr()] = t.numel() * t.element_size()
        return out

    def _launch(self, counter: str, args: tuple) -> None:
        self.kernel_bytes += sum(self._sizes.get(a, 0) for a in set(args) if isinstance(a, int) and a > 1 << 32)

    def __enter__(self):
        kernels.observers.append(self._launch)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.observers.remove(self._launch)
        return super().__exit__(*exc)
