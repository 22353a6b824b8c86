"""Device time of the kernels that one call of a function launches, on the card.

    from transplat_tpu_torch.utils.device_time import device_time
    t = device_time(lambda: binning.bin_bwd(d_pair, lists, b, g, c), kernel="bin_bwd_atomic")
    t["device_ms"], t["kernel_ms"]

A CUDA event pair around one call of a Python wrapper times the host work of
the wrapper as well (argument checks, allocations, an autograd Function, a
ctypes call), and for a kernel of a few microseconds that is most of what it
reads. Here torch.profiler (CUDA activity) traces CALLS = 20 calls after a
warm-up of 3, each followed by a synchronize, so the calls' device events
(kernels, fills, copies) follow one another in time. Sorted by start, they
split into CALLS equal groups, one per call; every group must hold the same
sequence of kernel names (a function that launches the same work each call),
or it raises. The trace's device clock is not trusted to line up with the
host's (a kernel can read as starting outside the host range of the call that
launched it); a trace whose events do not split evenly is taken again (up
to ATTEMPTS times, and `attempts` says how many it took). The durations are
summed per call, and the median over calls is returned:

- `device_ms`: all device events of a call, the wrapper's fill and zero
  kernels (`torch.zeros`) included;
- `kernel_ms`: only the events whose name contains `kernel` (the
  hand-written kernel alone), or None when no name is given;
- `events`: each device event of a call in launch order, as [name, median
  ms], so a function of several kernels can be split into its parts.

With `cold=True` each call is preceded by a write of a FLUSH_BYTES buffer
(more than the H100's 50 MB L2), so the call finds its inputs in device
memory, not in L2; the write's own device event is left out of both times.
Without it the 20 calls run back to back and a function whose bytes fit in
L2 reads them from there: its time can then fall below a bound computed
from the device-memory rate.

    python -m transplat_tpu_torch.utils.device_time

measures what the profiler costs the host: the host microseconds per launch
of a tiny kernel, before any profiler window in the process, inside one and
after it closed (one JSON line).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

CALLS = 20
WARMUP = 3
# The profiler now and then returns fewer device events than the calls
# launched (8 for 20 calls, once in some 40 readings on an H100): a trace
# that does not split evenly into the calls is taken again.
ATTEMPTS = 3
# The write before each call of a cold reading: 128 MiB, over twice the L2.
FLUSH_BYTES = 128 * 2**20


def device_time(fn, kernel: str | None = None, cold: bool = False) -> dict:
    """Median device ms per call of fn() over CALLS calls (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda") if cold else None
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(1, ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                if cold:
                    flush.fill_(1.0)
                    torch.cuda.synchronize()
                fn()
                torch.cuda.synchronize()
        device = sorted(  # device work only: not the ranges that annotate it (autograd's, for one)
            (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == cuda and not getattr(e, "is_user_annotation", False)
        )
        if device and len(device) % CALLS == 0:
            break
    else:
        raise RuntimeError(f"device_time: {len(device)} device events do not split into {CALLS} calls")
    per = len(device) // CALLS
    groups = [device[i * per : (i + 1) * per] for i in range(CALLS)]
    if cold:  # each call's first event is the flush
        if any("Fill" not in grp[0][2] for grp in groups):
            raise RuntimeError(f"device_time: a cold call does not start with the flush: {groups[0][0][2]!r}")
        groups = [grp[1:] for grp in groups]
    names = [name for _, _, name in groups[0]]
    if any([name for _, _, name in grp] != names for grp in groups):
        raise RuntimeError("device_time: the calls launched different device work")

    if kernel is not None and not any(kernel in name for _, _, name in groups[0]):
        raise RuntimeError(f"device_time: no device event named like {kernel!r} in {[n for _, _, n in groups[0]]}")

    def median_ms(select) -> float:
        return float(np.median([sum(e - s for s, e, name in grp if select(name)) for grp in groups])) / 1e3

    return {
        "device_ms": median_ms(lambda name: True),
        "kernel_ms": None if kernel is None else median_ms(lambda name: kernel in name),
        "device_launches": len(groups[0]),
        "events": [[name, float(np.median([(grp[i][1] - grp[i][0]) for grp in groups])) / 1e3]
                   for i, name in enumerate(names)],
        "attempts": attempt,
    }


def _host_us_per_launch(x: torch.Tensor, launches: int = 2000) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        x.add_(1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / launches * 1e6


def main() -> int:
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("device_time: needs a CUDA card")
    x = torch.zeros(1024, device="cuda")
    for _ in range(5):  # warm-up
        _host_us_per_launch(x)
    before = [_host_us_per_launch(x) for _ in range(10)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        during = [_host_us_per_launch(x) for _ in range(3)]
    device_time(lambda: x.add_(1.0))
    after = [_host_us_per_launch(x) for _ in range(10)]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "host_us_per_launch": {
            "before_profiling": float(np.median(before)), "inside_a_profiler_window": float(np.median(during)),
            "after_profiling": float(np.median(after)),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
