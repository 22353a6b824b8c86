"""Stage-resolved encoder runs for profiling.

Counterpart of transplat_tpu/evaluation/staged.py. The JAX package re-drives
the encoder's Flax modules as ten separately jitted stage functions; here
the encoder's own forward runs its ten stages (model/encoder.py `STAGES`,
the reference's encoder_1 ... encoder_5 taxonomy) and the staged encoder
wraps each one in a Benchmarker's `memory` and `time` contexts: peak
allocator bytes and device time between CUDA events on the card, each stage
after the card has finished the one before. It takes the EncoderTranSplat
it runs, so there is one copy of the weights, and its Gaussians are the
fused encoder's bit for bit (the same operations in the same order).

XLA's `cost_analysis` / `memory_analysis` of the compiled stages have no
PyTorch counterpart: `cost_analysis` counts each stage's floating-point
operations with torch.utils.flop_counter.FlopCounterMode (matrix products,
convolutions and attention; elementwise operations and the hand-written
kernels count 0), its bytes with utils/stage_timing.py `OpBytes` (aten
operands and outputs, unfused, and the hand-written kernels' operands: an
upper bound of XLA's fused "bytes accessed") and the launches of each
hand-written kernel; `memory_analysis` gives the allocator's bytes of the
last timed run.
"""

from __future__ import annotations

import contextlib
import functools
from collections import Counter

import torch

from .. import kernels
from ..dataset.loader import CONTEXT_KEYS
from ..model.encoder import STAGES, EncoderTranSplat
from ..utils.benchmarker import Benchmarker
from ..utils.stage_timing import OpBytes

__all__ = ["STAGES", "StagedEncoder", "count_costs"]


@contextlib.contextmanager
def count_costs(tag: str, into: dict):
    """Count the block's FLOPs, bytes and kernel launches into `into[tag]`."""
    from torch.utils.flop_counter import FlopCounterMode

    flops, nbytes = FlopCounterMode(display=False), OpBytes()
    before = Counter(kernels.launches)
    with flops, nbytes:
        yield
    into[tag] = {
        "flops": int(flops.get_total_flops()), "bytes accessed": nbytes.bytes, "aten_bytes": nbytes.aten_bytes,
        "kernel_bytes": nbytes.kernel_bytes, "launches": dict(sorted((Counter(kernels.launches) - before).items())),
    }


class StagedEncoder:
    """Runs an EncoderTranSplat stage by stage (in eval mode, no gradients)."""

    def __init__(self, encoder: EncoderTranSplat):
        self.encoder = encoder
        self._last_args = None
        self._memory: dict[str, dict] = {}

    def _inputs(self, ctx: dict) -> tuple:
        device = next(self.encoder.parameters()).device
        return tuple(torch.as_tensor(ctx[k], device=device) for k in CONTEXT_KEYS)

    @torch.no_grad()
    def run(self, ctx: dict, benchmarker: Benchmarker | None = None, global_step: int = 0):
        """Encode the context views `ctx` (numpy arrays or tensors) stage by
        stage; time and measure each stage into `benchmarker` if given.
        Returns (gaussians, aux), aux as the encoder's `return_aux` gives it."""
        args = self._inputs(ctx)
        self._last_args = (args, global_step)

        def stage(tag: str):
            if benchmarker is None:
                return contextlib.nullcontext()
            stack = contextlib.ExitStack()
            stack.enter_context(benchmarker.memory(tag))
            stack.enter_context(benchmarker.time(tag))
            return stack

        gaussians, aux = self.encoder(*args, global_step=global_step, return_aux=True, stage=stage)
        if benchmarker is not None:
            self._memory = {t: benchmarker.memory_stats.get(t, {}) for t in STAGES}
        return gaussians, aux

    @torch.no_grad()
    def cost_analysis(self) -> dict:
        """{stage: {"flops": n, "bytes accessed": n, "aten_bytes": n,
        "kernel_bytes": n, "launches": {kernel: n}}} for the inputs of the
        last run(), each stage counted by its own modes in one more (untimed)
        run."""
        if self._last_args is None:
            raise RuntimeError("cost_analysis needs a run() first")
        counted: dict[str, dict] = {}
        args, global_step = self._last_args
        self.encoder(*args, global_step=global_step, return_aux=True, stage=functools.partial(count_costs, into=counted))
        return counted

    def memory_analysis(self) -> dict:
        """{stage: allocator bytes} of the last run() with a benchmarker:
        bytes in use before and after the stage, its peak and the peak's rise
        over the bytes in use before it (empty records on the CPU)."""
        return dict(self._memory)
