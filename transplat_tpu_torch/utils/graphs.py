"""CUDA graphs of a forward, one a signature of its inputs.

A forward whose launches and shapes all follow from its inputs' shapes and
a few host values launches the same kernels with the same arguments on
every call, so a CUDA graph can replay the whole chain for a few host
calls where an eager forward has the host dispatch every op (~1,900 in
TranSplat's encoder at re10k's widths). `GraphCache` keeps the graphs of a
handful of signatures and drops the least recently used first.

The first call of a signature runs the forward eagerly on a side stream and
returns what that computed. The eager pass also builds what a capture must
find built: cuBLAS's workspace for that stream, each lazily loaded kernel,
the constants of utils/constants.py. Then it captures the forward once more
into graphs that share one private memory pool; later calls replay them.
The capture is cut at every `trace.span`: a segment ends where a span opens
or closes, and the next begins. A replay opens the same spans around the
segments they held, so under torch.profiler every device op of a replay lies
under its span, tied to the `cudaGraphLaunch` that launched it. The counts
the captured pass adds (`trace.count`, `kernels.launches`) are taken back
after the capture and added again at every replay.

A replay copies the inputs into the graphs' static buffers and returns
copies of the outputs: the next replay writes the pool again, and a caller
may keep what a call returned. The graphs read the parameters' storage, so
an in-place update of the weights is seen; an owner that replaces its
tensors (`.to()`, a dtype cast) must `clear()` the cache. No capture starts
while a profiler runs: that call runs eagerly.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict

import torch
from torch.utils._pytree import tree_leaves, tree_map

from .. import kernels
from . import trace


def _copy(out):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, out)


class _Plan:
    """One signature's graphs in launch order, with the spans between them
    as (name, opens) steps, the static inputs and outputs, and the counts of
    one forward."""

    def __init__(self, inputs, steps, output, counts: dict, launches: dict):
        self.inputs, self.steps, self.output = inputs, steps, output
        self.counts, self.launches = counts, launches

    def replay(self, inputs):
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        opened = []
        for step in self.steps:
            if isinstance(step, tuple):
                name, opens = step
                if opens:
                    opened.append(trace.span(name))
                    opened[-1].__enter__()
                else:
                    opened.pop().__exit__(None, None, None)
            else:
                step.replay()
        for name, n in self.counts.items():
            trace.count(name, n)
        for name, n in self.launches.items():
            kernels.launches[name] = kernels.launches.get(name, 0) + n
        return _copy(self.output)


def capture(fn, inputs, stream: torch.cuda.Stream):
    """Run `fn(*inputs)` eagerly on `stream`, then capture it there into
    graphs cut at the spans; returns (the eager outputs, the plan)."""
    device = inputs[0].device
    current = torch.cuda.current_stream(device)
    static = [x.clone(memory_format=torch.contiguous_format) for x in inputs]
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn(*static)
    current.wait_stream(stream)
    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor):
            t.record_stream(current)  # made on the side stream, used on the caller's

    pool = torch.cuda.graph_pool_handle()
    steps: list = []
    graph = None

    def begin():
        nonlocal graph
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")

    def end():
        nonlocal graph
        done, graph = graph, None
        done.capture_end()
        steps.append(done)

    def cut(name: str, opens: bool):
        end()
        steps.append((name, opens))
        begin()

    counts, launches = {}, {}
    torch.cuda.synchronize(device)
    try:
        with torch.cuda.stream(stream), warnings.catch_warnings(), trace.withheld(counts), \
                trace.withheld(launches, kernels.launches):
            # A segment between two spans may launch nothing: its graph is empty.
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            begin()
            with trace.cut_at_spans(cut):
                output = fn(*static)
            end()
    except BaseException:
        if graph is not None:  # leave the stream's capture mode before raising
            try:
                graph.capture_end()
            except RuntimeError:
                pass
        raise
    return out, _Plan(static, steps, output, counts, launches)


class GraphCache:
    """Captured forwards by signature (`key`), at most `capacity`, the least
    recently used dropped first; counted as `<counter>.replay`, `.eager`
    (every call that did not replay) and `.captures` (trace.count)."""

    def __init__(self, counter: str, capacity: int = 4):
        self.counter, self.capacity = counter, capacity
        self._plans: OrderedDict = OrderedDict()
        self._streams: dict[torch.device, torch.cuda.Stream] = {}

    def clear(self) -> None:
        self._plans.clear()

    def __reduce__(self):  # a copy (deepcopy, pickle) starts empty: graphs and streams do not copy
        return GraphCache, (self.counter, self.capacity)

    def __len__(self) -> int:
        return len(self._plans)

    def __call__(self, key, fn, inputs):
        """`fn(*inputs)` for CUDA tensors `inputs`: a replay of the graphs of
        `key`, or, at its first call, the eager result while the graphs are
        captured (eagerly without a capture while a profiler runs)."""
        plan = self._plans.get(key)
        if plan is not None:
            self._plans.move_to_end(key)
            trace.count(f"{self.counter}.replay", 1)
            return plan.replay(inputs)
        trace.count(f"{self.counter}.eager", 1)
        if torch.autograd._profiler_enabled():
            return fn(*inputs)
        device = inputs[0].device
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        out, self._plans[key] = capture(fn, inputs, self._streams[device])
        trace.count(f"{self.counter}.captures", 1)
        while len(self._plans) > self.capacity:
            self._plans.popitem(last=False)
        return out
