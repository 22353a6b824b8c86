"""What every kind of traffic mix's driver offers a run, and the default
window: a closed loop with one client.

A driver (`benchmark/harness/kinds/<kind>.py`, class `Driver`) builds the
program under test and its inputs from the cell and the seed, warms up the
shapes its traffic uses, runs one unit of work (`run_unit`), measures the
window (`window`), opens the benchmark's spans for the traced window
(`spans`), frees the program's state (`release`), compares the kept units
with the reference (`compare`), gives a unit's work counted on the
reference (`counts`) and the cell's end-to-end metrics (`end_to_end`).
"""

from __future__ import annotations

import contextlib
import random
import time

from .traffic import stream_seed

STREAM_SAMPLE = 21


def closed_loop(driver, seconds: float, sample: int, seed: int) -> tuple[list[float], float, list[dict]]:
    """Units back to back for `seconds`, the next one sent when the last has
    returned: (each unit's seconds, the window's seconds, the kept sample).
    The sample is a reservoir drawn from the seed, decided before each unit
    runs, so a kept unit is one the window drove like any other."""
    rng = random.Random(stream_seed(seed, STREAM_SAMPLE))
    kept: list[dict | None] = []
    latencies = []
    start = time.perf_counter()
    deadline = start + seconds
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        slot = i if i < sample else rng.randrange(i + 1)
        out = driver.run_unit(i, keep=slot < sample)
        latencies.append(time.perf_counter() - t0)
        if slot < sample:
            if slot < len(kept):
                kept[slot] = out
            else:
                kept.append(out)
        i += 1
    return latencies, time.perf_counter() - start, [k for k in kept if k is not None]


class Driver:
    """The base of every kind's driver; a kind overrides what differs."""

    traffic: dict

    def run_unit(self, i: int, keep: bool) -> dict | None:
        raise NotImplementedError

    def warm(self) -> None:
        """The mix's `warmup` units, which use every shape the window will."""
        for i in range(self.traffic["warmup"]):
            self.run_unit(i, keep=False)

    def window(self, seconds: float, sample: int, seed: int) -> tuple[list[float], float, list[dict]]:
        return closed_loop(self, seconds, sample, seed)

    @contextlib.contextmanager
    def spans(self):
        yield

    def release(self) -> None:
        pass
