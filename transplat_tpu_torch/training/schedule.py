"""Learning-rate schedules, as plain functions of the step.

Counterpart of transplat_tpu/training/schedule.py, which builds them with
optax: `cosine_onecycle_schedule(transition_steps=max_steps + 10, peak_value
=lr, pct_start, div_factor=25, final_div_factor=1e4)` or a linear warm-up.
The one-cycle curve is written out here with optax's phase boundaries
(warm-up ends at step int(pct_start * transition_steps), annealing at
transition_steps); torch.optim.lr_scheduler.OneCycleLR places them at
pct_start * total - 1 and total - 1, which is another curve.
"""

from __future__ import annotations

import math
from typing import Callable


def make_lr_schedule(
    lr: float,
    max_steps: int,
    cosine: bool = True,
    warm_up_steps: int = 2000,
    pct_start: float = 0.01,
) -> Callable[[int], float]:
    """step -> learning rate."""
    if not cosine:
        init = lr / warm_up_steps

        def linear(step: int) -> float:
            frac = min(max(step, 0), warm_up_steps) / warm_up_steps
            return init + frac * (lr - init)

        return linear

    transition_steps = max_steps + 10
    div_factor, final_div_factor = 25.0, 1e4
    init = lr / div_factor
    end = init / final_div_factor
    boundary = int(pct_start * transition_steps)

    def cosine_decay(count: int, steps: int) -> float:
        """optax.cosine_decay_schedule(1.0, steps) at `count`."""
        count = min(max(count, 0), steps)
        return 0.5 * (1.0 + math.cos(math.pi * count / steps))

    def onecycle(step: int) -> float:
        # optax joins two piecewise-interpolated phases: each runs from its
        # start value to its end value along 1 - cosine_decay.
        if step < boundary:
            return init + (lr - init) * (1.0 - cosine_decay(step, boundary))
        return lr + (end - lr) * (1.0 - cosine_decay(step - boundary, transition_steps - boundary))

    return onecycle
