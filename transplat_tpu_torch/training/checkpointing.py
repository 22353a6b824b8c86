"""Step-tagged checkpoints: save, restore, keep the newest few.

Counterpart of transplat_tpu/training/checkpointing.py, with torch.save /
torch.load(weights_only=True) where the JAX package uses Orbax. One file
`step_<NNNNNNNN>.pt` per save, written under a temporary name and renamed,
so a reader never sees half a file. It holds the step, the encoder's
state_dict (parameters, the frozen DAv2 and the BatchNorm statistics) and
the Adam state (count, first and second moments by parameter name). LPIPS
is frozen and is not saved, as in the JAX package's use (its weights come
from their own file).
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

from .step import AdamState, TrainState

_NAME = re.compile(r"^step_(\d{8,})\.pt$")


class CheckpointManager:
    def __init__(self, directory: str | Path, every_n_steps: int = 20_000, max_to_keep: int | None = None):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.every_n_steps = every_n_steps
        self.max_to_keep = max_to_keep  # None keeps all

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step:08d}.pt"

    def all_steps(self) -> list[int]:
        steps = []
        for p in self.directory.iterdir():
            m = _NAME.match(p.name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def maybe_save(self, step: int, state: TrainState) -> bool:
        """Save when `step` is a multiple of `every_n_steps`; says whether it did."""
        if self.every_n_steps <= 0 or step % self.every_n_steps != 0 or self._path(step).exists():
            return False
        self._write(step, state)
        return True

    def save(self, step: int, state: TrainState) -> None:
        """Save now, whatever the interval. A second save at the latest step
        (resuming at max_steps, a re-entrant final save) returns quietly."""
        if self.latest_step() == step:
            return
        self._write(step, state)

    def _write(self, step: int, state: TrainState) -> None:
        payload = {
            "step": int(step),
            "encoder": state.encoder.state_dict(),
            "opt_state": {"count": int(state.opt_state.count), "mu": state.opt_state.mu, "nu": state.opt_state.nu},
        }
        tmp = self.directory / f".step_{step:08d}.pt.tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        if self.max_to_keep is not None:
            for old in self.all_steps()[: -self.max_to_keep]:
                self._path(old).unlink(missing_ok=True)

    def restore(self, state: TrainState, step: int | None = None) -> TrainState | None:
        """Load the checkpoint of `step` (default: the latest) into `state`,
        on the device its tensors live on, and return it; None when the
        directory holds no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        device = next(state.encoder.parameters()).device
        payload = torch.load(self._path(step), map_location=device, weights_only=True)
        state.encoder.load_state_dict(payload["encoder"])
        saved = payload["opt_state"]
        names = set(state.trainable())
        if set(saved["mu"]) != names or set(saved["nu"]) != names:
            raise ValueError("the checkpoint's optimizer state does not name this state's trainable parameters")
        state.opt_state = AdamState(int(saved["count"]), dict(saved["mu"]), dict(saved["nu"]))
        state.step = int(payload["step"])
        return state

    def wait(self) -> None:
        """Saves are synchronous: there is nothing to wait for."""
