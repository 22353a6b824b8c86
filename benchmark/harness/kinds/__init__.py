"""One driver a kind of traffic mix, found by the mix's `kind`: the class
`Driver` of `benchmark/harness/kinds/<kind>.py`. A new kind is a new file.

  * serve.py  a request encodes context views and renders target views
  * view.py   a request renders one frame of Gaussians encoded at set-up
  * train.py  a unit is one training step
"""

from __future__ import annotations

import importlib
from pathlib import Path

KINDS_DIR = Path(__file__).resolve().parent


def find(kind: str):
    """The driver class of the traffic kind `kind`."""
    if not (KINDS_DIR / f"{kind}.py").is_file():
        known = sorted(p.stem for p in KINDS_DIR.glob("*.py") if p.stem != "__init__")
        raise FileNotFoundError(f"no driver for the traffic kind {kind!r} (known: {known})")
    return importlib.import_module(f"{__name__}.{kind}").Driver
