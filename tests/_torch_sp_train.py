"""`python -m transplat_tpu_torch.main ...` as torchrun runs it, with a
record of the batch that each training step of this rank takes: a SHA-256
of its views' tensors, one per step, written to `batches_rank<RANK>.json`
in the working directory. For tests/test_torch_parallel.py, which holds the
sp ranks of one dp group to one batch a step."""

import hashlib
import json
import os
import sys

from transplat_tpu_torch import main
from transplat_tpu_torch.training import trainer

_make_train_step = trainer.make_train_step


def make_train_step(*args, **kwargs):
    step = _make_train_step(*args, **kwargs)
    hashes = []

    def recorded(state, batch, generator=None):
        h = hashlib.sha256()
        for side in ("context", "target"):
            for k in sorted(batch[side]):
                h.update(k.encode() + batch[side][k].detach().cpu().numpy().tobytes())
        hashes.append(h.hexdigest())
        with open(f"batches_rank{os.environ['RANK']}.json", "w") as f:
            json.dump(hashes, f)
        return step(state, batch, generator)

    return recorded


trainer.make_train_step = make_train_step

if __name__ == "__main__":
    sys.exit(main.main(sys.argv[1:]))
