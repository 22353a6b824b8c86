"""Convert the reference implementation's PyTorch checkpoints into the trees
the port's weight loaders read.

    python -m transplat_tpu_torch.convert_weights SOURCE --kind KIND --out OUT.npy [--encoder vitb] [--dry-run]

The port's counterpart of scripts/convert_weights.py; the same arguments and
the same .npy, so a file either command writes is one both packages load:
  * --kind unimatch : UniMatch gmdepth checkpoint -> the backbone's CNN and
                      matching transformer (a partial tree; the camera
                      encoder keeps its initial values)
  * --kind dav2     : Depth-Anything-V2 (vits / vitb / vitl, --encoder) ->
                      the frozen depth prior, model.da_model
  * --kind lpips    : lpips(net='vgg') state dict -> the LPIPS weights
  * --kind lightning: a whole TranSplat Lightning checkpoint -> the whole
                      encoder, plus the `losses.*` LPIPS buffers it embeds
                      under `lpips_state`

OUT is a pickled dict of numpy arrays (np.load(OUT, allow_pickle=True).item())
for `checkpointing.pretrained_model` (unimatch, lightning), `dav2_weights`
(dav2) or `lpips_weights` (lpips). --dry-run prints each leaf's path and
shape, in the order the JAX package's tree walk gives, and writes nothing.
Runs on the host, with numpy and torch (to read the checkpoint); no JAX.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .convert.backbone import convert_unimatch_checkpoint
from .convert.dav2 import convert_dav2
from .convert.encoder import convert_lightning_checkpoint


def convert_lpips(sd: dict) -> dict:
    """lpips(net='vgg') torch state dict -> the flat numpy dict that
    loss.vgg.load_lpips_weights reads (keys kept verbatim)."""
    wanted = {
        k: np.asarray(v)
        for k, v in sd.items()
        if ("net." in k or k.startswith(("lin", "scaling_layer")) or "features" in k)
    }
    if not wanted:
        raise ValueError("no lpips VGG keys found in checkpoint")
    return wanted


def tree_leaves(tree, path: tuple = ()):
    """(path, leaf) of a nested dict in the order of jax.tree_util's walk:
    keys sorted, empty dicts and None holding no leaf."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key], path + (key,))
    elif tree is not None:
        yield path, tree


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("source", help="torch checkpoint (.pth/.ckpt)")
    parser.add_argument("--kind", choices=["dav2", "unimatch", "lpips", "lightning"], required=True)
    parser.add_argument("--encoder", default="vitb", help="DAv2 variant (dav2 kind)")
    parser.add_argument("--out", required=True, help="output .npy path")
    parser.add_argument("--dry-run", action="store_true", help="print the converted tree and exit")
    args = parser.parse_args(argv)

    ckpt = torch.load(args.source, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    sd = {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
    if args.kind == "dav2":
        out = convert_dav2(sd, encoder=args.encoder)
    elif args.kind == "unimatch":
        out = convert_unimatch_checkpoint(sd)
    elif args.kind == "lightning":
        # Converted whole, so a Lightning checkpoint's `losses.*` entries stay as torch.load gave them.
        out = convert_lightning_checkpoint(ckpt if "state_dict" in ckpt else sd)
    else:
        out = convert_lpips(sd)
    if args.dry_run:
        for path, leaf in tree_leaves(out):
            print("/".join(str(p) for p in path), leaf.shape)
        return 0
    np.save(args.out, out, allow_pickle=True)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
