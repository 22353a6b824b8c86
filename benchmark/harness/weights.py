"""Seeded weights, made on the device in two large draws.

The rule follows the port's seeded initialisation (`inference.init_random`),
so that random weights still give finite, varied Gaussians: linear and
convolution weights and biases U(+-1/sqrt(fan_in)); norm scales 1 and
shifts 0; layer scales 1; the ViT's class token and position table
N(0, 0.02); the UV matcher's cross-attention offsets and weights N(0, 0.02)
with N(0, 0.5) biases; the DAv2 depth head's last two biases moved up by 0.5
and 1; LPIPS's heads U(0, 0.1). Every value is drawn here, from the run's seed: the program and the
reference are handed the same tensors and neither initialises anything that
is compared.
"""

from __future__ import annotations

import torch
from torch import nn

from .traffic import stream_seed

STREAM_WEIGHTS = 11

_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d, nn.BatchNorm2d)
_DENSE = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)
_SHIFTS = {"da_model.depth_head.output_conv2_0.bias": 0.5, "da_model.depth_head.output_conv2_2.bias": 1.0}


def _plan(module: nn.Module) -> dict[str, tuple[str, float, float]]:
    """name -> (draw, scale, shift) for every parameter of `module`:
    draw "uniform" is U(-scale, scale), "normal" N(0, scale), "const" scale."""
    plan: dict[str, tuple[str, float, float]] = {}
    for mname, mod in module.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(mod, _DENSE):
            fan_in = mod.weight.shape[0] if isinstance(mod, nn.ConvTranspose2d) else mod.weight[0].numel()
            for pname, _ in mod.named_parameters(recurse=False):
                plan[prefix + pname] = ("uniform", fan_in**-0.5, 0.0)
        elif isinstance(mod, _NORMS):
            for pname, _ in mod.named_parameters(recurse=False):
                plan[prefix + pname] = ("const", 1.0 if pname == "weight" else 0.0, 0.0)
    for name, _ in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith(".gamma"):
            plan[name] = ("const", 1.0, 0.0)
        elif leaf in ("cls_token", "pos_embed"):
            plan[name] = ("normal", 0.02, 0.0)
        elif leaf.startswith("lin") and leaf[3:].isdigit():  # LPIPS's heads: U(0, 0.1)
            plan[name] = ("uniform", 0.05, 0.05)
        elif ".cross_attn.sampling_offsets." in name or ".cross_attn.attention_weights." in name:
            plan[name] = ("normal", 0.02 if leaf == "weight" else 0.5, 0.0)
    for name, shift in _SHIFTS.items():
        if name in plan:
            draw, scale, _ = plan[name]
            plan[name] = (draw, scale, shift)
    missing = [n for n, _ in module.named_parameters() if n not in plan]
    if missing:
        raise ValueError(f"no weight rule for {missing[:5]} ({len(missing)} parameters)")
    return plan


def seeded_parameters(module: nn.Module, seed: int, device, stream: int = STREAM_WEIGHTS) -> dict[str, torch.Tensor]:
    """A value for every parameter of `module` (which may live on the meta
    device: only names, shapes and module types are read), float32 on
    `device`, from `seed` (and a `stream` of its own for each module)."""
    plan = _plan(module)
    shapes = {n: p.shape for n, p in module.named_parameters()}
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, stream))
    sizes = {kind: sum(shapes[n].numel() for n, (d, _, _) in plan.items() if d == kind) for kind in ("uniform", "normal")}
    flat = {
        "uniform": torch.rand(sizes["uniform"], generator=gen, device=device).mul_(2.0).sub_(1.0),
        "normal": torch.randn(sizes["normal"], generator=gen, device=device),
    }
    offset = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape in shapes.items():
        draw, scale, shift = plan[name]
        if draw == "const":
            out[name] = torch.full(shape, scale + shift, device=device)
            continue
        n = shape.numel()
        value = flat[draw][offset[draw] : offset[draw] + n].view(shape).mul(scale)
        out[name] = value.add_(shift) if shift else value
        offset[draw] += n
    return out


def load_parameters(module: nn.Module, values: dict[str, torch.Tensor]) -> None:
    """Copy `values` into every parameter of `module`; raises where a name or a
    shape of the module differs from the values'."""
    params = dict(module.named_parameters())
    if set(params) != set(values):
        extra, missing = sorted(set(values) - set(params)), sorted(set(params) - set(values))
        raise ValueError(f"parameters differ: not in the module {extra[:5]}, without a value {missing[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != values[name].shape:
                raise ValueError(f"{name}: shape {tuple(p.shape)} != {tuple(values[name].shape)}")
            p.copy_(values[name])
