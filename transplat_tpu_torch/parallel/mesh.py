"""The (dp, sp) process mesh and its sharding rules, on torch.distributed.

Counterpart of transplat_tpu/parallel/mesh.py, with one process per rank
(`torchrun`, or `parallel.launch.spawn`) where the JAX package has one
process driving every device through GSPMD:

  * dp: data parallel over the batch. Each rank holds its own slice of the
    batch (the loader stripes the chunks by dp rank), and the training step
    all-reduces the gradients as a mean over the world (training/step.py).
  * sp: splat parallel. The ranks of one dp group compute the same encoder
    forward, keep their slice of the Gaussian axis (`constrain`), all-gather
    it once at the decode boundary and render their own slice of the target
    views (model/decoder.py).

A rank's place is `rank = dp_rank * sp + sp_rank`, as JAX's
`devices.reshape(dp, sp)`. The backend is NCCL for ranks on cards and gloo
on the CPU. NCCL takes one card per rank; two ranks on one card are possible
only over gloo (`backend="gloo"` with a CUDA device), which moves CUDA
tensors through the host inside each collective.
"""

from __future__ import annotations

import os
import socket
import time
from collections import Counter
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..model.types import Gaussians

# torch 2.13 renamed the single-tensor collectives; torch 2.11 has the old names only.
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


@dataclass(eq=False)
class Mesh:
    """One rank's view of the (dp, sp) mesh: its coordinates, the process
    groups it belongs to and its device. `traffic` counts the bytes each
    collective of this rank moved (by name); `last_all_reduce` holds, by
    name, the bytes and CUDA events (or host seconds) of the latest
    `all_reduce_mean_` (the step's are "gradients" and "metrics")."""

    rank: int
    world: int
    dp: int
    sp: int
    dp_rank: int
    sp_rank: int
    dp_group: object  # ranks {d * sp + sp_rank}: the batch statistics' and the data's axis
    sp_group: object  # ranks {dp_rank * sp + s}: one dp group, one batch
    device: torch.device
    backend: str
    traffic: Counter = field(default_factory=Counter)
    last_all_reduce: dict = field(default_factory=dict)

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dp, "sp": self.sp}

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes checkpoints, metrics and media; the others wait at a barrier."""
        return self.rank == 0

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()

    def close(self) -> None:
        """Tear the process group down (the mesh is unusable afterwards).
        Every rank reaches the barrier first: a gloo rank torn down while
        its peers still talk to it aborts the process."""
        if dist.is_initialized():
            self.barrier()
            dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _init_process_group(backend: str, device: torch.device) -> None:
    """Join the process group that torchrun's environment describes (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), or make a group of one process
    when there is no such environment."""
    if dist.is_initialized():
        return
    kwargs = {"device_id": device} if backend == "nccl" else {}
    if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kwargs)


def _check_one_card_per_rank(device: torch.device) -> None:
    """NCCL fails inside ("Duplicate GPU detected") or hangs when two ranks
    share a card: compare the ranks' cards over a gloo group first."""
    props = torch.cuda.get_device_properties(device)
    mine = (socket.gethostname(), str(getattr(props, "uuid", device.index)))
    everyone: list = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine, group=dist.new_group(backend="gloo"))
    if len(set(everyone)) < len(everyone):
        raise RuntimeError(
            f"NCCL needs a card of its own for each rank; these ranks share one: {everyone}. Start one rank per card "
            "(torchrun --nproc-per-node <= the number of cards), or pass backend='gloo' to run ranks on one card"
        )


def make_mesh(dp: int | None = None, sp: int = 1, device: str | torch.device | None = None,
              backend: str | None = None) -> Mesh:
    """Build this rank's (dp, sp) mesh; dp defaults to world // sp.

    device: default `cuda:<LOCAL_RANK>`; without a card that raises, and a
    run on the CPU passes device="cpu". backend: default NCCL on a card,
    gloo on the CPU. Joins the process group of torchrun's environment if
    none is initialised (a group of one without that environment)."""
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA card; pass device=\"cpu\" to run the ranks on the CPU")
        device = f"cuda:{local_rank}"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the NCCL backend runs on cards: pass a CUDA device, or backend='gloo' on the CPU")
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {local_rank} on this host has no card of its own: {torch.cuda.device_count()} card(s); NCCL "
                "needs one card per rank (backend='gloo' runs several ranks on one card)"
            )
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _init_process_group(backend, device)
    n = dist.get_world_size()
    if dp is None:
        dp = n // sp
    assert dp * sp == n, f"dp({dp}) * sp({sp}) != devices({n})"
    if backend == "nccl" and n > 1:
        _check_one_card_per_rank(device)
    rank = dist.get_rank()
    dp_rank, sp_rank = divmod(rank, sp)
    # Every rank creates every group, in the same order.
    sp_groups = [dist.new_group([d * sp + s for s in range(sp)]) for d in range(dp)]
    dp_groups = [dist.new_group([d * sp + s for d in range(dp)]) for s in range(sp)]
    return Mesh(rank=rank, world=n, dp=dp, sp=sp, dp_rank=dp_rank, sp_rank=sp_rank, dp_group=dp_groups[sp_rank],
                sp_group=sp_groups[dp_rank], device=device, backend=backend)


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """This rank's slice of a global batch of `batch_size` examples: its dp
    block. JAX's NamedSharding(mesh, P("dp")) has no tensor counterpart here
    (a torch tensor lives whole on one device, and each rank holds only its
    own slice), so this names the slice a rank takes."""
    if batch_size % mesh.dp:
        raise ValueError(f"a batch of {batch_size} does not split over dp = {mesh.dp}")
    per = batch_size // mesh.dp
    return slice(mesh.dp_rank * per, (mesh.dp_rank + 1) * per)


def shard_batch(batch, mesh: Mesh, is_global: bool = False):
    """The batch this rank trains on. Each rank loads its own slice (the
    loader stripes the chunks by dp rank, as the multi-process branch of the
    JAX `shard_batch` assembles a global array from each process's local
    data), so a local batch passes through. Given the global batch
    (`is_global`, as single-process tests hold it), this picks the rank's dp
    slice of every array (and list, such as the scene names) of the tree."""
    if not is_global:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, True) for k, v in batch.items()}
    return batch[batch_sharding(mesh, len(batch))]


def _flat_by_dtype(tensors: list[torch.Tensor]) -> dict[torch.dtype, list[torch.Tensor]]:
    groups: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


@torch.no_grad()
def replicated(state, mesh: Mesh):
    """Rank 0's training state on every rank: its step, the encoder's
    parameters and buffers (BatchNorm statistics) and the Adam moments and
    count, broadcast in one buffer per dtype (JAX: device_put with a
    replicated sharding). Returns the state, updated in place."""
    if mesh.world == 1:
        return state
    tensors = list(state.encoder.state_dict().values())
    tensors += [state.opt_state.mu[k] for k in sorted(state.opt_state.mu)]
    tensors += [state.opt_state.nu[k] for k in sorted(state.opt_state.nu)]
    counts = torch.tensor([state.step, state.opt_state.count], dtype=torch.int64, device=mesh.device)
    tensors.append(counts)
    for dtype, group in _flat_by_dtype(tensors).items():
        flat = torch.cat([t.reshape(-1) for t in group])
        broadcast_(flat, mesh)
        offset = 0
        for t in group:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()
    state.step, state.opt_state.count = (int(x) for x in counts.tolist())
    return state


def broadcast_(tensor: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    dist.broadcast(tensor, src)
    mesh.traffic["broadcast"] += tensor.numel() * tensor.element_size()
    return tensor


@torch.no_grad()
def all_reduce_mean_(tensors: list[torch.Tensor], mesh: Mesh, name: str = "all_reduce") -> list[torch.Tensor]:
    """Replace each tensor by its mean over the world, in one all-reduce of
    a flat buffer per dtype. Its bytes and time go to
    `mesh.last_all_reduce[name]`: CUDA events around the collective on a
    card (`all_reduce_ms` reads them), host seconds on the CPU. A world of
    one has nothing to reduce: the tensors are returned as they are."""
    if mesh.world == 1:
        return tensors
    for dtype, group in _flat_by_dtype(tensors).items():
        flat = torch.cat([t.reshape(-1) for t in group])
        on_card = flat.is_cuda
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        nbytes = flat.numel() * flat.element_size()
        mesh.traffic[name] += nbytes
        if on_card:
            end.record()
            mesh.last_all_reduce[name] = {"bytes": nbytes, "events": (start, end)}
        else:
            mesh.last_all_reduce[name] = {"bytes": nbytes, "seconds": time.perf_counter() - t0}
        flat /= mesh.world
        offset = 0
        for t in group:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


def all_reduce_ms(mesh: Mesh, name: str = "gradients") -> float | None:
    """The milliseconds of the latest `all_reduce_mean_` of `name` (synchronises the card)."""
    rec = mesh.last_all_reduce.get(name, {})
    if "events" in rec:
        torch.cuda.synchronize()
        return rec["events"][0].elapsed_time(rec["events"][1])
    return rec["seconds"] * 1e3 if "seconds" in rec else None


class AllReduceSum(torch.autograd.Function):
    """Sum over `group`; the backward sums the gradient over the same group
    (an all-reduce's adjoint). For BatchNorm's batch statistics. Its own
    Function and not torch.distributed.nn.functional.all_reduce, which torch
    2.13 deprecates (a FutureWarning on every call) for a private module,
    and which would leave the traffic counts to the caller."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, mesh: Mesh) -> torch.Tensor:
        ctx.group, ctx.mesh = group, mesh
        out = x.detach().clone().contiguous()
        dist.all_reduce(out, group=group)
        mesh.traffic["batch_stats"] += out.numel() * out.element_size()
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        ctx.mesh.traffic["batch_stats_grad"] += grad.numel() * grad.element_size()
        return grad, None, None


class GatherSlices(torch.autograd.Function):
    """(b, g / sp, f) slices of the sp group -> (b, g, f), in sp-rank order
    (one all-gather). The backward sums the gradient of all g over the sp
    group and keeps this rank's slice: one reduce-scatter."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        b, per, f = x.shape
        parts = x.new_empty((mesh.sp * b, per, f))  # the sp slices stacked on the leading axis
        _all_gather_single(parts, x.detach().contiguous(), group=mesh.sp_group)
        mesh.traffic["all_gather"] += parts.numel() * parts.element_size()
        return parts.view(mesh.sp, b, per, f).transpose(0, 1).reshape(b, mesh.sp * per, f)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh = ctx.mesh
        b, g, f = grad.shape
        per = g // mesh.sp
        stacked = grad.reshape(b, mesh.sp, per, f).transpose(0, 1).reshape(mesh.sp * b, per, f)
        out = grad.new_empty((b, per, f))
        _reduce_scatter_single(out, stacked, group=mesh.sp_group)
        mesh.traffic["reduce_scatter"] += stacked.numel() * stacked.element_size()
        return out, None


def constrain(gaussians: Gaussians, mesh: Mesh | None) -> Gaussians:
    """This rank's slice of the Gaussian axis, (b, g / sp, ...): what the
    JAX step's `constrain(x, "dp", "sp")` keeps on each device up to the
    decode boundary. The whole tuple without a mesh or with sp = 1."""
    if mesh is None or mesh.sp == 1:
        return gaussians
    g = gaussians.means.shape[1]
    if g % mesh.sp:
        raise ValueError(f"{g} Gaussians do not split over sp = {mesh.sp}")
    per = g // mesh.sp
    return Gaussians(*(x[:, mesh.sp_rank * per : (mesh.sp_rank + 1) * per] for x in gaussians))


def gather_gaussians(local: Gaussians, mesh: Mesh) -> Gaussians:
    """All g Gaussians of the dp group's batch from each sp rank's slice, in
    one all-gather of the four fields packed side by side (`GatherSlices`)."""
    b, gl = local.means.shape[:2]
    fields = [local.means, local.covariances.reshape(b, gl, -1), local.harmonics.reshape(b, gl, -1),
              local.opacities[..., None]]
    widths = [f.shape[-1] for f in fields]
    full = GatherSlices.apply(torch.cat(fields, dim=-1), mesh)
    g = full.shape[1]
    means, cov, sh, opac = torch.split(full, widths, dim=-1)
    return Gaussians(means, cov.reshape(b, g, 3, 3), sh.reshape(b, g, *local.harmonics.shape[2:]), opac[..., 0])


def view_slice(num_views: int, mesh: Mesh | None) -> slice:
    """The target views this rank renders: its sp block when the views
    split over sp (JAX's condition, model/decoder.py), else all of them."""
    if mesh is None or mesh.sp == 1 or num_views % mesh.sp:
        return slice(0, num_views)
    per = num_views // mesh.sp
    return slice(mesh.sp_rank * per, (mesh.sp_rank + 1) * per)
