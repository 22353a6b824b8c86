"""Rank functions of tests/test_torch_parallel.py, run in spawned processes
(transplat_tpu_torch.parallel.launch.spawn): importable without JAX."""

import torch
import torch.distributed as dist

from transplat_tpu_torch.parallel import batch_sharding, make_mesh, shard_batch


def mesh_layout(dp: int, sp: int) -> dict:
    """A rank's coordinates, the members of its groups (gathered over them),
    its slice of an 8-example batch, and the refusal of a mesh that does not
    cover the world."""
    mesh = make_mesh(dp, sp, device="cpu")
    members = {}
    for name, group in (("dp", mesh.dp_group), ("sp", mesh.sp_group)):
        out = [None] * dist.get_world_size(group)
        dist.all_gather_object(out, mesh.rank, group=group)
        members[name] = out
    batch = {"x": torch.arange(8), "scene": [f"s{i}" for i in range(8)]}
    local = shard_batch(batch, mesh, is_global=True)
    try:
        make_mesh(mesh.world + 1, 1, device="cpu")
        refusal = None
    except AssertionError as e:
        refusal = str(e)
    return {"rank": mesh.rank, "world": mesh.world, "dp_rank": mesh.dp_rank, "sp_rank": mesh.sp_rank,
            "shape": mesh.shape, "members": members, "slice": batch_sharding(mesh, 8), "x": local["x"].tolist(),
            "scene": local["scene"], "passes": shard_batch(batch, mesh) is batch, "refusal": refusal,
            "backend": mesh.backend}


def fail_on_rank(bad: int, hang: bool = False) -> int:
    """Rank `bad` raises (with `hang`: sleeps past any timeout); the others return their rank."""
    import os
    import time

    rank = int(os.environ["RANK"])
    if rank == bad:
        if hang:
            time.sleep(3600)
        raise ValueError(f"rank {rank} broke")
    return rank
