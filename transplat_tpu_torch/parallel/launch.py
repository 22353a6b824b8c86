"""Run a function on several ranks, one spawned process each, and collect
what each returns: the mesh's tests, `dryrun_multichip` and the card tests'
parallel steps. A rank finds torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT), so `make_mesh` inside it joins the
group. Processes are spawned, never forked: a parent that has touched CUDA
cannot fork a child that uses it.

`start_peers` starts ranks 1 .. world - 1 and returns at once, for a
caller that is rank 0 itself (`join_as_rank`) and drives the others, as the
benchmark's data-parallel training cell does.
"""

from __future__ import annotations

import os
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import free_port


def join_as_rank(rank: int, world: int, port: int, local: bool = True) -> None:
    """Give this process torchrun's environment for `rank` of `world` on this
    host (the group's store at localhost:`port`), so that `make_mesh` joins."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank if local else 0),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port))


def _rank_main(rank: int, fn, args: tuple, world: int, port: int, out_dir: str, threads: int, local: bool) -> None:
    join_as_rank(rank, world, port, local)
    torch.set_num_threads(threads)
    try:
        torch.save(fn(*args), Path(out_dir) / f"rank{rank}.pt")
        if dist.is_initialized():
            dist.barrier()  # no rank tears its group down while a peer still talks to it
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, *args, timeout_s: float = 600.0, threads: int = 1, local_ranks: bool = True) -> list:
    """fn(*args) on `world` spawned ranks (torch.multiprocessing); returns
    each rank's result (what fn returned, through torch.save: keep it on the
    CPU). `local_ranks`: each rank's LOCAL_RANK is its rank (one card each
    under NCCL); False gives every rank LOCAL_RANK 0. The first rank to fail
    raises here with its traceback, after the others are stopped; ranks that
    outlast `timeout_s` are stopped and raise TimeoutError."""
    with tempfile.TemporaryDirectory(prefix="ranks-") as out_dir:
        ctx = mp.start_processes(_rank_main, (fn, args, world, free_port(), out_dir, threads, local_ranks), world,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                alive = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"ranks {alive} of {world} ran past {timeout_s} s")
        return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _peer_main(index: int, fn, args: tuple, world: int, port: int, threads: int) -> None:
    join_as_rank(index + 1, world, port)
    torch.set_num_threads(threads)
    fn(*args)


def start_peers(fn, world: int, *args, port: int, threads: int = 1):
    """fn(*args) on ranks 1 .. world - 1, one spawned daemon process each
    (LOCAL_RANK = rank: one card each under NCCL), started and not waited
    for; the caller joins as rank 0 (`join_as_rank(0, world, port)`) and
    talks to them through the group. Returns the processes'
    `torch.multiprocessing` context: its `processes` tell whether a peer is
    still alive. Daemons: they end with the process that started them."""
    return mp.start_processes(_peer_main, (fn, args, world, port, threads), world - 1, join=False, daemon=True,
                              start_method="spawn")
