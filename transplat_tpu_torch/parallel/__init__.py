"""Data parallelism (dp) and the view-sharded decode (sp) on torch.distributed:
counterpart of transplat_tpu/parallel/ (mesh.py), one process per rank.
launch.py spawns ranks; dryrun.py is the counterpart of
`__graft_entry__.dryrun_multichip` and the parity runs of the tests."""

from .mesh import Mesh, batch_sharding, constrain, make_mesh, replicated, shard_batch

__all__ = ["Mesh", "batch_sharding", "constrain", "make_mesh", "replicated", "shard_batch"]
