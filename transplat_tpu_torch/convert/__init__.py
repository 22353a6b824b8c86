"""Weights into the port, in the JAX package's Flax tree layout.

Two halves, both counterparts of something in transplat_tpu:

  * `variables.py`: a JAX variable tree ({"params", "batch_stats"} of numpy
    arrays) into a port module and back (`load_jax_variables`,
    `to_jax_tree`).
  * `common`, `backbone`, `dav2`, `unet`, `uv`, `depth_predictor` and
    `encoder`: the port's own copies of transplat_tpu/convert/*.py, which
    turn the reference implementation's PyTorch state dicts (UniMatch,
    Depth-Anything-V2, a whole TranSplat Lightning checkpoint) into those
    trees, array for array as the JAX package's converters do. Numpy only;
    the command line is `python -m transplat_tpu_torch.convert_weights`.
"""

from .variables import load_jax_variables, to_jax_tree

__all__ = ["load_jax_variables", "to_jax_tree"]
