"""transplat_tpu_torch — the PyTorch/CUDA port of transplat_tpu for NVIDIA Hopper.

Same function as the JAX package (posed context images -> per-pixel 3D
Gaussians -> rendered target views, and the training step on them), written
for one H100:

  * geometry/    camera geometry, spherical harmonics, covariance math
  * ops/         tensor ops and the hand-written CUDA kernels' wrappers
                 (deformable score sampling, tile binning, tile compositing,
                 forward and backward), each beside a plain PyTorch version
                 of the same function
  * model/       nn.Modules: multi-view backbone, frozen DAv2 prior, depth
                 predictor, Gaussian adapter, splatting decoder
  * loss/        MSE, depth smoothness, LPIPS (VGG16, float32)
  * training/    the training step (forward, backward, clip + Adam) and the
                 learning-rate schedule; train_demo.py takes a few steps
  * csrc/        CUDA C++ sources, built with nvcc for sm_90a at first use
  * inference.py the serving path (encoder -> decode_splatting -> colour)

Public functions keep the JAX package's layouts (NHWC images, (b, v, ...)
batches) so both can be held against each other on the same numpy inputs.
"""

__version__ = "0.1.0"
