"""transplat_tpu_torch — the PyTorch/CUDA port of transplat_tpu for NVIDIA Hopper.

Same function as the JAX package (posed context images -> per-pixel 3D
Gaussians -> rendered target views; the training step on them; fit ->
checkpoint -> evaluate), written for one H100:

  * geometry/    camera geometry, spherical harmonics, covariance math
  * ops/         tensor ops and the hand-written CUDA kernels' wrappers
                 (deformable score and value sampling, tile binning, tile
                 compositing, forward and backward), each beside a plain
                 PyTorch version of the same function
  * model/       nn.Modules: multi-view backbone, frozen DAv2 prior, depth
                 predictor, Gaussian adapter, splatting decoder; init.py
                 draws initial parameters as the Flax initialisers do
  * loss/        MSE, depth smoothness, LPIPS (VGG16, float32) and its
                 weight loader
  * training/    the training step (forward, backward, clip + Adam), the
                 learning-rate schedule, CheckpointManager, Trainer and the
                 weight-file loader (pretrained.py); train_demo.py takes a
                 few steps
  * evaluation/  PSNR / SSIM, the Evaluator (scores, timing JSONs, renders,
                 videos, PLY, analysis), the staged encoder, the offline
                 MetricComputer and the evaluation-index generator
  * dataset/     numpy batches: the RE10K / ACID / DTU chunk reader (JPEG
                 frames, or DTU's PNG frames), view samplers and shims,
                 DataLoader and MultiWorkerLoader, synthetic batches, the
                 golden scene, seeded chunks for tests
  * native/      JPEG decode (host libjpeg or the card's nvJPEG), PNG decode
                 (Pillow) and the image resizes, C++ built with the host
                 compiler at first use
  * parallel/    data parallelism (dp) and the view-sharded decode (sp) on
                 torch.distributed, one process per rank: the mesh, the
                 collectives, rank launching and dryrun_multichip
  * utils/       Benchmarker (stage timer: CUDA events on the card; a
                 torch.profiler trace), device_time, the workload analysis,
                 image and video files
  * visualization/  camera trajectories, PLY export, layout, colour map,
                 the validation's orthographic projections and camera wires
  * tools/       the reference's visual tools: test_splatter (a camera
                 spinning around random Gaussians) and
                 visualize_epipolar_lines (plane-sweep samples in view B)
  * convert/     JAX variable trees into the port's modules and back, and
                 the reference's PyTorch checkpoints into those trees
                 (convert_weights.py is its command line)
  * config.py    the typed configuration tree and the experiment presets
  * csrc/        CUDA C++ sources, built with nvcc for sm_90a at first use
  * inference.py the serving path (encoder -> decode_splatting -> colour)
  * overfit_golden.py  the golden-scene convergence gate
  * main.py      the command line: train (over ranks with --dp / --sp under
                 torchrun), test, generate-index, bench, compute-metrics
  * bench.py     the rasterizer and training-step benchmark

The entry points are exported here: render_novel_views, make_train_step,
Trainer, CheckpointManager, Evaluator, compute_psnr, compute_ssim,
load_config, golden_scene_batch, synthetic_batch.

Public functions keep the JAX package's layouts (NHWC images, (b, v, ...)
batches) so both can be held against each other on the same numpy inputs.
"""

__version__ = "0.3.0"

from .config import load_config  # noqa: E402
from .dataset import golden_scene_batch, synthetic_batch  # noqa: E402
from .evaluation import Evaluator, compute_psnr, compute_ssim  # noqa: E402
from .inference import render_novel_views  # noqa: E402
from .training import CheckpointManager, Trainer, make_train_step  # noqa: E402

__all__ = [
    "CheckpointManager", "Evaluator", "Trainer", "compute_psnr", "compute_ssim", "golden_scene_batch", "load_config",
    "make_train_step", "render_novel_views", "synthetic_batch",
]
