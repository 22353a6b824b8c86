from .evaluator import Evaluator
from .metrics import compute_psnr, compute_ssim

__all__ = ["Evaluator", "compute_psnr", "compute_ssim"]
