"""Build, load and count the hand-written CUDA kernels.

The CUDA C++ sources under csrc/ (`_SOURCES`: the samplers K5-K8, the
rasterizer's K1-K4, the Gaussian adapter stage, the render's projection
`project.cu`) have a plain C interface. At first use they
are compiled with nvcc for sm_90a (one nvcc per source, all started together)
and linked into one shared library, which is loaded with ctypes. The build
lands in _build/<hash of the sources>/ inside the package, so a checkout
builds itself and a changed source rebuilds. What ptxas says of each kernel
(registers, spills, shared memory: `-Xptxas -v`) stays beside the library
as <source stem>.ptxas.log.

Every C entry launches on the caller's CUDA stream, allocates nothing and
returns cudaGetLastError(); `call` raises if that is not 0.

`launches` counts, per kernel name, the launches the wrappers made. A run
resets it with `reset_launches()` and reads it afterwards to show which
kernels a path went through. `observers` are called with (counter, the C
entry's arguments) at each launch: utils/stage_timing.py counts the bytes of
the tensors a launch is given there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).parent / "csrc"
_BUILD_ROOT = Path(__file__).parent / "_build"
_SOURCES = (
    "deform_scores.cu", "deform_scores_bwd.cu", "binning.cu", "binning_bwd.cu",
    "composite.cu", "composite_bwd.cu", "deform_vectors.cu", "deform_vectors_bwd.cu", "gaussian_adapter.cu",
    "project.cu",
)
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # No fused multiply-add contraction: the kernels reproduce the plain
    # PyTorch (and JAX) float32 rounding of e.g. floor(loc * W - 0.5).
    "-fmad=false",
    "-Xptxas", "-v",
)

_P, _I, _LL, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_double
_SIGNATURES = {
    # scores, loc, aw, out, n_queries, h, w, d, p, stream
    "tp_deform_scores": (_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P),
    # gfeat, table, rects, aux, views, g, ntx, nty, tile, chunk, stream
    "tp_bin_count": (_P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P),
    # table, rowtot, ranges, aux, rows, chunks, stream
    "tp_bin_scan": (_P, _P, _P, _P, _LL, _I, _P),
    # rects, bases, ranges, idx, views, g, ntx, nty, chunk, stream
    "tp_bin_place": (_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P),
    # gfeat, colors, idx, ranges, order (or null), bg, out, t_final (or null), views, g, c, h, w, ntx, nty,
    # block_times (or null), stream
    "tp_composite": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # scores, loc, aw, gbar, d_scores, d_loc, d_aw, n_queries, h, w, d, p, path, stream
    "tp_deform_scores_bwd": (_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P),
    # gfeat, colors, idx, ranges, order (or null), bg, out, t_final, gout, d_pair, views, g, c, h, w, ntx, nty,
    # block_times (or null), stream
    "tp_composite_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # d_pair, idx, view_end, d_feat, n_pairs, row, views, g, stream
    "tp_bin_bwd": (_P, _P, _P, _P, _LL, _I, _I, _I, _P),
    # idx, ranges, rects, scratch, perm, offsets, n_pairs, views, g, ntx, nty, stream
    "tp_bin_bwd_order": (_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P),
    # d_pair, perm, offsets, d_feat, n_rows, n_pairs, row, stream
    "tp_bin_bwd_sorted": (_P, _P, _P, _P, _LL, _LL, _I, _P),
    # value, loc, aw, out, n_batch, q, h, w, c, p, stream
    "tp_deform_vectors": (_P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P),
    # value, loc, aw, gbar, d_value (or null), d_loc, d_aw, keys (or null), corner_w (or null),
    # n_batch, q, h, w, c, p, stream
    "tp_deform_vectors_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P),
    # keys, scratch, offsets, perm, n_batch, per_batch, hw, stream
    "tp_deform_vectors_bwd_order": (_P, _P, _P, _P, _LL, _LL, _I, _P),
    # gbar, corner_w, perm, offsets, d_value, n_rows, c, corners_per_query, stream
    "tp_deform_vectors_bwd_sorted": (_P, _P, _P, _P, _P, _LL, _I, _I, _P),
    # raw, depth, density, intr, extr, means, cov, harm, opac, scales (or null), rots (or null),
    # b, v, h, w, sh degree, raw's strides (b, v, pixel, channel), scale_min, scale_max - scale_min,
    # exponent, 1 / exponent, gaussians_per_pixel, samples a pixel, stream
    "tp_gaussian_adapter": (*(_P,) * 11, _I, _I, _I, _I, _I, _LL, _LL, _LL, _LL, _F, _F, _D, _D, _I, _I, _P),
    # extr, intr, near, means, cov, sh, opac, keys, rows, colors (or null), radii, sets, views a set,
    # Gaussians a set, sh degree, h, w, scale_invariant, stream
    "tp_project_gaussians": (*(_P,) * 11, _I, _I, _LL, _I, _I, _I, _I, _P),
}
# Entries that launch nothing (no stream argument): c, int[4] info out.
_QUERIES = {"tp_composite_attributes": (_I, _P), "tp_composite_bwd_attributes": (_I, _P)}

launches: dict[str, int] = {}
observers: list = []
_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    launches.clear()


def strict_float32() -> None:
    """Turn TF32 off for cuBLAS and cuDNN: the port computes in float32, as
    the plain versions and the reference do."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def kernel_route(*tensors: torch.Tensor | None) -> bool:
    """Whether a stage with a forward-only kernel takes it: every tensor given
    (None skipped) float32 on the card, and none requiring grad while
    autograd records (the kernel has no backward; training takes the plain
    version)."""
    given = [t for t in tensors if t is not None]
    if not all(t.is_cuda and t.dtype == torch.float32 for t in given):
        return False
    return not (torch.is_grad_enabled() and any(t.requires_grad for t in given))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in sorted(p.name for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh")):
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into the shared library (if not built yet) and return its path."""
    out_dir = _BUILD_ROOT / _source_hash()
    lib_path = out_dir / "libtransplat_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in _SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *_NVCC_FLAGS, "-c", str(_CSRC / src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            objs.append(str(obj))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src}:\n{log}")
            (out_dir / (Path(src).stem + ".ptxas.log")).write_text(log)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib_path.name
        subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", *objs, "-o", str(tmp_lib)],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builds agree
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in {**_SIGNATURES, **_QUERIES}.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def ptxas_log(stem: str) -> str:
    """What ptxas printed for csrc/<stem>.cu in the current build."""
    return (build().parent / f"{stem}.ptxas.log").read_text()


def query(name: str, *args) -> None:
    """Call a C entry that launches nothing (e.g. a kernel's attributes); raise on error."""
    err = getattr(load(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def call(name: str, counter: str, *args) -> None:
    """Launch C entry `name` on the current stream, count it under `counter`, raise on error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(load(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    launches[counter] = launches.get(counter, 0) + 1
    for observe in observers:
        observe(counter, args)


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int | None = None,
                      contiguous: bool = True) -> None:
    """Raise unless `t` is a CUDA tensor of `dtype` (and `ndim`), contiguous
    unless the kernel takes strides, that a raw launch may take: a launch
    records no graph, so a tensor that requires grad is refused while autograd
    is recording (the differentiable wrappers launch from inside their
    autograd.Function, where it is not)."""
    if t.requires_grad and torch.is_grad_enabled():
        raise ValueError(f"{name}: requires grad, and a raw kernel launch would cut the graph; use the differentiable wrapper")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
