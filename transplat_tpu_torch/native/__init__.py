"""The data path's native code: JPEG decode (and encode, for tests and
chip_smoke.py) and the image resizes, bound with ctypes.

Counterpart of transplat_tpu/native/, split by what each part links:

  * resize.cpp       bilinear and LANCZOS (equal to Pillow's bit for bit);
                     no JPEG library
  * jpeg_host.cpp    the "libjpeg" route: threaded decode on the host; runs
                     in forked loader workers
  * jpeg_nvjpeg.cpp  the "nvjpeg" route: decode on the card with the CUDA
                     toolkit's nvJPEG, for hosts without libjpeg; runs only
                     in the process that owns the card

Each builds with the host compiler (c++) at first use into
transplat_tpu_torch/_build/native/<name>-<hash of sources, flags and the
host CPU's flags>/ (a copy of the tree on another machine builds anew).
`jpeg_route()` names the route this machine has: "libjpeg" where the host
compiler finds jpeglib.h, else "nvjpeg" where the CUDA toolkit has nvJPEG and
a card is present, else it raises and names both. Nothing falls back to
another decoder (the JAX package falls back to Pillow; the port does not),
and a stream that does not decode raises. PNG frames (the DTU chunks) are
no JPEG: `decode_png_batch` decodes them with Pillow on the host, as the
JAX reader does, and `image_shape` reads either format's header.
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

import numpy as np

_DIR = Path(__file__).parent
_BUILD_ROOT = _DIR.parent / "_build" / "native"
# -ffp-contract=off: the LANCZOS coefficients are computed in double as
# Pillow computes them, without fused multiply-adds, so they round alike.
_CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-std=c++17", "-shared", "-Wall")
ROUTES = ("libjpeg", "nvjpeg")

_P, _I, _SZ = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
_lock = threading.RLock()
_libs: dict[str, ctypes.CDLL] = {}
_route: str | None = None
_nvjpeg_ctx: dict[int, int] = {}  # CUDA device index -> nvJPEG context


def _cxx() -> str:
    for name in ("c++", "g++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: the native data path builds with one")


def _cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))


def _host_cpu() -> str:
    """The host CPU's instruction-set flags: -march=native builds for them."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), "")
    except OSError:
        return ""


def _build(name: str, sources: tuple[str, ...], flags: tuple[str, ...] = (), libs: tuple[str, ...] = ()) -> Path:
    """Compile `sources` into lib<name>.so (if not built yet for these
    sources, flags and host CPU); return its path."""
    h = hashlib.sha256(_host_cpu().encode())
    for src in (*sources, "parallel.h"):
        h.update(src.encode())
        h.update((_DIR / src).read_bytes())
    h.update(" ".join((*_CXX_FLAGS, *flags, *libs)).encode())
    out_dir = _BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"
    lib_path = out_dir / f"lib{name}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / lib_path.name
        cmd = [_cxx(), *_CXX_FLAGS, *flags, *(str(_DIR / s) for s in sources), "-o", str(tmp_lib), *libs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building lib{name}.so failed:\n{' '.join(cmd)}\n{proc.stderr[-4000:]}")
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builds agree
    return lib_path


def _load(name: str, build, signatures: dict) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:  # no lock: a forked worker may inherit it held by another thread
        return lib
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build()))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
    return _libs[name]


_RESIZE = (None, (_P, _I, _I, _I, _P, _I, _I, _I))


def _resize_lib() -> ctypes.CDLL:
    return _load(
        "tp_resize", lambda: _build("tp_resize", ("resize.cpp",)),
        {"tp_resize_bilinear_batch": _RESIZE, "tp_resize_lanczos_batch": _RESIZE},
    )


def _host_jpeg_lib() -> ctypes.CDLL:
    return _load(
        "tp_jpeg_host", lambda: _build("tp_jpeg_host", ("jpeg_host.cpp",), libs=("-ljpeg", "-lpthread")),
        {
            "tp_jpeg_decode_batch": (_I, (_P, _P, _P, _I, _P, _I, _I, _I)),
            "tp_jpeg_encode": (_I, (_P, _I, _I, _I, ctypes.POINTER(_P), ctypes.POINTER(ctypes.c_ulong))),
            "tp_jpeg_free": (None, (_P,)),
        },
    )


def _nvjpeg_lib() -> ctypes.CDLL:
    cuda = _cuda_home()
    flags = (f"-I{cuda / 'include'}",)
    libs = (f"-L{cuda / 'lib64'}", f"-Wl,-rpath,{cuda / 'lib64'}", "-lnvjpeg", "-lcudart")
    return _load(
        "tp_nvjpeg", lambda: _build("tp_nvjpeg", ("jpeg_nvjpeg.cpp",), flags, libs),
        {
            "tp_nvjpeg_create": (_P, (_P, ctypes.POINTER(_I))),
            "tp_nvjpeg_destroy": (None, (_P,)),
            "tp_nvjpeg_decode_batch": (_I, (_P, _P, _P, _P, _I, _P, _I, _I, _P)),
            "tp_nvjpeg_encode": (_I, (_P, _P, _I, _I, _I, _P, ctypes.POINTER(_SZ), _P)),
        },
    )


def has_libjpeg() -> bool:
    """Whether the host compiler finds libjpeg's header."""
    proc = subprocess.run(
        [_cxx(), "-E", "-x", "c++", "-"], input="#include <cstdio>\n#include <jpeglib.h>\n",
        capture_output=True, text=True,
    )
    return proc.returncode == 0


def has_nvjpeg() -> bool:
    """Whether the CUDA toolkit has nvJPEG and a CUDA card is present."""
    import torch

    cuda = _cuda_home()
    return (cuda / "include" / "nvjpeg.h").exists() and any((cuda / "lib64").glob("libnvjpeg.so*")) and (
        torch.cuda.is_available()
    )


def jpeg_route() -> str:
    """The JPEG route of this machine: "libjpeg" or "nvjpeg". Decided once,
    with its library and the resizes built and loaded, so that processes
    forked afterwards find them loaded."""
    global _route
    if _route is None:
        if has_libjpeg():
            route, load = "libjpeg", _host_jpeg_lib
        elif has_nvjpeg():
            route, load = "nvjpeg", _nvjpeg_lib
        else:
            raise RuntimeError(
                "no JPEG decoder: libjpeg's header (jpeglib.h) is not on the host compiler's include path, "
                f"and nvJPEG ({_cuda_home()}/include/nvjpeg.h, lib64/libnvjpeg.so) with a CUDA card is not "
                "there either"
            )
        load()
        _resize_lib()
        _route = route
    return _route


def route_runs_in_workers(route: str) -> bool:
    """Whether a forked loader worker may decode on `route` (only the host route: nvJPEG holds a CUDA context)."""
    return route == "libjpeg"


def jpeg_shape(blob: bytes) -> tuple[int, int]:
    """(height, width) from a JPEG's frame header, without decoding it."""
    if blob[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG: no start-of-image marker")
    i, n = 2, len(blob)
    while i + 4 <= n:
        if blob[i] != 0xFF:
            raise ValueError(f"corrupt JPEG: no marker at byte {i}")
        marker = blob[i + 1]
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:  # markers without a length
            i += 2
            continue
        # Start of frame: C0-CF but DHT (C4), JPG (C8) and DAC (CC).
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC) and i + 9 <= n:
            return int.from_bytes(blob[i + 5 : i + 7], "big"), int.from_bytes(blob[i + 7 : i + 9], "big")
        i += 2 + int.from_bytes(blob[i + 2 : i + 4], "big")
    raise ValueError("corrupt JPEG: no frame header")


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def is_png(blob: bytes) -> bool:
    return blob[:8] == PNG_SIGNATURE


def png_shape(blob: bytes) -> tuple[int, int]:
    """(height, width) from a PNG's IHDR chunk, without decoding it."""
    if not is_png(blob):
        raise ValueError("not a PNG: no signature")
    # The IHDR chunk comes first: length (4), type (4), width (4), height (4).
    if len(blob) < 24 or blob[12:16] != b"IHDR":
        raise ValueError("corrupt PNG: no IHDR chunk after the signature")
    return int.from_bytes(blob[20:24], "big"), int.from_bytes(blob[16:20], "big")


def image_shape(blob: bytes) -> tuple[int, int]:
    """(height, width) of a PNG or a JPEG from its header; raises ValueError for any other blob."""
    if is_png(blob):
        return png_shape(blob)
    if blob[:2] == b"\xff\xd8":
        return jpeg_shape(blob)
    raise ValueError("neither a PNG nor a JPEG: no PNG signature and no JPEG start-of-image marker")


def decode_png_batch(blobs: list[bytes]) -> np.ndarray:
    """Decode PNGs of one shape into (n, h, w, 3) uint8 RGB with Pillow, as
    the JAX reader decodes the DTU chunks' frames. Pillow holds no CUDA
    context, so this runs on the host on both JPEG routes, in forked loader
    workers too."""
    import io

    from PIL import Image

    out = []
    for i, blob in enumerate(blobs):
        if not is_png(blob):
            raise ValueError(f"image {i} of {len(blobs)} is not a PNG")
        with Image.open(io.BytesIO(blob)) as img:
            out.append(np.asarray(img.convert("RGB"), dtype=np.uint8))
    if any(x.shape != out[0].shape for x in out):
        raise ValueError(f"PNGs of different shapes: {sorted({x.shape for x in out})}")
    return np.stack(out)


def _threads(num_threads: int | None) -> int:
    return num_threads if num_threads is not None else min(os.cpu_count() or 4, 16)


def _nvjpeg_context(device_index: int, stream: int) -> int:
    with _lock:
        if device_index not in _nvjpeg_ctx:
            status = ctypes.c_int()
            ctx = _nvjpeg_lib().tp_nvjpeg_create(stream, ctypes.byref(status))
            if status.value != 0:
                _nvjpeg_lib().tp_nvjpeg_destroy(ctx)
                raise RuntimeError(f"nvJPEG: creating a decoder failed with status {status.value}")
            _nvjpeg_ctx[device_index] = ctx
    return _nvjpeg_ctx[device_index]


def decode_jpeg_batch(blobs: list[bytes], route: str | None = None, num_threads: int | None = None) -> np.ndarray:
    """Decode JPEGs of one shape into (n, h, w, 3) uint8 RGB on the host.

    `route`: "libjpeg" (threaded, on the host) or "nvjpeg" (on the current
    CUDA device, then copied back); default `jpeg_route()`. Raises
    ValueError for a blob that is not a JPEG of the first one's shape or
    does not decode cleanly."""
    route = route or jpeg_route()
    if route not in ROUTES:
        raise ValueError(f"unknown JPEG route {route!r}; expected one of {ROUTES}")
    if not blobs:
        raise ValueError("no JPEGs to decode")
    h, w = jpeg_shape(blobs[0])
    n = len(blobs)
    data = b"".join(blobs)
    sizes = np.asarray([len(b) for b in blobs], np.int64)
    offsets = np.zeros(n, np.int64)
    offsets[1:] = np.cumsum(sizes)[:-1]
    if route == "libjpeg":
        out = np.empty((n, h, w, 3), np.uint8)
        failed = _host_jpeg_lib().tp_jpeg_decode_batch(
            data, offsets.ctypes.data, sizes.ctypes.data, n, out.ctypes.data, h, w, _threads(num_threads)
        )
    else:
        import torch

        dev = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.current_stream(dev).cuda_stream
        ctx = _nvjpeg_context(dev.index, stream)
        # nvJPEG decodes a truncated stream without an error: require each stream's end-of-image marker.
        cut = [i for i, b in enumerate(blobs) if b"\xff\xd9" not in b[-32:]]
        if cut:
            raise ValueError(f"JPEG {cut[0]} of {n} has no end-of-image marker (truncated)")
        out_dev = torch.empty((n, h, w, 3), dtype=torch.uint8, device=dev)
        with _lock:  # one nvJPEG state per device
            failed = _nvjpeg_lib().tp_nvjpeg_decode_batch(
                ctx, data, offsets.ctypes.data, sizes.ctypes.data, n, out_dev.data_ptr(), h, w, stream
            )
        out = out_dev.cpu().numpy()
    if failed:
        raise ValueError(f"JPEG {failed - 1} of {n} does not decode cleanly to {h}x{w} RGB ({route})")
    return out


def encode_jpeg_batch(images: np.ndarray, quality: int = 95, route: str | None = None) -> list[bytes]:
    """Encode (n, h, w, 3) uint8 RGB images as JPEGs (4:2:0) with the
    library of `route` (default `jpeg_route()`), so that data written for a
    test decodes with the same library. For tests and chip_smoke.py."""
    route = route or jpeg_route()
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, _ = images.shape
    blobs = []
    if route == "libjpeg":
        lib = _host_jpeg_lib()
        for img in images:
            ptr, size = ctypes.c_void_p(), ctypes.c_ulong()
            if lib.tp_jpeg_encode(img.ctypes.data, h, w, quality, ctypes.byref(ptr), ctypes.byref(size)) != 0:
                raise RuntimeError("libjpeg: encoding failed")
            blobs.append(ctypes.string_at(ptr, size.value))
            lib.tp_jpeg_free(ptr)
        return blobs
    if route != "nvjpeg":
        raise ValueError(f"unknown JPEG route {route!r}; expected one of {ROUTES}")
    import torch

    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    ctx = _nvjpeg_context(dev.index, stream)
    on_card = torch.from_numpy(images).to(dev)
    buf = ctypes.create_string_buffer(h * w * 3 + 65536)
    for i in range(n):
        size = ctypes.c_size_t(len(buf))
        with _lock:
            status = _nvjpeg_lib().tp_nvjpeg_encode(
                ctx, on_card[i].data_ptr(), h, w, quality, buf, ctypes.byref(size), stream
            )
        if status == -2:
            raise RuntimeError(f"nvJPEG: an encoded image needs {size.value} bytes, more than {len(buf)}")
        if status != 0:
            raise RuntimeError(f"nvJPEG: encoding failed with status {status}")
        blobs.append(buf.raw[: size.value])
    return blobs


def _resize(fn: str, images: np.ndarray, out_shape: tuple[int, int], num_threads: int | None) -> np.ndarray:
    images = np.ascontiguousarray(images, np.uint8)
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"expected (n, h, w, 3) uint8 images, got shape {images.shape}")
    n, h, w, _ = images.shape
    h2, w2 = out_shape
    out = np.empty((n, h2, w2, 3), np.uint8)
    getattr(_resize_lib(), fn)(images.ctypes.data, n, h, w, out.ctypes.data, h2, w2, _threads(num_threads))
    return out


def resize_bilinear_batch(images: np.ndarray, out_shape: tuple[int, int], num_threads: int | None = None) -> np.ndarray:
    """(n, h, w, 3) u8 -> (n, h2, w2, 3) u8, half-pixel bilinear."""
    return _resize("tp_resize_bilinear_batch", images, out_shape, num_threads)


def resize_lanczos_batch(images: np.ndarray, out_shape: tuple[int, int], num_threads: int | None = None) -> np.ndarray:
    """(n, h, w, 3) u8 -> (n, h2, w2, 3) u8, equal to Pillow's
    Image.resize(..., Image.LANCZOS) bit for bit (its fixed-point separable
    convolution, a uint8 intermediate between the passes)."""
    return _resize("tp_resize_lanczos_batch", images, out_shape, num_threads)
