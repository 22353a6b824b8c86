"""The port's native data path (transplat_tpu_torch.native) against Pillow and
the JAX package's native library.

Here the JPEG route is the host's libjpeg: its decode equals Pillow's bit for
bit, and its LANCZOS resize equals Pillow's and the JAX package's bit for
bit. The card's nvJPEG route is held on the card (tests/test_torch_cuda.py).
"""

import io

import numpy as np
import pytest
from PIL import Image

from transplat_tpu import native as jnative
from transplat_tpu_torch import native


def pil_jpeg(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def pil_decode(blob: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


def smooth(n, hw, seed=0):
    rng = np.random.default_rng(seed)
    coarse = (rng.random((n, hw[0] // 24 + 2, hw[1] // 24 + 2, 3)) * 255).astype(np.uint8)
    return native.resize_bilinear_batch(coarse, hw)


@pytest.fixture(scope="module")
def host_route():
    if not native.has_libjpeg():
        pytest.skip("no libjpeg header on this host: the host JPEG route cannot build")
    return "libjpeg"


def test_route_is_named():
    assert native.jpeg_route() in native.ROUTES
    if native.has_libjpeg():
        assert native.jpeg_route() == "libjpeg"
    with pytest.raises(ValueError, match="unknown JPEG route"):
        native.decode_jpeg_batch([pil_jpeg(smooth(1, (16, 16))[0])], route="pil")


@pytest.mark.parametrize("kw", [dict(quality=90), dict(quality=95, subsampling=0), dict(quality=75, progressive=True),
                                dict(quality=85, optimize=True)])
@pytest.mark.parametrize("hw", [(60, 80), (360, 640), (37, 53)])
def test_decode_equals_pillow(host_route, hw, kw):
    rng = np.random.default_rng(hw[0])
    imgs = [(rng.random((*hw, 3)) * 255).astype(np.uint8), smooth(1, hw, seed=1)[0], smooth(1, hw, seed=2)[0]]
    blobs = [pil_jpeg(im, **kw) for im in imgs]
    out = native.decode_jpeg_batch(blobs, route=host_route)
    assert out.dtype == np.uint8 and out.shape == (3, *hw, 3)
    np.testing.assert_array_equal(out, np.stack([pil_decode(b) for b in blobs]))
    assert all(native.jpeg_shape(b) == hw for b in blobs)
    np.testing.assert_array_equal(native.decode_jpeg_batch(blobs, route=host_route, num_threads=1), out)


def test_decode_grayscale_and_jax_native(host_route):
    gray = pil_jpeg(smooth(1, (40, 48))[0, :, :, 0])
    np.testing.assert_array_equal(native.decode_jpeg_batch([gray], route=host_route)[0], pil_decode(gray))
    blobs = [pil_jpeg(im, quality=92) for im in smooth(4, (72, 96), seed=3)]
    want = jnative.decode_jpeg_batch(blobs)
    if want is None:
        pytest.skip("the JAX package's native library did not build")
    np.testing.assert_array_equal(native.decode_jpeg_batch(blobs, route=host_route), want)


def test_corrupt_jpeg_raises(host_route):
    good = pil_jpeg(smooth(1, (32, 32))[0])
    for bad, match in ((b"not a jpeg", "does not decode"), (good[: len(good) // 2], "does not decode"),
                       (good[:2] + b"\xff\xc4" + b"\x00" * 8, "no frame header|does not decode")):
        with pytest.raises(ValueError, match=match):
            native.decode_jpeg_batch([good, bad], route=host_route)
    other = pil_jpeg(smooth(1, (32, 40))[0])  # another shape than the first
    with pytest.raises(ValueError, match="JPEG 1 of 2"):
        native.decode_jpeg_batch([good, other], route=host_route)
    with pytest.raises(ValueError, match="not a JPEG"):  # the shape is read from the first stream's header
        native.decode_jpeg_batch([b"not a jpeg"], route=host_route)
    with pytest.raises(ValueError, match="no JPEGs"):
        native.decode_jpeg_batch([], route=host_route)


def test_encode_round_trip(host_route):
    imgs = smooth(3, (64, 96), seed=4)
    blobs = native.encode_jpeg_batch(imgs, quality=95, route=host_route)
    dec = native.decode_jpeg_batch(blobs, route=host_route)
    np.testing.assert_array_equal(dec, np.stack([pil_decode(b) for b in blobs]))
    assert np.abs(dec.astype(np.float64) - imgs).mean() <= 2.0  # 2/255 at quality 95 on smooth images


@pytest.mark.parametrize("hw,out", [((90, 160), (64, 114)), ((64, 114), (96, 96)), ((50, 50), (64, 64)),
                                    ((360, 640), (256, 455)), ((7, 300), (5, 3))])
def test_lanczos_equals_pillow_and_jax_native(hw, out):
    imgs = np.random.default_rng(hw[1]).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    got = native.resize_lanczos_batch(imgs, out)
    want = np.stack([np.asarray(Image.fromarray(im).resize((out[1], out[0]), Image.LANCZOS)) for im in imgs])
    np.testing.assert_array_equal(got, want)
    jax_out = jnative.resize_lanczos_batch(imgs, out)
    if jax_out is not None:
        np.testing.assert_array_equal(got, jax_out)


def test_bilinear_equals_jax_native():
    imgs = np.random.default_rng(5).integers(0, 256, (3, 45, 61, 3), dtype=np.uint8)
    for out in ((30, 40), (90, 122), (45, 61)):
        got = native.resize_bilinear_batch(imgs, out)
        want = jnative.resize_bilinear_batch(imgs, out)
        assert got.shape == (3, *out, 3)
        if want is not None:
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.resize_bilinear_batch(np.full((2, 16, 16, 3), 127, np.uint8), (8, 8)),
                                  np.full((2, 8, 8, 3), 127, np.uint8))
    with pytest.raises(ValueError, match="uint8 images"):
        native.resize_bilinear_batch(imgs[0], (8, 8))


def test_builds_into_the_ignored_build_directory():
    lib = native._build("tp_resize", ("resize.cpp",))
    assert lib.exists() and lib.parent.parent == native._BUILD_ROOT
    assert native._BUILD_ROOT.parts[-2:] == ("_build", "native")
