"""Port parity: the host tools ``read`` and ``resize_image`` vs the JAX package.

PNGs of every colour type the reader takes (grey, RGB, palette, grey +
alpha, RGBA), at 1-16 bits, are written here with numpy + zlib and read
from a path and from ``io.BytesIO``: the port must give what JAX ``read``
(PIL's ``convert("RGB")``) gives, bit for bit. ``resize_image`` must be
bit-exact with JAX's up and down.
"""

import io
import struct
import zlib

import numpy as np
import pytest

from keras_ocr_tpu import tools as jtools
from keras_ocr_tpu_torch import tools


def _chunk(kind, body):
    return (
        struct.pack(">I", len(body)) + kind + body
        + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
    )


def _png(samples, color, depth, palette=None, interlace=0):
    """A PNG of (H, W[, C]) integer samples, every row filter 0."""
    height, width = samples.shape[:2]
    if depth == 16:
        rows = samples.astype(">u2").reshape(height, -1).view(np.uint8)
    elif depth == 8:
        rows = samples.astype(np.uint8).reshape(height, -1)
    else:
        per = 8 // depth
        packed = np.pad(samples.reshape(height, width).astype(np.uint8),
                        ((0, 0), (0, -width % per))).reshape(height, -1, per)
        shifts = (np.arange(per)[::-1] * depth).astype(np.uint8)
        rows = (packed << shifts).sum(-1).astype(np.uint8)
    data = b"".join(b"\x00" + row.tobytes() for row in rows)
    blob = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, interlace)
    )
    if palette is not None:
        blob += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return blob + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2),
         (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("color,depth", KINDS)
def test_read_png_kinds_match_jax(tmp_path, color, depth):
    rng = np.random.RandomState(color * 100 + depth)
    shape = (5, 11) if CHANNELS[color] == 1 else (5, 11, CHANNELS[color])
    samples = rng.randint(0, 2**depth, size=shape)
    if depth == 16:
        # Small values too: PIL clips 16-bit grey at 255, other kinds keep
        # the high byte.
        samples[0, :4] = np.array([0, 7, 255, 256]).reshape((4,) + (1,) * (samples.ndim - 2))
    palette = rng.randint(0, 256, size=(2**depth, 3)) if color == 3 else None
    blob = _png(samples, color, depth, palette)
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(blob)
    ref = jtools.read(path)
    for source in (path, io.BytesIO(blob)):
        out = tools.read(source)
        assert out.dtype == np.uint8 and out.shape == (5, 11, 3)
        np.testing.assert_array_equal(out, ref)


def test_read_buffer_of_a_golden_scene_matches_jax():
    import os

    path = os.path.join(os.path.dirname(__file__), "fixtures", "golden_offline", "scene_00.png")
    with open(path, "rb") as f:
        blob = f.read()
    np.testing.assert_array_equal(tools.read(io.BytesIO(blob)), jtools.read(io.BytesIO(blob)))


def test_read_refuses_what_it_cannot_decode():
    grey = np.zeros((3, 4), np.uint8)
    with pytest.raises(NotImplementedError, match="interlaced"):
        tools.read(io.BytesIO(_png(grey, 0, 8, interlace=1)))
    with pytest.raises(NotImplementedError, match="JPEG"):
        tools.read(io.BytesIO(b"\xff\xd8\xff\xe0" + bytes(16)))
    with pytest.raises(ValueError):
        tools.read(io.BytesIO(b"GIF89a"))
    with pytest.raises(ValueError):
        tools.read(12)


@pytest.mark.parametrize("shape", [(37, 53, 3), (120, 90, 3), (64, 200), (5, 7, 3)])
def test_resize_image_exact(shape):
    rng = np.random.RandomState(sum(shape))
    image = rng.randint(0, 256, size=shape).astype(np.uint8)
    for max_scale, max_size in ((2, 2048), (2, 100), (1, 60), (3, 17)):
        out, scale = tools.resize_image(image, max_scale=max_scale, max_size=max_size)
        ref, ref_scale = jtools.resize_image(image, max_scale=max_scale, max_size=max_size)
        assert scale == ref_scale
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)
