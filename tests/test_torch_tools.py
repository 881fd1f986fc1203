"""Port parity: the host tools ``read`` and ``resize_image`` vs the JAX package.

PNGs of every colour type the reader takes (grey, RGB, palette, grey +
alpha, RGBA), at 1-16 bits, plain and Adam7-interlaced (every filter type,
sizes down to 1x1 whose passes are partly empty), are written here with
numpy + zlib and read from a path and from ``io.BytesIO``: the port must
give what JAX ``read`` (PIL's ``convert("RGB")``) gives, bit for bit.
Progressive JPEGs PIL writes here (quality 50, 90 and 95; grey, 4:2:0,
4:2:2 and 4:4:4; restart intervals; odd sizes) must equal JAX ``read`` bit
for bit, and the committed fixtures ``progressive.jpg`` and
``interlaced.png`` must decode to the recorded sha256 of PIL's decode. JPEGs (the repository's
``tests/fixtures/test_image.jpg``, and JPEGs PIL writes here: 4:4:4, 4:2:2
and 4:2:0, quality 50 and 95, optimised Huffman tables, grey, odd sizes,
restart intervals; a 4:4:0 one from OpenCV) must come within 1 count of
JAX ``read`` and be exact on at least 99.9% of pixels; measured: every
pixel of every case exact. ``read`` fetches ``http(s)://`` paths with
``urllib``. ``resize_image`` must be bit-exact with JAX's up and down.
"""

import hashlib
import io
import os
import struct
import urllib.request
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


def _packed_rows(samples, depth):
    """(H, W[, C]) integer samples as (H, bytes) scanlines."""
    height, width = samples.shape[:2]
    if depth == 16:
        return samples.astype(">u2").reshape(height, -1).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(height, -1)
    per = 8 // depth
    packed = np.pad(samples.reshape(height, width).astype(np.uint8),
                    ((0, 0), (0, -width % per))).reshape(height, -1, per)
    shifts = (np.arange(per)[::-1] * depth).astype(np.uint8)
    return (packed << shifts).sum(-1).astype(np.uint8)


def _png(samples, color, depth, palette=None, interlace=0):
    """A PNG of (H, W[, C]) integer samples, every row filter 0."""
    height, width = samples.shape[:2]
    data = b"".join(b"\x00" + row.tobytes() for row in _packed_rows(samples, depth))
    blob = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, interlace)
    )
    if palette is not None:
        blob += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return blob + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered(rows, bpp, first_filter):
    """Scanlines with their filter bytes, the filter types cycling 0-4 from
    ``first_filter``; the first line's prior line is zeros."""
    out = []
    prior = np.zeros(rows.shape[1], np.int64)
    for r, row in enumerate(rows.astype(np.int64)):
        kind = (first_filter + r) % 5
        line = bytearray()
        for i, x in enumerate(row):
            a = int(row[i - bpp]) if i >= bpp else 0
            b, c = int(prior[i]), int(prior[i - bpp]) if i >= bpp else 0
            line.append((int(x) - (0, a, b, (a + b) >> 1, _paeth(a, b, c))[kind]) & 0xFF)
        out.append(bytes([kind]) + bytes(line))
        prior = row
    return b"".join(out)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _adam7_png(samples, color, depth, palette=None):
    """An Adam7-interlaced PNG of (H, W[, C]) integer samples: each pass
    packed and filtered alone (a pass with no pixel has no scanline), the
    filters of pass i starting at type i % 5."""
    height, width = samples.shape[:2]
    bpp = max(1, CHANNELS[color] * depth // 8)
    data = b""
    for index, (x0, y0, dx, dy) in enumerate(ADAM7):
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:
            data += _filtered(_packed_rows(sub, depth), bpp, index)
    blob = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, 1))
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


@pytest.mark.parametrize("color,depth", KINDS)
def test_read_adam7_png_kinds_match_jax(tmp_path, color, depth):
    """Adam7 at sizes whose later passes are empty (1x1, 2x3) or partial."""
    for height, width in ((1, 1), (2, 3), (5, 11), (9, 17)):
        rng = np.random.RandomState(color * 100 + depth + height)
        shape = (height, width) if CHANNELS[color] == 1 else (height, width, CHANNELS[color])
        samples = rng.randint(0, 2**depth, size=shape)
        palette = rng.randint(0, 256, size=(2**depth, 3)) if color == 3 else None
        blob = _adam7_png(samples, color, depth, palette)
        path = str(tmp_path / f"x{height}.png")
        with open(path, "wb") as f:
            f.write(blob)
        ref = jtools.read(path)
        for source in (path, io.BytesIO(blob)):
            out = tools.read(source)
            assert out.dtype == np.uint8 and out.shape == (height, width, 3)
            np.testing.assert_array_equal(out, ref)


def test_read_buffer_of_a_golden_scene_matches_jax():
    import os

    path = os.path.join(os.path.dirname(__file__), "fixtures", "golden_offline", "scene_00.png")
    with open(path, "rb") as f:
        blob = f.read()
    np.testing.assert_array_equal(tools.read(io.BytesIO(blob)), jtools.read(io.BytesIO(blob)))


def test_read_refuses_what_it_cannot_decode():
    grey = np.zeros((3, 4), np.uint8)
    with pytest.raises(ValueError, match="interlace method 2"):
        tools.read(io.BytesIO(_png(grey, 0, 8, interlace=2)))
    with pytest.raises(ValueError, match="truncated"):
        tools.read(io.BytesIO(_png(grey, 0, 8, interlace=1)))
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


FIXTURE_JPEG = os.path.join(os.path.dirname(__file__), "fixtures", "test_image.jpg")
# sha256 of PIL's RGB decode of the fixture: chip_smoke.py checks the port's
# decode against it on the card's machine, which has no PIL.
FIXTURE_JPEG_SHA256 = "f5cb48dc1b0a224b4e16c418b92a2e0b851364882e21645efdd244d0fc3207c4"


def _scene_crop(height, width, mode="RGB"):
    from PIL import Image

    image = jtools.read(FIXTURE_JPEG)[100 : 100 + height, 200 : 200 + width]
    return Image.fromarray(np.ascontiguousarray(image)).convert(mode)


def _pil_jpeg(image, **options):
    buffer = io.BytesIO()
    image.save(buffer, "JPEG", **options)
    return buffer.getvalue()


def _assert_jpeg_close(out, ref):
    """Within 1 count, exact on at least 99.9% of pixels."""
    assert out.dtype == np.uint8 and out.shape == ref.shape
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).all(-1).mean() >= 0.999


def test_read_jpeg_fixture_matches_jax(tmp_path):
    """The reference's test image: baseline, 640x480, 4:2:2 (h2v1 luma),
    restart intervals. By path and from a buffer."""
    ref = jtools.read(FIXTURE_JPEG)
    assert ref.shape == (480, 640, 3)
    assert hashlib.sha256(ref.tobytes()).hexdigest() == FIXTURE_JPEG_SHA256
    with open(FIXTURE_JPEG, "rb") as f:
        blob = f.read()
    for source in (FIXTURE_JPEG, io.BytesIO(blob)):
        _assert_jpeg_close(tools.read(source), ref)


JPEG_CASES = {
    "444_q95": ((37, 53), "RGB", dict(subsampling=0, quality=95)),
    "422_q95": ((37, 53), "RGB", dict(subsampling=1, quality=95)),
    "420_q95": ((37, 53), "RGB", dict(subsampling=2, quality=95)),
    "444_q50": ((37, 53), "RGB", dict(subsampling=0, quality=50)),
    "422_q50": ((37, 53), "RGB", dict(subsampling=1, quality=50)),
    "420_q50": ((37, 53), "RGB", dict(subsampling=2, quality=50)),
    "420_optimize": ((64, 80), "RGB", dict(subsampling=2, optimize=True)),
    "grey": ((37, 53), "L", dict(quality=80)),
    "grey_optimize_1x1": ((1, 1), "L", dict(optimize=True)),
    "420_1x1": ((1, 1), "RGB", dict(subsampling=2)),
    "422_2x3": ((2, 3), "RGB", dict(subsampling=1)),
    "420_17x200": ((17, 200), "RGB", dict(subsampling=2)),
    "422_17x200": ((17, 200), "RGB", dict(subsampling=1)),
    "420_restart": ((48, 70), "RGB", dict(subsampling=2, restart_marker_blocks=3)),
    "grey_restart_rows": ((33, 41), "L", dict(restart_marker_rows=1)),
}


@pytest.mark.parametrize("case", list(JPEG_CASES))
def test_read_pil_written_jpeg_matches_jax(tmp_path, case):
    shape, mode, options = JPEG_CASES[case]
    blob = _pil_jpeg(_scene_crop(*shape, mode), **options)
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(blob)
    ref = jtools.read(path)
    for source in (path, io.BytesIO(blob)):
        _assert_jpeg_close(tools.read(source), ref)


@pytest.mark.parametrize("shape", [(37, 53), (1, 1), (17, 200)])
def test_read_h1v2_jpeg_matches_jax(shape):
    """4:4:0 (luma sampled 1x2): libjpeg-turbo's h1v2 fancy upsampling.
    PIL cannot write it; OpenCV can."""
    cv2 = pytest.importorskip("cv2")
    image = np.ascontiguousarray(np.asarray(_scene_crop(*shape))[..., ::-1])
    ok, encoded = cv2.imencode(
        ".jpg", image, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440]
    )
    assert ok
    blob = encoded.tobytes()
    _assert_jpeg_close(tools.read(io.BytesIO(blob)), jtools.read(io.BytesIO(blob)))


PROGRESSIVE_CASES = {
    "444_q95": ((37, 53), "RGB", dict(subsampling=0, quality=95)),
    "422_q90": ((37, 53), "RGB", dict(subsampling=1, quality=90)),
    "420_q50": ((37, 53), "RGB", dict(subsampling=2, quality=50)),
    "444_q50": ((37, 53), "RGB", dict(subsampling=0, quality=50)),
    "420_q95": ((64, 80), "RGB", dict(subsampling=2, quality=95)),
    "grey_q90": ((37, 53), "L", dict(quality=90)),
    "grey_1x1": ((1, 1), "L", {}),
    "420_1x1": ((1, 1), "RGB", dict(subsampling=2)),
    "422_17x200": ((17, 200), "RGB", dict(subsampling=1, quality=90)),
    "420_restart_blocks": ((48, 70), "RGB", dict(subsampling=2, restart_marker_blocks=3)),
    "444_restart_rows": ((33, 41), "RGB", dict(subsampling=0, restart_marker_rows=1)),
    "grey_restart_rows": ((33, 41), "L", dict(quality=95, restart_marker_rows=2)),
}


@pytest.mark.parametrize("case", list(PROGRESSIVE_CASES))
def test_read_progressive_jpeg_matches_jax(case):
    """Progressive JPEGs (libjpeg's scan script: DC first and refinement,
    spectral bands, successive approximation, EOB runs) bit for bit."""
    shape, mode, options = PROGRESSIVE_CASES[case]
    blob = _pil_jpeg(_scene_crop(*shape, mode), progressive=True, **options)
    assert blob[blob.index(b"\xff\xc2") : blob.index(b"\xff\xc2") + 2] == b"\xff\xc2"
    np.testing.assert_array_equal(tools.read(io.BytesIO(blob)), jtools.read(io.BytesIO(blob)))


# The committed fixtures of the data slice (scripts/make_data_fixtures.py)
# and the sha256 of PIL's RGB decode of each: chip_smoke.py holds the
# port's decode on the card's machine, which has no PIL, to the same values.
DATA_FIXTURES = {
    "progressive.jpg": ((240, 320, 3),
                        "c0adb0d001a6217014b32289dbbfc0b1e3e218bc49d92e2d1eab662f007c3e55"),
    "interlaced.png": ((42, 220, 3),
                       "0f3f1d71318e7985d8194f853fd77ac71aab2c8b1608d14fda74dfe7fdba36b9"),
}


@pytest.mark.parametrize("name", list(DATA_FIXTURES))
def test_read_data_fixtures_match_recorded_sha256(name):
    path = os.path.join(os.path.dirname(FIXTURE_JPEG), name)
    shape, digest = DATA_FIXTURES[name]
    ref = jtools.read(path)
    assert ref.shape == shape and hashlib.sha256(ref.tobytes()).hexdigest() == digest
    out = tools.read(path)
    assert hashlib.sha256(out.tobytes()).hexdigest() == digest


def _with_sof(blob, marker=None, precision=None):
    """A baseline JPEG with its SOF0 marker or sample precision replaced."""
    at = blob.index(b"\xff\xc0")
    data = bytearray(blob)
    if marker is not None:
        data[at + 1] = marker
    if precision is not None:
        data[at + 4] = precision
    return bytes(data)


def test_read_jpeg_refuses_what_it_cannot_decode():
    baseline = _pil_jpeg(_scene_crop(16, 24))
    # Lossless (SOF3) and arithmetic-coded (SOF9, SOF10) files decode as
    # PIL decodes them (tests/test_torch_jpeg_modes.py); these kinds PIL's
    # libjpeg-turbo refuses too.
    kinds = {
        "arithmetic-coded lossless": _with_sof(baseline, marker=0xCB),
        "hierarchical": _with_sof(baseline, marker=0xC5),
        "12-bit": _with_sof(baseline, precision=12),
    }
    for kind, blob in kinds.items():
        with pytest.raises(NotImplementedError, match=kind):
            tools.read(io.BytesIO(blob))
    # A 4-component (CMYK) JPEG is not refused: it decodes as PIL decodes
    # it (tests/test_torch_image_formats.py holds CMYK and YCCK files of
    # every sampling).
    cmyk = _pil_jpeg(_scene_crop(16, 24, "CMYK"))
    np.testing.assert_array_equal(tools.read(io.BytesIO(cmyk)), jtools.read(io.BytesIO(cmyk)))
    with open(FIXTURE_JPEG, "rb") as f:
        fixture = f.read()
    for cut in (200, len(fixture) // 2, len(fixture) - 2):
        with pytest.raises(ValueError, match="truncated"):
            tools.read(io.BytesIO(fixture[:cut]))
    scan = baseline.index(b"\xff\xda")
    corrupt = baseline[: scan + 20] + b"\xff" * 40 + baseline[scan + 60 :]
    with pytest.raises(ValueError):
        tools.read(io.BytesIO(corrupt))


def test_read_fetches_urls(monkeypatch):
    """``http(s)://`` paths are fetched with ``urllib.request.urlopen`` (here
    patched to serve a PNG and a JPEG: no network)."""
    png = _png(np.arange(15, dtype=np.uint8).reshape(3, 5), 0, 8)
    jpeg = _pil_jpeg(_scene_crop(9, 11))
    served = {"http://example.test/a.png": png, "HTTPS://example.test/b.jpg": jpeg}
    opened = []

    class Response(io.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.close()

    def urlopen(url):
        opened.append(url)
        return Response(served[url])

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    for url, blob in served.items():
        np.testing.assert_array_equal(tools.read(url), jtools.read(io.BytesIO(blob)))
    assert opened == list(served)
