"""Port parity: ``tools.read`` of WebP files.

JAX's ``tools.read`` is PIL's ``Image.open(f).convert("RGB")``, which
opens WebP through libwebp's animation decoder; the port's
``keras_ocr_tpu_torch/webp.py`` must equal it bit for bit, with no
tolerance:

* every committed fixture of ``tests/fixtures/webp`` (written by
  ``scripts/make_webp_fixtures.py``: the simple filter, 8 partitions with
  skipped macroblocks, 1 and 4 segments, sharpness 0 and 7, filter
  strength 0 and 100, ``ALPH`` of both compressions and every filter, an
  animation's first frame at an offset, a lossless image built for every
  predictor mode, the 12 golden scenes at quality 80 and scene 3
  lossless) by path, by buffer and through ``read_and_fit``, at the
  sha256 of PIL's decode in ``hashes.json`` and equal to JAX's
  ``tools.read``; where PIL opens the file as RGBA, the decoded alpha too;
* files written here by PIL's writer, none larger than 64x64: lossless
  from RGB, RGBA (with and without ``exact``), grey and palettes of 2-256
  colours, gradients and noise at every method and three qualities; lossy
  at five qualities and three methods, with alpha at three alpha
  qualities, with ICC, EXIF and XMP chunks; 3-frame animations; sizes
  down to 1x1.

The decoders record the features they reach (``webp._SEEN``); one test
holds that the fixtures and the cases together reach every transform,
predictor mode, palette packing and code kind of VP8L, every intra mode,
both loop filters, segments, skipped macroblocks, several partitions and
the large DCT categories of VP8, and each ``ALPH`` compression with each
filter. Truncated and corrupt files raise ``ValueError`` where PIL
raises.
"""

import functools
import hashlib
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from keras_ocr_tpu import tools as jtools
from keras_ocr_tpu_torch import tools, webp

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
WEBP_DIR = os.path.join(HERE, "fixtures", "webp")
with open(os.path.join(WEBP_DIR, "hashes.json"), encoding="utf8") as _f:
    HASHES = json.load(_f)
SCENES = sorted(name for name in HASHES if name.startswith("scene_"))
# read_and_fit's (width, height): a small fixture letterboxed, a scene at
# its own size, where the fit leaves its pixels as they are.
FIT = (80, 64)
SCENE_FIT = (320, 256)

RNG = np.random.RandomState(22)
_YY, _XX = np.mgrid[:64, :64]
GRADIENT = np.stack([(_XX + _YY) * 2, (_XX - _YY) % 256, (3 * _XX + _YY) % 256],
                    axis=-1).astype(np.uint8)
NOISE = RNG.randint(0, 256, (48, 40, 3)).astype(np.uint8)
PHOTO = np.array(Image.open(os.path.join(HERE, "fixtures", "golden_offline", "scene_00.png"))
                 .convert("RGB"))[:64, 32:96].copy()
ALPHA = ((_XX * 5 + _YY * 3) % 256).astype(np.uint8)


def _written(pixels, **kwargs) -> bytes:
    out = io.BytesIO()
    Image.fromarray(pixels).save(out, format="WEBP", **kwargs)
    return out.getvalue()


def _palette(colours: int) -> np.ndarray:
    rng = np.random.RandomState(colours)
    palette = rng.randint(0, 256, (colours, 3)).astype(np.uint8)
    return palette[np.arange(33 * 29).reshape(33, 29) % colours]


def _animation(**kwargs) -> bytes:
    frames = [Image.fromarray(np.roll(PHOTO[:40, :48], 7 * k, axis=1)) for k in range(3)]
    out = io.BytesIO()
    frames[0].save(out, format="WEBP", save_all=True, append_images=frames[1:], duration=80,
                   **kwargs)
    return out.getvalue()


CASES = {
    "lossless_rgb": lambda: _written(PHOTO, lossless=True),
    "lossless_rgba": lambda: _written(np.dstack([PHOTO, ALPHA]), lossless=True),
    "lossless_rgba_exact": lambda: _written(np.dstack([PHOTO, np.where(ALPHA < 90, 0, ALPHA)]),
                                            lossless=True, exact=True),
    "lossless_grey": lambda: _written(PHOTO.mean(axis=2).astype(np.uint8), lossless=True),
    **{f"lossless_palette_{n}": functools.partial(lambda n: _written(_palette(n), lossless=True),
                                                  n)
       for n in (2, 3, 4, 5, 16, 17, 256)},
    **{f"lossless_{kind}_method{m}_quality{q}": functools.partial(
        lambda pixels, m, q: _written(pixels, lossless=True, method=m, quality=q), pixels, m, q)
       for kind, pixels in (("gradient", GRADIENT), ("noise", NOISE))
       for m in range(7) for q in (0, 50, 100)},
    **{f"lossy_quality{q}_method{m}": functools.partial(
        lambda q, m: _written(PHOTO, quality=q, method=m), q, m)
       for q in (0, 10, 50, 80, 100) for m in (0, 4, 6)},
    **{f"lossy_rgba_alpha_quality{q}": functools.partial(
        lambda q: _written(np.dstack([PHOTO, ALPHA]), quality=75, alpha_quality=q), q)
       for q in (0, 50, 100)},
    "lossy_noise": lambda: _written(NOISE, quality=90),
    "lossy_gradient": lambda: _written(GRADIENT, quality=60),
    "lossy_metadata": lambda: _written(PHOTO, quality=80, icc_profile=b"\x00" * 132,
                                       exif=b"Exif\x00\x00" + bytes(range(40)),
                                       xmp=b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>"),
    "lossless_metadata": lambda: _written(PHOTO[:17, :33], lossless=True, exif=b"Exif\x00\x00"),
    "animation_lossy": lambda: _animation(quality=70),
    "animation_lossless": lambda: _animation(lossless=True),
    **{f"{kind}_{h}x{w}": functools.partial(
        lambda h, w, kw: _written(PHOTO[:h, :w].copy(), **kw), h, w, kw)
       for h, w in ((1, 1), (1, 33), (33, 1), (17, 33), (48, 64))
       for kind, kw in (("lossy", {"quality": 75}), ("lossless", {"lossless": True}))},
}


def _features(decode):
    webp._SEEN.clear()
    out = decode()
    return out, frozenset(webp._SEEN)


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """A case's bytes, the port's decode of them by buffer and the
    features that decode reached."""
    blob = CASES[name]()
    rgb, seen = _features(lambda: tools.read(io.BytesIO(blob)))
    return blob, rgb, seen


def _ways(name: str) -> tuple:
    # A golden scene is decoded once, by one of the three ways in turn.
    if name in SCENES:
        return (("path", "buffer", "fit")[SCENES.index(name) % 3],)
    return ("path", "buffer", "fit")


@functools.lru_cache(maxsize=None)
def _fixture(name: str):
    """The port's reads of a fixture (by path, buffer and read_and_fit)
    and the features they reached."""
    path = os.path.join(WEBP_DIR, name)
    reads = {}
    seen = frozenset()
    for way in _ways(name):
        if way == "path":
            reads[way], found = _features(lambda: tools.read(path))
        elif way == "buffer":
            with open(path, "rb") as f:
                reads[way], found = _features(lambda: tools.read(f))
        else:
            size = SCENE_FIT if name in SCENES else FIT
            reads[way], found = _features(lambda: tools.read_and_fit(path, *size))
        seen |= found
    return reads, seen


def _pil_rgba(blob: bytes):
    image = Image.open(io.BytesIO(blob))
    return image.mode, np.array(image.convert("RGBA"))


@pytest.mark.parametrize("name", sorted(HASHES))
def test_fixture_reads_as_pil_and_jax(name):
    path = os.path.join(WEBP_DIR, name)
    expected = HASHES[name]
    reads, _ = _fixture(name)
    for way, image in reads.items():
        if way == "fit":
            size = SCENE_FIT if name in SCENES else FIT
            assert np.array_equal(image, jtools.read_and_fit(path, *size)), name
            if name not in SCENES:
                continue
        assert image.dtype == np.uint8 and list(image.shape) == expected["shape"], (way, name)
        assert hashlib.sha256(image.tobytes()).hexdigest() == expected["decoded_sha256"], way
        assert np.array_equal(image, jtools.read(path)), (way, name)
    if expected["mode"] == "RGBA" and name not in SCENES:
        with open(path, "rb") as f:
            rgba = webp._decode_rgba(f.read(), name)
        assert hashlib.sha256(rgba.tobytes()).hexdigest() == expected["rgba_sha256"], name


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_reads_as_pil_and_jax(name):
    blob, rgb, _ = _case(name)
    reference = np.array(Image.open(io.BytesIO(blob)).convert("RGB"))
    assert rgb.dtype == np.uint8 and rgb.shape == reference.shape, name
    assert np.array_equal(rgb, reference), name
    assert np.array_equal(rgb, jtools.read(io.BytesIO(blob))), name
    assert np.array_equal(webp.decode_webp(blob), rgb)
    mode, rgba = _pil_rgba(blob)
    if mode == "RGBA":
        assert np.array_equal(webp._decode_rgba(blob), rgba), name


REQUIRED = (
    [f"vp8l.transform.{t}" for t in ("predictor", "color", "subtract_green", "color_indexing")]
    + [f"vp8l.predictor.{m}" for m in range(14)]
    + [f"vp8l.index_bits.{b}" for b in (1, 2, 4, 8)]
    + ["vp8l.color_cache", "vp8l.meta_codes", "vp8l.simple_code.1", "vp8l.simple_code.2"]
    + [f"vp8l.code_length_code.{c}" for c in (16, 17, 18)]
    + [f"vp8.i16.{m}" for m in ("DC", "TM", "VE", "HE")]
    + [f"vp8.i4.{m}" for m in webp._B_MODES]
    + [f"vp8.uv.{m}" for m in ("DC", "TM", "VE", "HE")]
    + ["vp8.filter.simple", "vp8.filter.normal", "vp8.segments", "vp8.skip", "vp8.partitions"]
    + [f"vp8.dct_category.{c}" for c in (3, 4, 5, 6)]
    + [f"alph.compression.{c}.filter.{f}" for c in (0, 1) for f in range(4)]
    + ["container.simple", "container.vp8x", "container.animation", "container.iccp",
       "container.exif", "container.xmp"]
)


def test_fixtures_and_cases_reach_every_feature():
    seen = set()
    for name in HASHES:
        seen |= _fixture(name)[1]
    for name in CASES:
        seen |= _case(name)[2]
    missing = [feature for feature in REQUIRED if feature not in seen]
    assert not missing, missing


def _chunk_offset(blob: bytes, fourcc: bytes) -> int:
    offset = blob.find(fourcc, 12)
    assert offset > 0, fourcc
    return offset


def _mutations():
    def fixture(name):
        with open(os.path.join(WEBP_DIR, name), "rb") as f:
            return f.read()

    lossy, lossless = fixture("scene_03.webp"), fixture("scene_03_lossless.webp")
    alpha = fixture("alpha_lossless_gradient.webp")
    at = _chunk_offset(alpha, b"ALPH") + 8
    out = {}
    for name in ("scene_03.webp", "scene_03_lossless.webp", "alpha_raw_vertical.webp",
                 "animation_offset.webp", "partitions_8.webp"):
        blob = fixture(name)
        out[f"{name}_half"] = blob[:len(blob) // 2]
        out[f"{name}_tail_cut"] = blob[:-3]
    out.update({
        "alph_reserved_bits": alpha[:at] + bytes([alpha[at] | 0xC0]) + alpha[at + 1:],
        "alph_compression_2": alpha[:at] + bytes([(alpha[at] & 0xFC) | 2]) + alpha[at + 1:],
        "alph_stream_zeroed": alpha[:at + 1] + bytes(40) + alpha[at + 41:],
        "unknown_fourcc": lossy[:12] + b"VP8Y" + lossy[16:],
        "not_a_key_frame": lossy[:20] + bytes([lossy[20] | 1]) + lossy[21:],
        "vp8_start_code": lossy[:23] + b"\x00" + lossy[24:],
        "vp8l_signature": lossless[:20] + b"\x2e" + lossless[21:],
        "vp8l_version": lossless[:24] + bytes([lossless[24] | 0x20]) + lossless[25:],
    })
    return out


MUTATIONS = _mutations()


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_truncated_or_corrupt_file_raises_where_pil_raises(name):
    blob = MUTATIONS[name]
    with pytest.raises(Exception):
        Image.open(io.BytesIO(blob)).convert("RGB")
    with pytest.raises(ValueError):
        tools.read(io.BytesIO(blob))


def test_trailing_bytes_past_the_riff_are_ignored():
    with open(os.path.join(WEBP_DIR, "alpha_raw_none.webp"), "rb") as f:
        blob = f.read() + b"\x00junk!"
    assert np.array_equal(tools.read(io.BytesIO(blob)),
                          np.array(Image.open(io.BytesIO(blob)).convert("RGB")))


def test_fixture_folder_stays_small():
    total = sum(os.path.getsize(os.path.join(WEBP_DIR, name)) for name in os.listdir(WEBP_DIR))
    assert total <= 350_000, total
