"""Write the WebP fixtures that ``tests/test_torch_webp.py`` and
``chip_smoke.py`` read, with the sha256 of PIL's decodes as their hashes.

    python scripts/make_webp_fixtures.py [--out tests/fixtures/webp]

Three kinds of file:

* layouts PIL's writer cannot ask for, encoded by the libwebp that Pillow
  bundles (``pillow.libs/libwebp-*.so``, loaded with ``ctypes`` after its
  ``libsharpyuv``; ``WebPConfig`` as ``webp/encode.h`` of ABI 0x020f lays
  it out, each config checked by ``WebPValidateConfig``): the simple loop
  filter, 8 token partitions (libwebp 1.6 writes them only with
  ``low_memory``, which also turns the skip flag on), 1 and 4 segments,
  sharpness 0 and 7, filter strength 0 and 100. Each file's frame header
  is read back to check that it carries the field that was set;
* files assembled here from PIL-made bitstreams: ``ALPH`` chunks of each
  compression (raw, VP8L) and each filter (none, horizontal, vertical,
  gradient; one with the pre-processing bit), which libwebp's encoder does
  not choose on request, before a lossy frame; and an animation whose
  first frame sits at an offset on a larger canvas;
* the 12 golden scenes of ``tests/fixtures/golden_offline`` as lossy
  WebP at quality 80, and scene 3 lossless.

``hashes.json`` beside them holds, for each, the shape and the sha256 of
``np.array(PIL.Image.open(f).convert("RGB"))`` and of its ``"RGBA"``
conversion. The script needs PIL; the files it writes do not.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "..", "tests", "fixtures", "golden_offline")
ABI = 0x020F
CONFIG_FIELDS = (
    "lossless", "quality", "method", "image_hint", "target_size", "target_PSNR", "segments",
    "sns_strength", "filter_strength", "filter_sharpness", "filter_type", "autofilter",
    "alpha_compression", "alpha_filtering", "alpha_quality", "pass", "show_compressed",
    "preprocessing", "partitions", "partition_limit", "emulate_jpeg_size", "thread_level",
    "low_memory", "near_lossless", "exact", "use_delta_palette", "use_sharp_yuv", "qmin", "qmax")


class Config(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float if name in ("quality", "target_PSNR") else ctypes.c_int)
                for name in CONFIG_FIELDS]


class Picture(ctypes.Structure):
    _fields_ = [
        ("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int), ("width", ctypes.c_int),
        ("height", ctypes.c_int), ("y", ctypes.c_void_p), ("u", ctypes.c_void_p),
        ("v", ctypes.c_void_p), ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int),
        ("a", ctypes.c_void_p), ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2),
        ("argb", ctypes.c_void_p), ("argb_stride", ctypes.c_int), ("pad2", ctypes.c_uint32 * 3),
        ("writer", ctypes.c_void_p), ("custom_ptr", ctypes.c_void_p),
        ("extra_info_type", ctypes.c_int), ("extra_info", ctypes.c_void_p),
        ("stats", ctypes.c_void_p), ("error_code", ctypes.c_int),
        ("progress_hook", ctypes.c_void_p), ("user_data", ctypes.c_void_p),
        ("pad3", ctypes.c_uint32 * 3), ("pad4", ctypes.c_void_p), ("pad5", ctypes.c_void_p),
        ("pad6", ctypes.c_uint32 * 8), ("memory_", ctypes.c_void_p),
        ("memory_argb_", ctypes.c_void_p), ("pad7", ctypes.c_void_p * 2)]


class MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32)]


def libwebp():
    """Pillow's bundled libwebp, its encoder entry points typed."""
    import PIL

    libs = os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs")
    ctypes.CDLL(glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))[0], mode=ctypes.RTLD_GLOBAL)
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libwebp-*.so*"))[0])
    config_p, picture_p = ctypes.POINTER(Config), ctypes.POINTER(Picture)
    lib.WebPConfigInitInternal.argtypes = [config_p, ctypes.c_int, ctypes.c_float, ctypes.c_int]
    lib.WebPValidateConfig.argtypes = [config_p]
    lib.WebPPictureInitInternal.argtypes = [picture_p, ctypes.c_int]
    lib.WebPPictureImportRGB.argtypes = [picture_p, ctypes.c_void_p, ctypes.c_int]
    lib.WebPEncode.argtypes = [config_p, picture_p]
    lib.WebPPictureFree.argtypes = [picture_p]
    lib.WebPMemoryWriterInit.argtypes = [ctypes.POINTER(MemoryWriter)]
    lib.WebPMemoryWriterClear.argtypes = [ctypes.POINTER(MemoryWriter)]
    return lib


def encode_lossy(lib, rgb: np.ndarray, quality: float = 75.0, **fields) -> bytes:
    """A lossy WebP file of ``rgb`` by ``WebPEncode``, ``fields`` set on
    the default config."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    config = Config()
    if not lib.WebPConfigInitInternal(ctypes.byref(config), 0, quality, ABI):
        raise RuntimeError("WebPConfigInit failed: another ABI")
    for key, value in fields.items():
        setattr(config, key, value)
    if not lib.WebPValidateConfig(ctypes.byref(config)):
        raise ValueError(f"libwebp refuses the config {fields}")
    picture = Picture()
    if not lib.WebPPictureInitInternal(ctypes.byref(picture), ABI):
        raise RuntimeError("WebPPictureInit failed: another ABI")
    picture.width, picture.height = rgb.shape[1], rgb.shape[0]
    writer = MemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    try:
        if not lib.WebPPictureImportRGB(ctypes.byref(picture), rgb.ctypes.data, 3 * rgb.shape[1]):
            raise RuntimeError("WebPPictureImportRGB failed")
        picture.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
        picture.custom_ptr = ctypes.addressof(writer)
        if not lib.WebPEncode(ctypes.byref(config), ctypes.byref(picture)):
            raise RuntimeError(f"WebPEncode failed: error {picture.error_code}")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPMemoryWriterClear(ctypes.byref(writer))
        lib.WebPPictureFree(ctypes.byref(picture))


def pil_webp(pixels: np.ndarray, **kwargs) -> bytes:
    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(pixels).save(out, format="WEBP", **kwargs)
    return out.getvalue()


def chunk(fourcc: bytes, payload: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)


def riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def le24(value: int) -> bytes:
    return struct.pack("<I", value)[:3]


def vp8x(flags: int, width: int, height: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + le24(width - 1) + le24(height - 1))


def bitstream(blob: bytes) -> tuple:
    """(fourcc, payload) of a simple WebP file's one bitstream chunk."""
    size = struct.unpack_from("<I", blob, 16)[0]
    return blob[12:16], blob[20:20 + size]


def filter_alpha(alpha: np.ndarray, method: int) -> np.ndarray:
    """libwebp's alpha filters (the inverse of the decoder's unfilters):
    1 horizontal, 2 vertical, 3 gradient; the first row horizontal from
    0, a row's first pixel from the pixel above."""
    a = alpha.astype(np.int64)
    pred = np.zeros_like(a)
    if method:
        pred[0, 1:] = a[0, :-1]
        pred[1:, 0] = a[:-1, 0]
        if method == 1:
            pred[1:, 1:] = a[1:, :-1]
        elif method == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 0xFF).astype(np.uint8)


def alpha_file(rgb: np.ndarray, alpha: np.ndarray, compression: int, method: int,
               preprocessing: int = 0) -> bytes:
    """VP8X + ALPH + VP8: PIL's lossy frame of ``rgb`` after an ALPH chunk
    written here: the filtered plane raw, or as a VP8L image stream
    without its header (PIL's lossless encode of the plane in green)."""
    deltas = filter_alpha(alpha, method)
    if compression == 0:
        data = deltas.tobytes()
    else:
        zeros = np.zeros_like(deltas)
        fourcc, payload = bitstream(pil_webp(np.dstack([zeros, deltas, zeros]), lossless=True))
        assert fourcc == b"VP8L"
        data = payload[5:]  # the 0x2f signature and the 32 bits of size, alpha, version
    header = compression | method << 2 | preprocessing << 4
    fourcc, frame = bitstream(pil_webp(rgb, quality=75))
    assert fourcc == b"VP8 "
    return riff(vp8x(0x10, rgb.shape[1], rgb.shape[0]), chunk(b"ALPH", bytes([header]) + data),
                chunk(b"VP8 ", frame))


def animation(frames: list, offsets: list, canvas: tuple) -> bytes:
    """VP8X + ANIM + ANMF: PIL's VP8L streams of ``frames`` at ``offsets``
    (even) on a ``canvas`` (width, height), 100 ms each, no blending."""
    chunks = [vp8x(0x12, *canvas), chunk(b"ANIM", struct.pack("<IH", 0xFF204080, 0))]
    for pixels, (x, y) in zip(frames, offsets):
        fourcc, payload = bitstream(pil_webp(pixels, lossless=True))
        header = (le24(x // 2) + le24(y // 2) + le24(pixels.shape[1] - 1)
                  + le24(pixels.shape[0] - 1) + le24(100) + bytes([0x02]))
        chunks.append(chunk(b"ANMF", header + chunk(fourcc, payload)))
    return riff(*chunks)


def predictor_zoo(seed: int = 0, size: int = 64, tile: int = 16) -> np.ndarray:
    """An RGB image built as the VP8L predictor transform undoes one: a
    residual of 0 or 1 per channel added to the prediction of tile
    ``i``'s mode ``i % 14`` (the lossless specification's predictors,
    channel by channel), so that libwebp's encoder finds each mode."""
    rng = np.random.RandomState(seed)
    residual = rng.randint(0, 2, (size, size, 3))
    px = np.zeros((size, size, 4), np.int64)  # A, R, G, B
    tiles = size // tile

    def average(a, b):
        return (a + b) // 2

    def clip(v):
        return np.clip(v, 0, 255)

    for y in range(size):
        for x in range(size):
            if y == 0:
                pred = px[0, x - 1] if x else np.array([255, 0, 0, 0])
            elif x == 0:
                pred = px[y - 1, 0]
            else:
                left, top, top_left = px[y, x - 1], px[y - 1, x], px[y - 1, x - 1]
                top_right = px[y - 1, x + 1] if x + 1 < size else px[y, 0]
                mode = ((y // tile) * tiles + x // tile) % 14
                pred = [
                    np.array([255, 0, 0, 0]), left, top, top_right, top_left,
                    average(average(left, top_right), top), average(left, top_left),
                    average(left, top), average(top_left, top), average(top, top_right),
                    average(average(left, top_left), average(top, top_right)),
                    top if (np.abs(left - top_left).sum() <= np.abs(top - top_left).sum())
                    else left,
                    clip(left + top - top_left),
                    clip(average(left, top) + np.trunc(
                        (average(left, top) - top_left) / 2).astype(np.int64)),
                ][mode]
            px[y, x] = (pred + np.concatenate([[0], residual[y, x]])) & 0xFF
    return px[..., 1:].astype(np.uint8)


def frame_fields(blob: bytes) -> dict:
    """The frame header fields of a simple lossy file, read by the port's
    own parser (whose decodes the tests hold to PIL's)."""
    sys.path.insert(0, os.path.join(HERE, ".."))
    from keras_ocr_tpu_torch import webp

    fourcc, payload = bitstream(blob)
    size = struct.unpack_from("<I", blob, 16)[0]
    first, _, _ = webp._frame_header(payload + b"\x00" * (size & 1), size, "fixture")
    return webp._frame_parameters(webp._BoolDecoder(payload, 10, first), "fixture")


def golden_scene(index: int) -> np.ndarray:
    from PIL import Image

    return np.array(Image.open(os.path.join(GOLDEN, f"scene_{index:02d}.png")).convert("RGB"))


def fixture_files() -> dict:
    lib = libwebp()
    scene = golden_scene(3)
    crop = golden_scene(0)[:64, 32:96].copy()  # a textured 64x64: four by four macroblocks
    yy, xx = np.mgrid[:crop.shape[0], :crop.shape[1]]
    files = {}
    layouts = {
        # name: (config fields, {frame header field: the value it must carry})
        "simple_filter.webp": (dict(filter_type=0, filter_strength=60), {"filter_type": 1}),
        "partitions_8.webp": (dict(partitions=3, low_memory=1), {"partitions": 8,
                                                                  "skip_prob": 239}),
        "segments_1.webp": (dict(segments=1), {"use_segment": 0}),
        "segments_4.webp": (dict(segments=4, sns_strength=100), {"use_segment": 1,
                                                                  "update_map": 1}),
        "sharpness_0.webp": (dict(filter_strength=60, filter_sharpness=0), {"sharpness": 0}),
        "sharpness_7.webp": (dict(filter_strength=60, filter_sharpness=7), {"sharpness": 7}),
        "filter_0.webp": (dict(filter_strength=0), {"filter_type": 0}),
        # Strength 100 is the encoder's strongest level for the quantiser,
        # above the level strength 60 gives (checked below).
        "filter_100.webp": (dict(filter_strength=100), {"filter_type": 2}),
    }
    for name, (fields, expected) in layouts.items():
        # Scene 3 whole for the partitions: 16 macroblock rows reach all 8,
        # and its flat background gives macroblocks without coefficients.
        image = scene if name == "partitions_8.webp" else crop
        blob = encode_lossy(lib, image, 75.0, autofilter=0, **fields)
        got = {key: frame_fields(blob)[key] for key in expected}
        if got != expected:
            raise AssertionError(f"{name}: the header carries {got}, not {expected}")
        files[name] = blob
    default_level = frame_fields(encode_lossy(lib, crop, 75.0, autofilter=0))["level"]
    if frame_fields(files["filter_100.webp"])["level"] <= default_level:
        raise AssertionError("filter strength 100 did not raise the filter level")
    alpha = np.clip(3 * xx + 2 * yy + 40 * ((xx // 16 + yy // 12) % 2), 0, 255).astype(np.uint8)
    for compression, kind in ((0, "raw"), (1, "lossless")):
        for method, filter_name in enumerate(("none", "horizontal", "vertical", "gradient")):
            name = f"alpha_{kind}_{filter_name}.webp"
            files[name] = alpha_file(crop, alpha, compression, method)
    files["alpha_raw_gradient_preprocessed.webp"] = alpha_file(crop, alpha, 0, 3, 1)
    small = scene[100:130, 20:60].copy()  # 40x30
    files["animation_offset.webp"] = animation(
        [np.dstack([small, np.full(small.shape[:2], 255, np.uint8)]),
         np.dstack([small[::-1], np.full(small.shape[:2], 128, np.uint8)])],
        [(10, 6), (0, 0)], (80, 60))
    files["lossless_predictors.webp"] = pil_webp(predictor_zoo(), lossless=True, method=6,
                                                 quality=100)
    for index in range(12):
        files[f"scene_{index:02d}.webp"] = pil_webp(golden_scene(index), quality=80)
    files["scene_03_lossless.webp"] = pil_webp(scene, lossless=True)
    return files


def pil_hashes(blob: bytes) -> dict:
    from PIL import Image

    image = Image.open(io.BytesIO(blob))
    rgb = np.array(image.convert("RGB"))
    rgba = np.array(image.convert("RGBA"))
    return {"shape": list(rgb.shape), "mode": image.mode,
            "decoded_sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
            "rgba_sha256": hashlib.sha256(rgba.tobytes()).hexdigest()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(HERE, "..", "tests", "fixtures", "webp"))
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    hashes = {}
    for name, blob in fixture_files().items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(blob)
        hashes[name] = pil_hashes(blob)
        print(name, len(blob), "bytes", hashes[name]["mode"], hashes[name]["decoded_sha256"])
    with open(os.path.join(args.out, "hashes.json"), "w") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
