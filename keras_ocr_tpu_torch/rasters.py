"""PSD, QOI, SGI, Sun raster, ICNS, IM, MSP, XBM and XPM decoding for
:func:`keras_ocr_tpu_torch.tools.read`.

JAX's ``tools.read`` is PIL's ``Image.open(f).convert("RGB")``
(``keras_ocr_tpu/tools.py``); these decoders give the same pixels, bit for
bit, with numpy and the standard library only. Each follows the PIL 12
plugin of its format (``PsdImagePlugin``, ``QoiImagePlugin``, ...) and the C
decoder that plugin names:

* :func:`decode_psd`: Photoshop's composite image (layers, image resources
  and the layer / mask section are skipped), raw or PackBits (each
  channel's stream from the offset its row byte counts give, runs cut at a
  row's end as ``PackDecode.c`` cuts them); bitmap, grey, indexed (the
  768-byte colour data as planar ``RGB;L``), RGB (with a fourth channel
  RGBA, more ignored), CMYK (stored inverted, ``CMYK;I``), multichannel and
  duotone as grey, and Lab, which PIL converts through LittleCMS
  (:func:`lab_to_rgb`).
* :func:`decode_qoi`: every op and the running index, RGB and RGBA, as
  PIL's Python decoder runs them (a run does not enter the index).
* :func:`decode_sgi`: verbatim and RLE, 8 and 16 bits a sample (16-bit
  samples keep their high byte), 1, 3 and 4 channels, rows bottom up;
  ``SgiRleDecode.c``'s row buffer and its stop without error.
* :func:`decode_sun`: depths 1, 4, 8, 24 and 32; file types 0, 1, 3, 4 and
  5 raw in 16-bit-aligned rows, type 2 run-length (``SunRleDecode.c``:
  unpadded rows, runs carried over rows); type 3 RGB order, the others BGR;
  a colour map of up to 1024 bytes (planar ``RGB;L``) makes grey a palette.
* :func:`decode_icns`: the largest icon PIL picks; ``is32`` / ``il32`` /
  ``ih32`` / ``it32`` run-length or raw entries (``it32`` after its four
  zero bytes), their masks read and dropped, PNG entries through
  :func:`.tools.decode_png` and JPEG 2000 entries through
  :func:`.jpeg2000.decode_jpeg2000`.
* :func:`decode_im`: IFUNC's text header (:func:`im_header` accepts what
  ``ImImagePlugin._open`` accepts: it has no magic bytes), every image
  type of PIL's table that PIL unpacks (bilevel, grey, 2- and 4-bit
  palette, planar and interleaved RGB, RGBA, RGBX, CMYK, YCbCr, LA, 16-
  and 32-bit integers, 8-32-bit and float samples, the bit decoder's
  2-31-bit samples), the ``Lut`` palette, rows bottom up.
* :func:`decode_msp`: Windows Paint version 1 (``DanM``, raw) and 2
  (``LinS``, run-length rows by the row map).
* :func:`decode_xbm` and :func:`decode_xpm`: X11 bitmaps (hex bytes,
  least significant bit first) and pixmaps (``c`` colour keys of
  ``#rrggbb``; ``None`` only where no pixel uses it), parsed as PIL does.

What PIL does not read raises ``NotImplementedError`` naming it (PSB,
16- and 32-bit PSD, ZIP-compressed PSD, an SGI layout outside PIL's
table, Sun depths and types outside PIL's, ICNS without a 32-bit icon,
IM image types PIL has no unpacker for, XPM colour names); a truncated or
corrupt file raises ``ValueError``.
"""

from __future__ import annotations

import functools
import math
import re
import struct
import typing

import numpy as np

from .codecs import _grey, _unpack_bits, cmyk_to_rgb

# PIL's decompression bomb limit: twice ``Image.MAX_IMAGE_PIXELS``.
_MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def _check_size(width, height, name: str):
    if width * height > _MAX_PIXELS:
        raise ValueError(f"{name}: {width} x {height} pixels is more than PIL opens (its "
                         f"decompression bomb check)")


def _u16(blob: bytes, at: int, order: str = ">") -> int:
    return struct.unpack_from(order + "H", blob, at)[0]


def _u32(blob: bytes, at: int, order: str = ">") -> int:
    return struct.unpack_from(order + "I", blob, at)[0]


def _palette_rgb_l(data: bytes) -> np.ndarray:
    """PIL's ``ImagePalette.raw("RGB;L", data)`` once put on an image: the
    reds, then the greens, then the blues, ``len(data) // 3`` entries of
    256 (black past them)."""
    count = min(len(data) // 3, 256)
    palette = np.zeros((256, 3), np.uint8)
    planes = np.frombuffer(data[: 3 * count], np.uint8).reshape(3, count)
    palette[:count] = planes.T
    return palette


def _raw_rows(blob: bytes, start: int, need: int, height: int, stride: int, kind: str,
              name: str) -> np.ndarray:
    """``RawDecode.c``'s rows: ``height`` rows of ``need`` bytes,
    ``stride`` bytes apart from ``start`` (the last row needs only its
    own bytes)."""
    if height == 0:
        return np.zeros((0, need), np.uint8)
    end = start + stride * (height - 1) + need
    if start < 0 or end > len(blob):
        raise ValueError(f"{name}: truncated {kind} in the image data")
    data = np.frombuffer(blob, np.uint8, count=end - start, offset=start)
    data = np.concatenate([data, np.zeros(stride - need, np.uint8)])
    return data.reshape(height, stride)[:, :need]


# ---------------------------------------------------------------------------
# PSD
# ---------------------------------------------------------------------------

PSD_SIGNATURE = b"8BPS"
# PIL's ``PsdImagePlugin.MODES``: (colour mode, bits) -> (mode, channels).
PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
             (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
             (9, 8): ("LAB", 3)}
_PSD_COLOUR_MODES = {0: "bitmap", 1: "grey", 2: "indexed", 3: "RGB", 4: "CMYK",
                     7: "multichannel", 8: "duotone", 9: "Lab"}


def is_psd(blob: bytes) -> bool:
    """PIL's ``PsdImagePlugin._accept``."""
    return blob[:4] == PSD_SIGNATURE


def _need(blob: bytes, end: int, kind: str, name: str):
    if end > len(blob):
        raise ValueError(f"{name}: truncated {kind} header")


def decode_psd(blob: bytes, name: str = "image") -> np.ndarray:
    """A Photoshop file's composite image as (H, W, 3) uint8, as PIL's
    ``PsdImagePlugin`` and ``convert("RGB")`` give it (see the module's
    docstring). Raises NotImplementedError naming what PIL does not read
    (PSB, depths other than 8 bits, or 1 bit for bitmaps, fewer channels
    than the mode needs, ZIP compression), ValueError on a truncated or
    corrupt file."""
    blob = bytes(blob)
    if not is_psd(blob):
        raise ValueError(f"{name} is not a PSD file")
    _need(blob, 26, "PSD", name)
    version, channels = _u16(blob, 4), _u16(blob, 12)
    height, width = _u32(blob, 14), _u32(blob, 18)
    bits, colour = _u16(blob, 22), _u16(blob, 24)
    if version == 2:
        raise NotImplementedError(f"{name}: PSB (Photoshop's large document format; PIL does "
                                  "not read it)")
    if version != 1:
        raise ValueError(f"{name}: PSD version {version}")
    if (colour, bits) not in PSD_MODES:
        what = _PSD_COLOUR_MODES.get(colour, f"colour mode {colour}")
        raise NotImplementedError(f"{name}: {bits}-bit {what} PSD (PIL does not read it)")
    mode, need = PSD_MODES[colour, bits]
    if need > channels:
        raise NotImplementedError(f"{name}: {mode} PSD of {channels} channels, fewer than the "
                                  f"mode needs (PIL does not read it)")
    if mode == "RGB" and channels == 4:
        mode, need = "RGBA", 4
    _check_size(width, height, name)
    pos = 26
    _need(blob, pos + 4, "PSD colour mode data", name)
    size = _u32(blob, pos)
    pos += 4
    # Without a 768-byte palette PIL's palette image is black.
    palette = np.zeros((256, 3), np.uint8)
    if size:
        data = blob[pos : pos + size]
        pos += size
        if mode == "P" and size == 768:
            _need(blob, pos, "PSD colour mode data", name)
            palette = _palette_rgb_l(data)
    # Image resources, walked as PIL walks them (it reads each one's
    # header and data, not the section's length).
    _need(blob, pos + 4, "PSD image resources", name)
    size = _u32(blob, pos)
    pos += 4
    end = pos + size
    while pos < end:
        _need(blob, pos + 7, "PSD image resource", name)
        count = blob[pos + 6]
        pos += 7 + count + (0 if count & 1 else 1)
        _need(blob, pos + 4, "PSD image resource", name)
        size = _u32(blob, pos)
        pos += 4 + size + (size & 1)
    _need(blob, pos + 4, "PSD layer and mask section", name)
    size = _u32(blob, pos)
    pos += 4
    if size:
        _need(blob, pos + 4, "PSD layer and mask section", name)
        pos += size
    _need(blob, pos + 2, "PSD image data", name)
    compression = _u16(blob, pos)
    pos += 2
    row = (width * bits + 7) // 8
    if compression == 0:
        planes = [_raw_rows(blob, pos + k * width * height, row, height, row, "PSD", name)
                  for k in range(need)]
    elif compression == 1:
        # PIL reads the row byte counts of the channels it uses only, and
        # takes the data to start after them.
        _need(blob, pos + 2 * need * height, "PSD row byte counts", name)
        counts = np.frombuffer(blob, ">u2", count=need * height, offset=pos).astype(np.int64)
        start = pos + 2 * need * height
        planes = [_packbits_rows(blob, start + int(counts[: k * height].sum()), row, height,
                                 name) for k in range(need)]
    elif compression in (2, 3):
        raise NotImplementedError(f"{name}: ZIP-compressed PSD (PIL does not read it)")
    else:
        raise ValueError(f"{name}: PSD compression {compression}")
    if mode == "1":
        return _grey(_unpack_bits(planes[0], 1, width) * 255)
    if mode == "L":
        return _grey(planes[0])
    if mode == "P":
        return palette[planes[0]]
    if mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(np.stack(planes[:3], -1))
    if mode == "CMYK":
        return cmyk_to_rgb(255 - np.stack(planes, -1))
    # PIL's ``A`` and ``B`` band unpackers turn the stored a and b (128 for
    # 0) into its LAB image's signed bytes.
    return lab_to_rgb(np.stack(planes, -1) ^ np.array([0, 0x80, 0x80], np.uint8))


def _packbits_rows(blob: bytes, pos: int, row: int, height: int, name: str) -> np.ndarray:
    """``PackDecode.c`` from ``pos`` until ``height`` rows of ``row``
    bytes are full: a packet that runs past a row's end is cut there, and
    the no-op 128 does not end a row."""
    out = bytearray(row * height)
    length = len(blob)
    at = x = y = 0
    if row == 0 or height == 0:
        return np.zeros((height, row), np.uint8)
    while True:
        if pos >= length:
            raise ValueError(f"{name}: truncated PSD: PackBits data for {y} of {height} rows")
        n = blob[pos]
        if n == 128:
            pos += 1
            continue
        if n > 128:
            if pos + 2 > length:
                raise ValueError(f"{name}: truncated PSD in a PackBits run")
            take = min(257 - n, row - x)
            out[at + x : at + x + take] = blob[pos + 1 : pos + 2] * take
            pos += 2
        else:
            if pos + n + 2 > length:
                raise ValueError(f"{name}: truncated PSD in a PackBits literal")
            take = min(n + 1, row - x)
            out[at + x : at + x + take] = blob[pos + 1 : pos + 1 + take]
            pos += n + 2
        x += take
        if x >= row:
            x = 0
            at += row
            y += 1
            if y >= height:
                return np.frombuffer(bytes(out), np.uint8).reshape(height, row)


# ---------------------------------------------------------------------------
# Lab -> sRGB as PIL converts it (LittleCMS 2)
# ---------------------------------------------------------------------------

_D50 = (0.9642, 1.0, 0.8249)
_BRADFORD = ((0.8951, 0.2664, -0.1614), (-0.7502, 1.7135, 0.0367), (0.0389, -0.0685, 1.0296))
_MAX_ENCODEABLE_XYZ = 1.0 + 32767.0 / 32768.0
_SRGB_PARAMETERS = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)
_GRID = 33


def _inverse3(a):
    """``_cmsMAT3inverse``, term for term."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return ((c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det),
            (c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det),
            (c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det))


def _product3(a, b):
    return tuple(tuple(a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
                       for j in range(3)) for i in range(3))


def _apply3(a, v):
    return tuple(a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3))


def _srgb_to_xyz_d50():
    """``cmsCreate_sRGBProfile``'s colorants: Rec. 709 primaries under
    (0.3127, 0.3290), adapted to D50 by Bradford
    (``_cmsBuildRGB2XYZtransferMatrix``, ``_cmsAdaptMatrixToD50``)."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    primaries = ((xr, xg, xb), (yr, yg, yb), (1 - xr - yr, 1 - xg - yg, 1 - xb - yb))
    coef = _apply3(_inverse3(primaries), (xn / yn, 1.0, (1.0 - xn - yn) / yn))
    matrix = ((coef[0] * xr, coef[1] * xg, coef[2] * xb),
              (coef[0] * yr, coef[1] * yg, coef[2] * yb),
              (coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)))
    source = _apply3(_BRADFORD, ((xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0))
    dest = _apply3(_BRADFORD, _D50)
    cone = ((dest[0] / source[0], 0.0, 0.0), (0.0, dest[1] / source[1], 0.0),
            (0.0, 0.0, dest[2] / source[2]))
    adapt = _product3(_inverse3(_BRADFORD), _product3(cone, _BRADFORD))
    return _product3(adapt, matrix)


def _saturate_word(d: np.ndarray) -> np.ndarray:
    """``_cmsQuickSaturateWord``: + 0.5, then lcms's fast floor (to 1/65536
    first), clipped to 0..65535."""
    d = d + 0.5
    floor = np.floor(np.rint((d - 32767.0) * 65536.0) / 65536.0) + 32767
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, floor)).astype(np.int64)


def _stage_matrix(x: np.ndarray, m) -> np.ndarray:
    """``EvaluateMatrix``: float32 in and out, double sums."""
    x = x.astype(np.float64)
    out = np.empty_like(x)
    for i in range(3):
        out[..., i] = x[..., 0] * m[i][0] + x[..., 1] * m[i][1] + x[..., 2] * m[i][2]
    return out.astype(np.float32)


@functools.lru_cache(maxsize=1)
def _lab_clut() -> np.ndarray:
    """The 33x33x33 16-bit table LittleCMS samples for PIL's Lab -> sRGB
    transform (perceptual, ``OptimizeByResampling``): each node's Lab (V4
    encoding) through Lab -> XYZ (D50), the sRGB profile's inverse matrix
    and its inverse parametric curves, in lcms's float32 stages."""
    nodes = np.floor(np.arange(_GRID) * 65535.0 / (_GRID - 1) + 0.5)
    grid = np.stack(np.meshgrid(nodes, nodes, nodes, indexing="ij"), -1)
    lab = (grid / 65535.0).astype(np.float32).astype(np.float64)
    y = (lab[..., 0] * 100.0 + 16.0) / 116.0
    x = y + 0.002 * (lab[..., 1] * 255.0 - 128.0)
    z = y - 0.005 * (lab[..., 2] * 255.0 - 128.0)

    def f_1(t):
        return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - (16.0 / 116.0)), t * t * t)

    xyz = np.stack([f_1(x) * _D50[0], f_1(y) * _D50[1], f_1(z) * _D50[2]], -1)
    xyz = (xyz / _MAX_ENCODEABLE_XYZ).astype(np.float32)
    inverse = _inverse3(_srgb_to_xyz_d50())
    rgb = _stage_matrix(xyz, [[v * _MAX_ENCODEABLE_XYZ for v in row] for row in inverse])
    g, a, b, c, d = _SRGB_PARAMETERS
    r = rgb.astype(np.float64)
    # lcms calls the C library's pow; numpy's own can differ in the last bit.
    disc = math.pow(a * d + b, g)
    high = np.array([(math.pow(v, 1.0 / g) - b) / a if v >= disc else 0.0
                     for v in r.ravel().tolist()]).reshape(r.shape)
    curve = np.where(r >= disc, high, r / c).astype(np.float32)
    return _saturate_word(curve.astype(np.float64) * 65535.0)


def _tetrahedral16(table: np.ndarray, inputs: np.ndarray) -> np.ndarray:
    """lcms's ``TetrahedralInterp16`` of (..., 3) 16-bit inputs in a
    (n, n, n, C) table: 16.16 fixed point, the rest rounded as lcms
    rounds it."""
    n = table.shape[0]
    flat = table.reshape(-1, table.shape[-1]).astype(np.int64)
    strides = np.array([n * n, n, 1], np.int64)
    v = inputs.astype(np.int64) * (n - 1)
    fixed = v + (v + 0x7FFF) // 0xFFFF
    base = fixed >> 16
    rest = fixed & 0xFFFF
    step = np.where(inputs == 0xFFFF, 0, strides)
    order = np.argsort(-rest, axis=-1, kind="stable")
    rests = np.take_along_axis(rest, order, -1)
    steps = np.take_along_axis(step, order, -1)
    at = (base * strides).sum(-1)
    previous = flat[at]
    total = np.full(previous.shape, 0x8001, np.int64)
    c0 = previous
    for k in range(3):
        at = at + steps[..., k]
        current = flat[at]
        total += (current - previous) * rests[..., k : k + 1]
        previous = current
    return c0 + ((total + (total >> 16)) >> 16)


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of a ``LAB`` image ((..., 3) uint8: L, then
    a and b as signed bytes): LittleCMS's 8-bit transform, the inputs
    widened to 16 bits, interpolated in :func:`_lab_clut` and narrowed by
    ``FROM_16_TO_8``."""
    lab = np.asarray(lab, np.uint8).astype(np.int64)
    lab[..., 1:] ^= 0x80
    out = _tetrahedral16(_lab_clut(), lab * 257)
    return ((out * 65281 + 8388608) >> 24).astype(np.uint8)


# ---------------------------------------------------------------------------
# QOI
# ---------------------------------------------------------------------------

QOI_SIGNATURE = b"qoif"


def is_qoi(blob: bytes) -> bool:
    """PIL's ``QoiImagePlugin._accept``."""
    return blob[:4] == QOI_SIGNATURE


def decode_qoi(blob: bytes, name: str = "image") -> np.ndarray:
    """A QOI file as (H, W, 3) uint8, as PIL's ``QoiDecoder`` runs it: the
    previous pixel starts as opaque black, an index miss reads (0, 0, 0,
    0), a run writes the previous pixel without entering it in the index.
    Raises ValueError on a truncated file."""
    blob = bytes(blob)
    if not is_qoi(blob) or len(blob) < 14:
        raise ValueError(f"{name} is not a QOI file")
    width, height = _u32(blob, 4), _u32(blob, 8)
    _check_size(width, height, name)
    total = width * height
    pixels = []  # 0xRRGGBB ints
    append, extend = pixels.append, pixels.extend
    index = [(0, 0, 0, 0)] * 64
    r, g, b, a = 0, 0, 0, 255
    pos, done = 14, 0
    try:
        while done < total:
            byte = blob[pos]
            pos += 1
            if byte < 0x40:
                r, g, b, a = index[byte]
            elif byte < 0x80:
                r = (r + ((byte >> 4) & 3) - 2) & 255
                g = (g + ((byte >> 2) & 3) - 2) & 255
                b = (b + (byte & 3) - 2) & 255
            elif byte < 0xC0:
                second = blob[pos]
                pos += 1
                green = (byte & 0x3F) - 32
                r = (r + green + (second >> 4) - 8) & 255
                g = (g + green) & 255
                b = (b + green + (second & 15) - 8) & 255
            elif byte == 0xFE:
                r, g, b = blob[pos], blob[pos + 1], blob[pos + 2]
                pos += 3
            elif byte == 0xFF:
                r, g, b, a = blob[pos], blob[pos + 1], blob[pos + 2], blob[pos + 3]
                pos += 4
            else:
                run = (byte & 0x3F) + 1
                extend([(r << 16) | (g << 8) | b] * run)
                done += run
                continue
            index[(r * 3 + g * 5 + b * 7 + a * 11) & 63] = (r, g, b, a)
            append((r << 16) | (g << 8) | b)
            done += 1
    except IndexError:
        raise ValueError(f"{name}: truncated QOI: {done} of {total} pixels") from None
    packed = np.array(pixels[:total], np.uint32)
    rgb = np.stack([packed >> 16, packed >> 8, packed], -1).astype(np.uint8)
    return rgb.reshape(height, width, 3)


# ---------------------------------------------------------------------------
# SGI
# ---------------------------------------------------------------------------

# PIL's ``SgiImagePlugin.MODES``: (bytes a sample, dimension, channels) -> raw mode.
SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B", (2, 2, 1): "L;16B",
             (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def is_sgi(blob: bytes) -> bool:
    """PIL's ``SgiImagePlugin._accept``: the magic number 474."""
    return len(blob) >= 2 and _u16(blob, 0) == 474


def decode_sgi(blob: bytes, name: str = "image") -> np.ndarray:
    """An SGI image as (H, W, 3) uint8, as PIL's ``SgiImagePlugin``, its
    ``SGI16`` and ``sgi_rle`` decoders and ``convert("RGB")`` give it.
    Raises NotImplementedError naming a layout or compression PIL does
    not read, ValueError on a truncated or corrupt file."""
    blob = bytes(blob)
    if not is_sgi(blob) or len(blob) < 12:
        raise ValueError(f"{name} is not an SGI file")
    compression, bpc = blob[2], blob[3]
    dimension, width, height, channels = struct.unpack_from(">HHHH", blob, 4)
    rawmode = SGI_MODES.get((bpc, dimension, channels))
    if rawmode is None:
        raise NotImplementedError(f"{name}: SGI image of {bpc} bytes a sample, dimension "
                                  f"{dimension} and {channels} channels (PIL does not read it)")
    if compression not in (0, 1):
        raise NotImplementedError(f"{name}: SGI compression {compression} (PIL does not read "
                                  "it)")
    _check_size(width, height, name)
    bands = len(rawmode.split(";")[0])
    if compression == 0:
        page = width * height * bpc
        planes = []
        for k in range(bands):
            rows = _raw_rows(blob, 512 + k * page, width * bpc, height, width * bpc, "SGI",
                             name)
            planes.append(rows[:, ::bpc] if bpc == 2 else rows)
        pixels = np.stack(planes, -1)[::-1]
    else:
        pixels = _sgi_rle(blob, width, height, bands, bpc, name)
    return _grey(pixels[..., 0]) if bands == 1 else np.ascontiguousarray(pixels[..., :3])


def _sgi_rle(blob, width, height, bands, bpc, name) -> np.ndarray:
    """``SgiRleDecode.c``: the offset and length tables, each row's
    channels expanded into one row buffer that keeps what a short row
    leaves (so a row inherits the previous row's tail), rows bottom up;
    a row whose last counted packet is not the end marker stops the
    decode there without error."""
    buffer = blob[512:]
    size = len(buffer)
    entries = bands * height
    if size < 8 * entries:
        raise ValueError(f"{name}: truncated SGI: no room for the RLE tables")
    starts = struct.unpack_from(f">{entries}I", buffer, 0)
    lengths = struct.unpack_from(f">{entries}I", buffer, 4 * entries)
    out = np.zeros((height, width, bands), np.uint8)
    row = np.zeros((width, bands), np.uint8)
    last = size - 1
    for r in range(height):
        for channel in range(bands):
            start, count = starts[r + channel * height], lengths[r + channel * height]
            if start < 512 or start - 512 + count > size:
                raise ValueError(f"{name}: SGI RLE row past the end of the file")
            status = _sgi_expand(buffer, start - 512, count, row, channel, width, bpc, last)
            if status < 0:
                raise ValueError(f"{name}: corrupt SGI RLE row")
            if status > 0:
                return out
        out[height - 1 - r] = row
    return out


def _sgi_expand(src, pos, n, row, channel, width, bpc, last) -> int:
    """``expandrow`` / ``expandrow2``: packets until the end marker, at
    most ``n`` of them; a sample is one byte, or two of which the first
    (high) is kept. Returns -1 on an overrun, 1 where the ``n``-th packet
    is not the end marker, else 0."""
    x = 0
    while n > 0:
        if bpc == 1:
            if pos > last:
                return -1
            pixel = src[pos]
            pos += 1
        else:
            if pos + 1 > last:
                return -1
            pixel = src[pos + 1]
            pos += 2
        if n == 1 and pixel != 0:
            return 1
        count = pixel & 0x7F
        if not count:
            return 0
        if x + count > width:
            return -1
        if pixel & 0x80:
            if pos + bpc * count > last:
                return -1
            row[x : x + count, channel] = np.frombuffer(src, np.uint8, count * bpc, pos)[::bpc]
            pos += bpc * count
        else:
            if pos + bpc - 1 > last:
                return -1
            row[x : x + count, channel] = src[pos]
            pos += bpc
        x += count
        n -= 1
    return 0


# ---------------------------------------------------------------------------
# Sun raster
# ---------------------------------------------------------------------------

SUN_MAGIC = 0x59A66A95


def is_sun(blob: bytes) -> bool:
    """PIL's ``SunImagePlugin._accept``."""
    return len(blob) >= 4 and _u32(blob, 0) == SUN_MAGIC


def decode_sun(blob: bytes, name: str = "image") -> np.ndarray:
    """A Sun raster file as (H, W, 3) uint8, as PIL's ``SunImagePlugin``,
    its ``sun_rle`` decoder and ``convert("RGB")`` give it. Raises
    NotImplementedError naming a depth, file type or colour map PIL does
    not read, ValueError on a truncated file."""
    blob = bytes(blob)
    if not is_sun(blob) or len(blob) < 32:
        raise ValueError(f"{name} is not a Sun raster file")
    width, height, depth, _, kind, map_type, map_length = struct.unpack_from(">7I", blob, 4)
    if depth not in (1, 4, 8, 24, 32):
        raise NotImplementedError(f"{name}: {depth}-bit Sun raster (PIL does not read it)")
    palette = None
    if map_length:
        if map_length > 1024:
            raise NotImplementedError(f"{name}: Sun raster colour map of {map_length} bytes "
                                      "(PIL reads at most 1024)")
        if map_type != 1:
            raise NotImplementedError(f"{name}: Sun raster colour map type {map_type} (PIL "
                                      "reads only type 1, RGB)")
        if depth not in (4, 8):
            raise NotImplementedError(f"{name}: {depth}-bit Sun raster with a colour map (PIL "
                                      "does not read it)")
        if map_length // 3 > 256:
            raise NotImplementedError(f"{name}: Sun raster colour map of {map_length // 3} "
                                      "entries (PIL's palette holds 256)")
        _need(blob, 32 + map_length, "Sun raster colour map", name)
        palette = _palette_rgb_l(blob[32 : 32 + map_length])
    if kind not in (0, 1, 2, 3, 4, 5):
        raise NotImplementedError(f"{name}: Sun raster file type {kind} (PIL does not read it)")
    _check_size(width, height, name)
    start = 32 + map_length
    row = (width * depth + 7) // 8
    if kind == 2:
        rows = _sun_rle(blob, start, row, height, name)
    else:
        rows = _raw_rows(blob, start, row, height, ((width * depth + 15) // 16) * 2,
                         "Sun raster", name)
    if depth == 1:
        return _grey((1 - _unpack_bits(rows, 1, width)) * 255)
    if depth in (4, 8):
        values = _unpack_bits(rows, 4, width) if depth == 4 else rows[:, :width]
        if palette is not None:
            return palette[values]
        return _grey(values * 17 if depth == 4 else values)
    pixels = rows.reshape(height, width, depth // 8)
    return np.ascontiguousarray(pixels[..., :3] if kind == 3 else pixels[..., 2::-1])


def _sun_rle(blob, pos, row, height, name) -> np.ndarray:
    """``SunRleDecode.c``: ``0x80 n v`` runs n + 1 of v, ``0x80 0`` is one
    0x80, any other byte is itself; rows of ``row`` bytes (no padding),
    and a run's remainder goes on into the next rows."""
    total = row * height
    out = bytearray()
    length = len(blob)
    while len(out) < total:
        if pos >= length:
            raise ValueError(f"{name}: truncated Sun raster: run-length data for {len(out)} "
                             f"of {total} bytes")
        byte = blob[pos]
        if byte != 0x80:
            out.append(byte)
            pos += 1
        elif pos + 1 < length and blob[pos + 1] == 0:
            out.append(0x80)
            pos += 2
        else:
            if pos + 2 >= length:
                raise ValueError(f"{name}: truncated Sun raster in a run")
            out += blob[pos + 2 : pos + 3] * (blob[pos + 1] + 1)
            pos += 3
    return np.frombuffer(bytes(out[:total]), np.uint8).reshape(height, row)


# ---------------------------------------------------------------------------
# ICNS
# ---------------------------------------------------------------------------

ICNS_SIGNATURE = b"icns"
# PIL's ``IcnsFile.SIZES``: (width, height, scale) -> its entries, in order.
ICNS_SIZES = {
    (512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",), (256, 256, 2): (b"ic14",),
    (256, 256, 1): (b"ic08",), (128, 128, 2): (b"ic13",),
    (128, 128, 1): (b"ic07", b"it32", b"t8mk"), (64, 64, 1): (b"icp6",),
    (32, 32, 2): (b"ic12",), (48, 48, 1): (b"ih32", b"h8mk"),
    (32, 32, 1): (b"icp5", b"il32", b"l8mk"), (16, 16, 2): (b"ic11",),
    (16, 16, 1): (b"icp4", b"is32", b"s8mk"),
}
_ICNS_RLE = (b"is32", b"il32", b"ih32", b"it32")
_ICNS_MASKS = (b"s8mk", b"l8mk", b"h8mk", b"t8mk")


def is_icns(blob: bytes) -> bool:
    """PIL's ``IcnsImagePlugin._accept``."""
    return blob[:4] == ICNS_SIGNATURE


def decode_icns(blob: bytes, name: str = "image") -> np.ndarray:
    """A Mac OS icon file's largest icon as (H, W, 3) uint8, as PIL's
    ``IcnsImagePlugin`` and ``convert("RGB")`` give it: the largest (width,
    height, scale) with an entry of PIL's table; of its entries a PNG or
    JPEG 2000 one wins, else the 24-bit one (raw, or PackBits-like runs per
    channel, ``it32`` after four zero bytes), whose mask PIL reads and
    ``convert("RGB")`` drops. Raises NotImplementedError where PIL finds
    no 32-bit icon, ValueError on a truncated or corrupt file."""
    from .jpeg2000 import decode_jpeg2000
    from .tools import _PNG_SIGNATURE, decode_png

    blob = bytes(blob)
    if not is_icns(blob) or len(blob) < 8:
        raise ValueError(f"{name} is not an ICNS file")
    entries = {}
    end, pos = _u32(blob, 4), 8
    while pos < end:
        if pos < 0 or pos + 8 > len(blob):
            raise ValueError(f"{name}: truncated ICNS entry header")
        kind, size = blob[pos : pos + 4], _u32(blob, pos + 4)
        if size <= 0:
            raise ValueError(f"{name}: ICNS entry of {size} bytes")
        entries[kind] = (pos + 8, size - 8)
        pos += size
    sizes = [size for size, kinds in ICNS_SIZES.items() if any(k in entries for k in kinds)]
    if not sizes:
        raise NotImplementedError(f"{name}: ICNS without a 32-bit icon (PIL reads none of "
                                  f"{sorted(k.decode('latin-1') for k in entries)})")
    best = max(sizes)
    width, height = best[0] * best[2], best[1] * best[2]
    rgb = compressed = None
    for kind in ICNS_SIZES[best]:
        if kind not in entries:
            continue
        start, length = entries[kind]
        if kind in _ICNS_MASKS:
            if start + width * height > len(blob):
                raise ValueError(f"{name}: truncated ICNS mask {kind.decode()}")
        elif kind in _ICNS_RLE:
            if kind == b"it32":
                if blob[start : start + 4] != b"\0\0\0\0":
                    raise ValueError(f"{name}: ICNS it32 entry without its four zero bytes")
                start, length = start + 4, length - 4
            rgb = _icns_rgb(blob, start, length, width, height, name)
        else:
            head = blob[start : start + 12]
            if head.startswith(_PNG_SIGNATURE):
                compressed = decode_png(blob[start:], name)
            elif head.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")) or \
                    head == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
                compressed = decode_jpeg2000(blob[start : start + length], name)
            else:
                raise ValueError(f"{name}: ICNS entry {kind.decode()} is neither PNG nor "
                                 "JPEG 2000")
    if compressed is not None:
        # PIL's image takes the embedded image's size, if the icon's sizes allow it.
        h, w = compressed.shape[:2]
        if not any(s[0] * s[2] // w == s[1] * s[2] / h for s in sizes):
            raise ValueError(f"{name}: ICNS entry of {w} x {h} pixels fits none of its sizes")
        return compressed
    if rgb is None:
        raise ValueError(f"{name}: ICNS icon {best} has a mask but no colour entry")
    return rgb


def _icns_rgb(blob, start, length, width, height, name) -> np.ndarray:
    """``read_32``: ``length`` equal to three planes' bytes is raw RGB;
    anything else is three channels of runs in turn (a byte b >= 128
    repeats the next byte b - 125 times, b < 128 copies b + 1 bytes), read
    on from ``start`` whatever the entry's length."""
    area = width * height
    if length == 3 * area:
        if start + length > len(blob):
            raise ValueError(f"{name}: truncated ICNS icon")
        return np.frombuffer(blob, np.uint8, length, start).reshape(height, width, 3).copy()
    planes = []
    pos = start
    for channel in range(3):
        data = bytearray()
        left = area
        while left > 0 and pos < len(blob):
            byte = blob[pos]
            pos += 1
            if byte & 0x80:
                count = byte - 125
                data += blob[pos : pos + 1] * count
                pos += 1
            else:
                count = byte + 1
                data += blob[pos : pos + count]
                pos += count
            left -= count
        if left != 0 or len(data) < area:
            raise ValueError(f"{name}: corrupt ICNS icon: channel {channel} ends "
                             f"{-left if left < 0 else left} bytes "
                             f"{'past' if left < 0 else 'short of'} its plane")
        planes.append(np.frombuffer(bytes(data[:area]), np.uint8).reshape(height, width))
    return np.stack(planes, -1)


# ---------------------------------------------------------------------------
# IM (IFUNC Image Memory)
# ---------------------------------------------------------------------------

# PIL's ``ImImagePlugin.OPEN``: image type -> (mode, raw mode).
IM_TYPES = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
    "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"),
    "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
    "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
    "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    IM_TYPES[f"L {_i} image"] = IM_TYPES[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    IM_TYPES[f"L {_i} image"] = IM_TYPES[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
IM_TYPES["L 32S image"] = IM_TYPES["L*32S image"] = ("I", "I;32S")
for _i in range(2, 33):
    IM_TYPES[f"L*{_i} image"] = ("F", f"F;{_i}")
del _i
_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut",
            "Name", "Scale (x,y)", "Image size (x*y)", "Image type")
# The raw modes PIL unpacks into each mode an IM header can give (``F``
# takes every ``F;...`` raw mode of the table).
_IM_UNPACKERS = {"1": ("1",), "L": ("L",), "P": ("P;2", "P;4", "P"),
                 "RGB": ("RGB;L", "RGB", "RGB;T", "RYB;T", "RGBX;L"), "RGBA": ("RGBA;L",),
                 "CMYK": ("CMYK;L",), "YCbCr": ("YCbCr;L",), "LA": ("LA;L",), "PA": ("PA;L",),
                 "I": ("I;32", "I;32S"), "I;16": ("I;16",), "I;16L": ("I;16L",),
                 "I;16B": ("I;16B",)}
# Raw modes whose rows hold each band's line in turn.
_IM_LINE_BANDS = {"RGB;L": 3, "RGBA;L": 4, "RGBX;L": 4, "CMYK;L": 4, "YCbCr;L": 3, "LA;L": 2,
                  "PA;L": 2}
# Raw modes of samples of one size: numpy type of the stored sample.
_IM_SAMPLES = {"I;16": "<u2", "I;16L": "<u2", "I;16B": ">u2", "I;32": "<i4", "I;32S": "<i4",
               "F;8": "u1", "F;8S": "i1", "F;16": "<u2", "F;16S": "<i2", "F;32": "<u4",
               "F;32F": "<f4"}


def _im_number(text: str):
    try:
        return int(text)
    except ValueError:
        return float(text)


def im_header(blob: bytes, name: str = "image") -> typing.Optional[dict]:
    """What ``ImImagePlugin._open`` makes of the start of a file: None
    where it raises ``SyntaxError`` (so PIL tries the next format), else
    the header's mode, raw mode, size, palette and where the pixels start.
    Raises ValueError where PIL's opener raises another error (a size or
    frame count that is not a number)."""
    if b"\n" not in blob[:100]:
        return None
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    rawmode, tags, pos, length = "L", 0, 0, len(blob)
    byte = b""
    while True:
        byte = blob[pos : pos + 1]
        pos += 1
        if byte == b"\r":
            continue
        if not byte or byte in (b"\0", b"\x1a"):
            break
        newline = blob.find(b"\n", pos)
        end = length if newline < 0 else newline + 1
        line = byte + blob[pos:end]
        pos = end
        if len(line) > 100:
            return None
        if line.endswith(b"\r\n"):
            line = line[:-2]
        elif line.endswith(b"\n"):
            line = line[:-1]
        match = _IM_SPLIT.match(line)
        if not match:
            return None
        key, value = (g.decode("latin-1", "replace") for g in match.group(1, 2))
        if key in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            try:
                value = tuple(map(_im_number, value.replace("*", ",").split(",")))
            except ValueError:
                raise ValueError(f"{name}: IM header {key!r} is not a number") from None
            if len(value) == 1:
                value = value[0]
        elif key == "Image type" and value in IM_TYPES:
            value, rawmode = IM_TYPES[value]
        info[key] = value
        tags += key in _IM_TAGS
    if not tags:
        return None
    # The pixels follow the first 0x1a on from where the header stopped.
    while byte and byte != b"\x1a":
        byte = blob[pos : pos + 1]
        pos += 1
    if not byte:
        return None
    mode, size = info["Image type"], info["Image size (x*y)"]
    palette = None
    if "Lut" in info:
        lut = blob[pos : pos + 768]
        pos += 768
        if len(lut) < 768:
            return None
        planes = np.frombuffer(lut, np.uint8).reshape(3, 256)
        grey = bool((planes[0] == planes[1]).all() and (planes[0] == planes[2]).all())
        if not grey and mode in ("L", "LA", "P", "PA"):
            palette = planes.T.copy()
            mode, rawmode = ("P", "P") if mode in ("L", "P") else ("PA", "PA;L")
    return {"mode": mode, "rawmode": rawmode, "size": size, "palette": palette, "start": pos}


def is_im(blob: bytes) -> bool:
    """Whether ``ImImagePlugin._open`` takes the file (IM has no magic
    bytes; PIL tries it on every file that reaches it)."""
    return im_header(blob) is not None


def decode_im(blob: bytes, name: str = "image") -> np.ndarray:
    """An IFUNC IM file's first image as (H, W, 3) uint8, as PIL's
    ``ImImagePlugin`` and ``convert("RGB")`` give it (see the module's
    docstring): rows bottom up; 16- and 32-bit integers and float samples
    clipped to 0-255 (floats truncated); a palette image without a colour
    ``Lut`` black. Raises NotImplementedError naming an image type PIL
    has no unpacker for, ValueError on a truncated or corrupt file."""
    blob = bytes(blob)
    header = im_header(blob, name)
    if header is None:
        raise ValueError(f"{name} is not an IM file")
    mode, rawmode, size = header["mode"], header["rawmode"], header["size"]
    if not (isinstance(size, tuple) and len(size) == 2 and all(isinstance(v, int) for v in size)):
        raise ValueError(f"{name}: IM image size {size!r}")
    width, height = size
    if width < 0 or height < 0:
        raise ValueError(f"{name}: IM image size {size!r}")
    _check_size(width, height, name)
    start = header["start"]
    if not (mode == "F" and rawmode.startswith("F;")) and rawmode not in _IM_UNPACKERS.get(
            mode, ()):
        raise NotImplementedError(f"{name}: IM image of mode {mode!r} and raw mode "
                                  f"{rawmode!r} (PIL has no unpacker for it)")
    if rawmode in ("RGB;T", "RYB;T"):
        area = width * height
        planes = [_raw_rows(blob, start + k * area, width, height, width, "IM", name)[::-1]
                  for k in range(3)]
        return np.ascontiguousarray(np.stack([planes[1], planes[0], planes[2]], -1))
    bits = rawmode[2:] if rawmode.startswith("F;") else None
    if bits is not None and bits.isdigit() and int(bits) not in (8, 16, 32):
        values = _im_bits(blob, start, width, height, int(bits), name)
        return _grey(_float_to_l(values))
    if rawmode in _IM_SAMPLES:
        dtype = np.dtype(_IM_SAMPLES[rawmode])
        rows = _raw_rows(blob, start, width * dtype.itemsize, height, width * dtype.itemsize,
                         "IM", name)[::-1]
        values = np.ascontiguousarray(rows).view(dtype).reshape(height, width)
        if mode == "F":
            return _grey(_float_to_l(values.astype(np.float32)))
        return _grey(np.clip(values.astype(np.int64), 0, 255))
    if rawmode in _IM_LINE_BANDS:
        count = _IM_LINE_BANDS[rawmode]
        rows = _raw_rows(blob, start, count * width, height, count * width, "IM", name)[::-1]
        bands = rows.reshape(height, count, width).transpose(0, 2, 1)
        if mode in ("LA", "PA"):
            if mode == "LA":
                return _grey(bands[..., 0])
            return header["palette"][bands[..., 0]]
        if mode == "CMYK":
            return cmyk_to_rgb(bands)
        if mode == "YCbCr":
            from .jpeg2000 import ycbcr_to_rgb

            return ycbcr_to_rgb(bands)
        return np.ascontiguousarray(bands[..., :3])
    depth = {"1": 1, "P;2": 2, "P;4": 4}.get(rawmode, 8) * (3 if rawmode == "RGB" else 1)
    stride = (width * depth + 7) // 8
    rows = _raw_rows(blob, start, stride, height, stride, "IM", name)[::-1]
    if rawmode == "RGB":
        return np.ascontiguousarray(rows.reshape(height, width, 3))
    values = _unpack_bits(rows, depth, width) if depth < 8 else rows
    if mode == "1":
        return _grey(values * 255)
    if mode == "L":
        return _grey(values)
    palette = header["palette"]
    return (palette if palette is not None else np.zeros((256, 3), np.uint8))[values]


def _float_to_l(values: np.ndarray) -> np.ndarray:
    """PIL's ``F`` -> ``L``: 0 at or below 0, 255 at or above 255, else
    truncated (NaN as x86's conversion leaves it, 0)."""
    values = np.nan_to_num(values.astype(np.float32), nan=0.0)
    return np.where(values <= 0, 0, np.where(values >= 255, 255,
                                             np.trunc(np.clip(values, 0, 255)))).astype(np.uint8)


def _im_bits(blob, start, width, height, bits, name) -> np.ndarray:
    """PIL's ``bit`` decoder with the IM plugin's arguments (pad 8, fill
    3, unsigned, bottom up): bits gathered least significant first into a
    64-bit buffer; a new row drops the count of bits left but not the
    buffer's bits, which the next bytes are or'd into."""
    mask = (1 << bits) - 1
    out = np.zeros((height, width), np.float32)
    buffer = count = x = 0
    y = height - 1
    pos, length = start, len(blob)
    if width == 0 or height == 0:
        return out
    row = [0] * width
    while True:
        if pos >= length:
            raise ValueError(f"{name}: truncated IM in the image data")
        byte = blob[pos]
        pos += 1
        buffer = (buffer | (byte << count)) & 0xFFFFFFFFFFFFFFFF
        count += 8
        while count >= bits:
            row[x] = buffer & mask
            if count > 32:
                buffer = byte >> (8 - (count - bits))
            else:
                buffer >>= bits
            count -= bits
            x += 1
            if x >= width:
                out[y] = row
                y -= 1
                if y < 0:
                    return out
                x = count = 0


# ---------------------------------------------------------------------------
# MSP (Windows Paint)
# ---------------------------------------------------------------------------


def is_msp(blob: bytes) -> bool:
    """PIL's ``MspImagePlugin._accept``."""
    return blob[:4] in (b"DanM", b"LinS")


def decode_msp(blob: bytes, name: str = "image") -> np.ndarray:
    """A Windows Paint file as (H, W, 3) uint8, as PIL's ``MspImagePlugin``
    and ``convert("RGB")`` give it: version 1 raw, version 2 run-length
    rows by the row map (a row of length 0 is white), bit 1 white. Raises
    ValueError on a bad header checksum or a truncated file."""
    blob = bytes(blob)
    if not is_msp(blob) or len(blob) < 32:
        raise ValueError(f"{name} is not an MSP file")
    checksum = 0
    for word in struct.unpack_from("<16H", blob):
        checksum ^= word
    if checksum:
        raise ValueError(f"{name}: bad MSP header checksum")
    width, height = struct.unpack_from("<HH", blob, 4)
    stride = (width + 7) // 8
    if blob[:4] == b"DanM":
        rows = _raw_rows(blob, 32, stride, height, stride, "MSP", name)
    else:
        if 32 + 2 * height > len(blob):
            raise ValueError(f"{name}: truncated MSP in the row map")
        lengths = struct.unpack_from(f"<{height}H", blob, 32)
        data = bytearray()
        pos = 32 + 2 * height
        for y, count in enumerate(lengths):
            if count == 0:
                data += b"\xff" * stride
                continue
            line = blob[pos : pos + count]
            pos += count
            if len(line) != count:
                raise ValueError(f"{name}: truncated MSP in row {y}")
            at = 0
            while at < count:
                kind = line[at]
                at += 1
                if kind == 0:
                    if at + 2 > count:
                        raise ValueError(f"{name}: corrupt MSP run in row {y}")
                    data += line[at + 1 : at + 2] * line[at]
                    at += 2
                else:
                    data += line[at : at + kind]
                    at += kind
        if len(data) < stride * height:
            raise ValueError(f"{name}: MSP rows hold {len(data)} of {stride * height} bytes")
        rows = np.frombuffer(bytes(data[: stride * height]), np.uint8).reshape(height, stride)
    return _grey(_unpack_bits(rows, 1, width) * 255)


# ---------------------------------------------------------------------------
# XBM and XPM
# ---------------------------------------------------------------------------

_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
_HEX = np.zeros(256, np.uint8)
for _k, _c in enumerate(b"0123456789abcdef"):
    _HEX[_c] = _k
for _k, _c in enumerate(b"ABCDEF"):
    _HEX[_c] = 10 + _k
del _k, _c


def is_xbm(blob: bytes) -> bool:
    """PIL's ``XbmImagePlugin._accept``."""
    return blob[:16].lstrip().startswith(b"#define")


def decode_xbm(blob: bytes, name: str = "image") -> np.ndarray:
    """An X11 bitmap as (H, W, 3) uint8, as PIL's ``XbmImagePlugin``, its
    ``xbm`` decoder and ``convert("RGB")`` give it: the header as PIL's
    pattern matches it in the first 512 bytes; then each ``x`` and the two
    characters after it are a byte (a character that is not a hex digit
    counts 0), rows of whole bytes, least significant bit first, bit 1
    white. Raises ValueError on a header PIL does not match or too few
    bytes."""
    blob = bytes(blob)
    match = _XBM_HEAD.match(blob[:512])
    if not is_xbm(blob) or not match:
        raise ValueError(f"{name} is not an XBM file")
    width, height = int(match.group("width")), int(match.group("height"))
    _check_size(width, height, name)
    stride = (width + 7) // 8
    need = stride * height
    body = np.frombuffer(blob, np.uint8, offset=match.end())
    at = np.flatnonzero(body == ord("x"))
    at = at[at + 2 < len(body)]
    # Each byte's "x" is looked for after the two characters of the last.
    picked, last = [], -3
    for position in at.tolist():
        if position >= last + 3:
            picked.append(position)
            last = position
            if len(picked) == need:
                break
    if len(picked) < need:
        raise ValueError(f"{name}: truncated XBM: {len(picked)} of {need} bytes")
    picked = np.asarray(picked, np.int64)
    values = (_HEX[body[picked + 1]] << 4) + _HEX[body[picked + 2]]
    rows = np.unpackbits(values.astype(np.uint8).reshape(height, stride), axis=1,
                         bitorder="little")[:, :width]
    return _grey(rows * 255)


XPM_SIGNATURE = b"/* XPM */"
_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def is_xpm(blob: bytes) -> bool:
    """PIL's ``XpmImagePlugin._accept``."""
    return blob[:9] == XPM_SIGNATURE


def _lines(blob: bytes, pos: int):
    """``readline`` from ``pos`` on: each line with its newline."""
    length = len(blob)
    while pos < length:
        end = blob.find(b"\n", pos)
        end = length if end < 0 else end + 1
        yield blob[pos:end]
        pos = end


def decode_xpm(blob: bytes, name: str = "image") -> np.ndarray:
    """An X11 pixmap as (H, W, 3) uint8, as PIL's ``XpmImagePlugin`` reads
    it: the first line that starts ``"w h colours chars``, one line a
    colour taking only its ``c`` key (``#rrggbb`` as a hex number's low 24
    bits, ``None`` transparent), then the pixels between the first and
    last quote of each line until the image is full (one ``/* pixels */``
    line skipped). Raises NotImplementedError on a colour name (PIL reads
    only ``#`` values), ValueError on a colour line without a ``c`` key,
    a pixel without a colour, or too few pixels."""
    blob = bytes(blob)
    if not is_xpm(blob):
        raise ValueError(f"{name} is not an XPM file")
    lines = _lines(blob, 9)
    for line in lines:
        match = _XPM_HEAD.match(line)
        if match:
            break
    else:
        raise ValueError(f"{name}: broken XPM file: no header line")
    try:
        width, height, colours, chars = (int(g) for g in match.groups())
    except ValueError:
        raise ValueError(f"{name}: XPM header {match.group(0)!r}") from None
    _check_size(width, height, name)
    palette = {}
    for _ in range(colours):
        line = next(lines, b"").rstrip()
        key = line[1 : chars + 1]
        words = line[chars + 1 : -2].split()
        for i in range(0, len(words), 2):
            if words[i] == b"c":
                if i + 1 == len(words):
                    raise ValueError(f"{name}: XPM colour line without a colour: {line!r}")
                value = words[i + 1]
                if value == b"None":
                    break
                if not value.startswith(b"#"):
                    raise NotImplementedError(f"{name}: XPM colour {value!r} (PIL reads only "
                                              "#rrggbb colours)")
                try:
                    number = int(value[1:], 16)
                except ValueError:
                    raise ValueError(f"{name}: XPM colour {value!r}") from None
                palette[key] = ((number >> 16) & 255, (number >> 8) & 255, number & 255)
                break
        else:
            raise ValueError(f"{name}: XPM colour line without a c key: {line!r}")
    total = width * height
    keys = []
    header = False
    for line in lines:
        if len(keys) >= total:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        keys.extend(line[i : i + chars] for i in range(0, len(line), chars))
    if len(keys) < total:
        raise ValueError(f"{name}: truncated XPM: {len(keys)} of {total} pixels")
    try:  # PIL looks up every pixel of the lines it reads, past the last too
        pixels = [palette[key] for key in keys]
    except KeyError as error:
        raise ValueError(f"{name}: XPM pixel {error.args[0]!r} has no colour") from None
    return np.asarray(pixels[:total], np.uint8).reshape(height, width, 3)
