"""TIFF, BMP, DIB, PNM, TGA, PCX, DCX, ICO and CUR decoding for
:func:`keras_ocr_tpu_torch.tools.read`.

JAX's ``tools.read`` is PIL's ``Image.open(f).convert("RGB")``
(``keras_ocr_tpu/tools.py``), so it opens every format PIL opens. These
decoders give the same pixels, bit for bit, with numpy and the standard
library (``zlib``) only:

* :func:`decode_tiff`: the first image file directory of a TIFF file, as
  PIL 12 with libtiff 4.7 opens it: both byte orders, strips and tiles,
  planar configurations 1 and 2, 1, 2, 4, 8 and 16 unsigned bits per
  sample, WhiteIsZero, BlackIsZero, RGB (with extra samples), palette,
  CMYK and, JPEG-compressed, YCbCr; ``FillOrder`` 2; compressions none,
  CCITT modified Huffman (2), CCITT Group 3 1-D and 2-D (3), Group 4 (4),
  LZW (5), JPEG (7, through :func:`.tools.decode_jpeg`'s arithmetic),
  Deflate (8, 32946) and PackBits (32773); horizontal differencing
  (``Predictor`` 2) at 8 and 16 bits. Each layout maps to PIL's mode and
  raw mode (``TiffImagePlugin.OPEN_INFO``) and converts to RGB as PIL's
  ``convert("RGB")`` does: 16-bit grey clipped at 255, 16-bit colour
  samples' high byte, 2- and 4-bit grey scaled by 85 and 17, WhiteIsZero
  inverted (except 16-bit, which PIL does not invert), the palette's
  16-bit entries floored to 8 bits, associated alpha divided out, CMYK by
  :func:`cmyk_to_rgb`.
* :func:`decode_bmp`: ``BITMAPCOREHEADER`` (OS/2 1.x) and
  ``BITMAPINFOHEADER`` through v5; 1, 4, 8, 16, 24 and 32 bits; ``BI_RGB``,
  ``BI_RLE8``, ``BI_RLE4`` and ``BI_BITFIELDS`` with the masks PIL reads;
  bottom-up and top-down rows; palettes shorter than the depth allows
  (indices past them are black), and grey palettes, which PIL opens as
  ``L`` or ``1`` images. PIL's RLE decoder is followed where it departs
  from the format (a delta escape skips two bytes before its offsets,
  and an odd RLE4 literal run reads one pixel less than it counts).
  :func:`decode_dib` reads the same bitmap without its file header, as
  PIL's ``DibImageFile`` does.
* :func:`decode_pnm`: P1-P6, plain and raw, comments in the header, maxval
  1-65535 scaled as PIL scales it (to 0-255, or to 0-65535 for grey above
  255, which ``convert("RGB")`` then clips), the first image of a file.
* :func:`decode_tga`: image types 1-3 and their run-length forms 9-11 at
  PIL's depths, colour maps of 16- or 24-bit entries from any first
  index, both orientation bits, literal packets across rows (PIL's
  ``TgaRleDecode``); TGA has no magic bytes, so :func:`is_tga` makes
  PIL's header checks and ``tools.read`` tries it last, as PIL does.
* :func:`decode_pcx`: 1-bit, 1-bit over 2 or 4 planes, 8-bit grey or with
  the trailing palette, 8-bit RGB over 3 planes, run-length rows in PIL's
  stride (``PcxDecode``, its band shuffle included).
* :func:`decode_ico`: an icon's largest entry (PIL's order) or a
  cursor's, as PNG or as a DIB through the BMP decoder at half height.

Anything else (BigTIFF, old-style JPEG, LZMA, ZSTD, WebP, floating-point
or signed samples, bit depths above 16, YCbCr without JPEG, a TGA or PCX
run packet past a row's end, ...) raises ``NotImplementedError`` naming
it; a truncated or corrupt file raises
``ValueError``. The CCITT and LZW decoders loop in Python over codes and
fill runs with numpy. WebP files are read by :mod:`.webp`; WebP inside a
TIFF (compression 50001) stays refused.
"""

from __future__ import annotations

import math
import struct
import typing
import zlib

import numpy as np

from .jpeg_modes import windows

# Classic TIFF, then BigTIFF (refused).
TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")
PNM_SIGNATURES = tuple(b"P%d" % i for i in range(1, 7))
# The first two bytes of the PNM kinds PIL opens: P1-P6, and P0CMYK, Pf
# and its Py* test formats, which the port refuses.
PNM_PREFIXES = PNM_SIGNATURES + (b"P0", b"Pf", b"Py")

# ---------------------------------------------------------------------------
# Colour conversions
# ---------------------------------------------------------------------------


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 CMYK -> (..., 3) uint8 RGB as Pillow's ``cmyk2rgb``:
    ``nk - round(c * nk / 255)`` with ``nk = 255 - k`` (its ``MULDIV255``)."""
    cmyk = np.asarray(cmyk).astype(np.int32)
    nk = 255 - cmyk[..., 3:4]
    product = cmyk[..., :3] * nk + 128
    return (nk - (((product >> 8) + product) >> 8)).astype(np.uint8)


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's ``RGBa`` unpacking: each colour times 255 over alpha,
    floored and clipped at 255, and black where alpha is 0."""
    alpha = rgba[..., 3:4].astype(np.int32)
    colour = rgba[..., :3].astype(np.int32)
    out = np.minimum(colour * 255 // np.maximum(alpha, 1), 255)
    return np.where(alpha == 0, 0, out).astype(np.uint8)


def _grey(plane: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.repeat(plane.astype(np.uint8)[..., None], 3, axis=-1))


def _unpack_bits(rows: np.ndarray, bits: int, count: int) -> np.ndarray:
    """The first ``count`` ``bits``-bit values (MSB first) of each row of
    bytes, as uint8."""
    unpacked = np.unpackbits(rows, axis=1)[:, : count * bits].reshape(len(rows), count, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (unpacked * weights).sum(-1).astype(np.uint8)


# ---------------------------------------------------------------------------
# TIFF: the directory
# ---------------------------------------------------------------------------

_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 13: "I"}
_TIFF_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4,
                    12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
_COMPRESSIONS = {1: "none", 2: "CCITT modified Huffman", 3: "CCITT Group 3", 4: "CCITT Group 4",
                 5: "LZW", 6: "old-style JPEG", 7: "JPEG", 8: "Adobe Deflate",
                 32771: "CCITT modified Huffman with word alignment", 32773: "PackBits",
                 32809: "ThunderScan", 32946: "Deflate", 34676: "SGILog",
                 34677: "SGILog24", 34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA",
                 50000: "ZSTD", 50001: "WebP", 50002: "JPEG XL"}
_SUPPORTED_COMPRESSIONS = (1, 2, 3, 4, 5, 7, 8, 32773, 32946)
_BANDS = {"1": 1, "L": 1, "I;16": 1, "I;16B": 1, "P": 1, "LA": 2, "PA": 2, "RGB": 3,
          "RGBA": 4, "CMYK": 4}


def _tiff_directory(blob: bytes, name: str) -> typing.Tuple[str, dict]:
    """The byte order (``<`` or ``>``) and the first IFD's entries: tag ->
    (type, count, value bytes)."""
    if blob[:4] in TIFF_SIGNATURES[2:]:
        raise NotImplementedError(f"{name}: BigTIFF is not supported")
    if blob[:4] not in TIFF_SIGNATURES:
        raise ValueError(f"{name} is not a TIFF file")
    order = "<" if blob[:2] == b"II" else ">"
    if len(blob) < 8:
        raise ValueError(f"{name}: truncated TIFF header")
    (pos,) = struct.unpack_from(order + "I", blob, 4)
    if pos + 2 > len(blob):
        raise ValueError(f"{name}: truncated TIFF: the first IFD lies past the end")
    (count,) = struct.unpack_from(order + "H", blob, pos)
    if pos + 2 + 12 * count > len(blob):
        raise ValueError(f"{name}: truncated TIFF in the first IFD")
    entries = {}
    for i in range(count):
        tag, kind, n = struct.unpack_from(order + "HHI", blob, pos + 2 + 12 * i)
        size = _TIFF_TYPE_SIZES.get(kind)
        if size is None:
            continue
        field = pos + 2 + 12 * i + 8
        if size * n > 4:
            (field,) = struct.unpack_from(order + "I", blob, field)
        value = blob[field : field + size * n]
        if len(value) != size * n:
            raise ValueError(f"{name}: truncated TIFF: tag {tag}'s value lies past the end")
        entries[tag] = (kind, n, value)
    return order, entries


def _tag_ints(order, entries, tag, default=None) -> typing.Optional[tuple]:
    if tag not in entries:
        return default
    kind, n, value = entries[tag]
    if kind not in _TIFF_TYPES:
        raise ValueError(f"TIFF tag {tag} is not of an integer type ({kind})")
    return struct.unpack(order + _TIFF_TYPES[kind] * n, value)


def _tiff_mode(order, photo, fill, bps, extra) -> typing.Optional[typing.Tuple[str, str]]:
    """PIL's (mode, raw mode) of an unsigned-integer TIFF layout, as its
    ``TiffImagePlugin.OPEN_INFO`` table gives them, or None where the
    table has no entry (PIL does not open the file)."""
    reverse = "R" if fill == 2 else ""
    little = order == "<"
    if photo in (0, 1) and len(bps) == 1 and not extra:
        invert = "I" if photo == 0 else ""
        bits = bps[0]
        if bits == 1:
            return "1", "1" + (";" + invert + reverse if invert or reverse else "")
        if bits in (2, 4):
            return "L", f"L;{bits}{invert}{reverse}"
        if bits == 8:
            return "L", "L" + (";" + invert + reverse if invert or reverse else "")
        if bits == 16:
            if little and fill == 1:
                return "I;16", "I;16"
            if little and photo == 1:
                return "I;16", "I;16R"
            if not little and photo == 1 and fill == 1:
                return "I;16B", "I;16B"
        return None
    if photo == 1 and fill == 1 and bps == (8, 8) and extra == (2,):
        return "LA", "LA"
    if photo == 2:
        if bps == (8, 8, 8) and not extra:
            return "RGB", "RGB;R" if fill == 2 else "RGB"
        if fill != 1:
            return None
        colour = {(): "A", (0,): "X", (1,): "a", (2,): "A", (999,): "A"}
        if bps == (8,) * 4 and extra in colour:
            return ("RGB" if extra == (0,) else "RGBA"), "RGB" + colour[extra]
        for more in (1, 2):
            if bps == (8,) * (4 + more) and extra[:1] in ((0,), (1,), (2,)) \
                    and extra[1:] == (0,) * more:
                first = colour[extra[:1]]
                return ("RGB" if first == "X" else "RGBA"), "RGB" + first + "X" * more
        suffix = ";16L" if little else ";16B"
        if bps == (16,) * 3 and not extra:
            return "RGB", "RGB" + suffix
        if bps == (16,) * 4 and extra in ((), (0,), (1,), (2,)):
            first = colour[extra]
            return ("RGB" if first == "X" else "RGBA"), "RGB" + first + suffix
        return None
    if photo == 3:
        if len(bps) == 1 and extra:
            return None
        if len(bps) == 1 and bps[0] in (1, 2, 4):
            return "P", f"P;{bps[0]}{reverse}"
        if bps == (8,):
            return "P", "P;R" if fill == 2 else "P"
        if fill == 1 and bps == (8, 8) and extra in ((0,), (2,)):
            return ("P", "PX") if extra == (0,) else ("PA", "PA")
        return None
    if photo == 5 and fill == 1:
        if bps == (8,) * 4 and not extra:
            return "CMYK", "CMYK"
        if bps == (8,) * 5 and extra == (0,):
            return "CMYK", "CMYKX"
        if bps == (8,) * 6 and extra == (0, 0):
            return "CMYK", "CMYKXX"
        if bps == (16,) * 4 and not extra:
            return "CMYK", "CMYK" + (";16L" if little else ";16B")
        return None
    if photo == 6 and fill == 1:
        if bps == (8, 8, 8) and not extra:
            return "RGB", "RGBX"
        if bps == (8,) and not extra:
            return "L", "L"
    return None


def decode_tiff(blob: bytes, name: str = "image") -> np.ndarray:
    """The first image of a TIFF file as (H, W, 3) uint8, as PIL's
    ``Image.open(...).convert("RGB")`` gives it (see the module's
    docstring for what is read). Raises NotImplementedError naming a
    compression, layout or feature that is not read, ValueError on a
    truncated or corrupt file."""
    order, entries = _tiff_directory(blob, name)

    def ints(tag, default=None):
        return _tag_ints(order, entries, tag, default)

    if 0xBC01 in entries:
        raise NotImplementedError(f"{name}: Windows Media Photo in TIFF is not supported")
    compression = ints(259, (1,))[0]
    if compression not in _SUPPORTED_COMPRESSIONS:
        what = _COMPRESSIONS.get(compression, f"compression {compression}")
        raise NotImplementedError(f"{name}: TIFF with {what} compression is not supported")
    if ints(256) is None or ints(257) is None:
        raise ValueError(f"{name}: corrupt TIFF: no image width or length")
    width, height = ints(256)[0], ints(257)[0]
    if not width or not height:
        raise ValueError(f"{name}: corrupt TIFF: an empty image")
    if ints(274, (1,))[0] in (5, 6, 7, 8):
        raise NotImplementedError(f"{name}: TIFF with a transposing Orientation is not supported")
    photo = ints(262, (0,))[0]
    planar = ints(284, (1,))[0]
    fill = ints(266, (1,))[0]
    sample_format = ints(339, (1,))
    if len(sample_format) > 1 and set(sample_format) == {1}:
        sample_format = (1,)
    if sample_format != (1,):
        kinds = {2: "signed integer", 3: "floating-point", 4: "undefined", 5: "complex integer",
                 6: "complex floating-point"}
        what = ", ".join(sorted({kinds.get(s, str(s)) for s in sample_format if s != 1}))
        raise NotImplementedError(f"{name}: TIFF with {what} samples is not supported")
    bps = ints(258, (1,))
    extra = ints(338, ())
    spp = ints(277, (1,))[0]
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"{name}: corrupt TIFF: {len(bps)} BitsPerSample values for "
                         f"{spp} samples")
    if max(bps) > 16 or any(b not in (1, 2, 4, 8, 16) for b in bps):
        raise NotImplementedError(f"{name}: TIFF with {bps} bits per sample is not supported")
    if photo == 6 and compression != 7:
        raise NotImplementedError(f"{name}: YCbCr TIFF is read only with JPEG compression")
    if photo not in (0, 1, 2, 3, 5, 6):
        kinds = {4: "transparency mask", 8: "CIE L*a*b*", 9: "ICC L*a*b*", 10: "ITU L*a*b*",
                 32844: "LogL", 32845: "LogLuv", 32803: "CFA", 34892: "linear raw"}
        raise NotImplementedError(f"{name}: TIFF of photometric interpretation "
                                  f"{kinds.get(photo, photo)} is not supported")
    modes = _tiff_mode(order, photo, fill, bps, extra)
    if modes is None:
        raise NotImplementedError(
            f"{name}: TIFF layout photometric {photo}, FillOrder {fill}, BitsPerSample {bps}, "
            f"ExtraSamples {extra} is not supported (PIL does not open it either)")
    mode, rawmode = modes
    predictor = ints(317, (1,))[0]
    if compression not in (5, 8, 32946):
        # libtiff reads the tag for its LZW and Deflate codecs only.
        predictor = 1
    if predictor not in (1, 2):
        raise NotImplementedError(f"{name}: TIFF Predictor {predictor} is not supported")
    if predictor == 2 and max(bps) < 8:
        raise NotImplementedError(f"{name}: TIFF Predictor 2 on {max(bps)}-bit samples "
                                  "is not supported (libtiff refuses it too)")
    if compression in (2, 3, 4) and bps != (1,):
        raise ValueError(f"{name}: corrupt TIFF: CCITT compression of {bps}-bit samples")
    if 322 in entries or 324 in entries:
        tile_w, tile_h = (ints(322) or (0,))[0], (ints(323) or (0,))[0]
        offsets, counts = ints(324), ints(325)
        if not tile_w or not tile_h or offsets is None:
            raise ValueError(f"{name}: corrupt TIFF: bad tile tags")
    else:
        tile_w, tile_h = width, min(ints(278, (2**32 - 1,))[0] or height, height)
        offsets, counts = ints(273), ints(279)
        if offsets is None:
            raise ValueError(f"{name}: corrupt TIFF: no StripOffsets")
    planes = spp if planar == 2 else 1
    across, down = -(-width // tile_w), -(-height // tile_h)
    if len(offsets) < across * down * planes:
        raise ValueError(f"{name}: corrupt TIFF: {len(offsets)} strip or tile offsets "
                         f"for {across * down * planes}")
    if compression == 1 and planar == 2 and spp == 1:
        # PIL's raw decoder takes the raw mode's first letter for each
        # plane: a lone plane loses its inversion and bit reversal.
        if bps[0] not in (1, 8):
            raise NotImplementedError(f"{name}: planar uncompressed TIFF of {bps[0]}-bit "
                                      "samples is not supported (PIL misreads it)")
        rawmode, fill = rawmode[:1], 1
    if compression == 1 and rawmode in ("L;IR", "P;1R", "P;2R", "P;4R"):
        raise NotImplementedError(f"{name}: uncompressed TIFF of raw mode {rawmode} (FillOrder "
                                  "2) is not supported (PIL has no unpacker for it)")
    separate = planar == 2 and spp > 1
    if separate and (spp != _BANDS[mode] or (compression == 1 and rawmode not in (
            "RGB", "RGBA", "CMYK"))):
        raise NotImplementedError(f"{name}: planar TIFF of raw mode {rawmode} is not "
                                  "supported (PIL does not read it)")
    layout = {"order": order, "width": width, "height": height, "tile_w": tile_w,
              "tile_h": tile_h, "across": across, "down": down, "bps": bps, "spp": spp,
              "planes": planes, "offsets": offsets, "counts": counts, "fill": fill,
              "predictor": predictor, "compression": compression,
              "tiled": 324 in entries}
    if compression == 7:
        return _tiff_jpeg(blob, layout, photo, mode, rawmode, entries.get(347, (0, 0, b""))[2],
                          name)
    if compression == 1:
        samples = _tiff_raw(blob, layout, name)
    else:
        samples = _tiff_decoded(blob, layout, ints(292, (0,))[0], name)
    if separate and mode == "RGBA" and compression != 1 and extra in ((), (1,)):
        # Pillow's libtiff path divides planar colour by an alpha that
        # is associated or unspecified.
        rawmode = "RGBa"
    return _tiff_rgb(samples, mode, rawmode, bps, ints(320), separate, name)


def _tile_boxes(layout):
    """(plane, y, x, rows, columns) of each strip or tile, in offset order."""
    for plane in range(layout["planes"]):
        for ty in range(layout["down"]):
            for tx in range(layout["across"]):
                y, x = ty * layout["tile_h"], tx * layout["tile_w"]
                yield (plane, y, x, min(layout["tile_h"], layout["height"] - y),
                       min(layout["tile_w"], layout["width"] - x))


def _reverse_bits(data: bytes) -> bytes:
    return data.translate(_BIT_REVERSED)


_BIT_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _tiff_raw(blob, layout, name):
    """Uncompressed strips or tiles, read as PIL's own raw decoder reads
    them (PIL does not hand them to libtiff): from each offset, the rows of
    the strip or tile that lie in the image."""
    bps, spp, planes = layout["bps"], layout["spp"], layout["planes"]
    per_plane = spp // planes
    pieces = []
    for (plane, y, x, rows, cols), offset in zip(_tile_boxes(layout), layout["offsets"]):
        stride = -(-layout["tile_w"] * per_plane * bps[0] // 8)
        data = blob[offset : offset + stride * rows]
        if len(data) != stride * rows:
            raise ValueError(f"{name}: truncated TIFF in the image data")
        if layout["fill"] == 2:
            data = _reverse_bits(data)
        pieces.append((plane, y, x, rows, cols, data, stride))
    return _assemble_samples(layout, pieces, name)


def _tiff_decoded(blob, layout, t4options, name):
    """Compressed strips or tiles, decoded as libtiff decodes them: the
    bits of each byte reversed first for FillOrder 2, the codec, then the
    predictor."""
    bps, spp, planes = layout["bps"], layout["spp"], layout["planes"]
    counts = layout["counts"]
    if counts is None or len(counts) < len(layout["offsets"]):
        raise ValueError(f"{name}: corrupt TIFF: no byte count for each strip or tile")
    per_plane = spp // planes
    compression = layout["compression"]
    pieces = []
    for index, (plane, y, x, rows, cols) in enumerate(_tile_boxes(layout)):
        offset, count = layout["offsets"][index], counts[index]
        data = blob[offset : offset + count]
        if len(data) != count:
            raise ValueError(f"{name}: truncated TIFF in the image data")
        if layout["fill"] == 2:
            data = _reverse_bits(data)
        stride = -(-layout["tile_w"] * per_plane * bps[0] // 8)
        # A strip holds its own rows; a tile always holds tile_h of them.
        stored = layout["tile_h"] if layout["tiled"] else rows
        need = stride * stored
        if compression in (2, 3, 4):
            data = _fax_decode(data, layout["tile_w"], stored, compression, t4options, name)
        elif compression == 5:
            data = _tiff_lzw(data, need, name)
        elif compression in (8, 32946):
            try:
                data = zlib.decompressobj().decompress(data, need)
            except zlib.error as error:
                raise ValueError(f"{name}: corrupt TIFF Deflate data: {error}") from None
        elif compression == 32773:
            data = _packbits(data, need)
        if len(data) < need:
            raise ValueError(f"{name}: truncated TIFF: a strip or tile decodes to "
                             f"{len(data)} of {need} bytes")
        data = data[:need]
        if layout["predictor"] == 2:
            data = _undo_predictor(data, stored, layout["tile_w"], per_plane, bps[0],
                                   layout["order"])
        pieces.append((plane, y, x, rows, cols, data, stride))
    return _assemble_samples(layout, pieces, name)


def _undo_predictor(data, rows, width, samples, bits, order):
    """Horizontal differencing undone: each sample plus the same sample of
    the pixel to its left, modulo 2**bits, along each row."""
    dtype = np.uint8 if bits == 8 else np.dtype(order + "u2")
    values = np.frombuffer(data, dtype).reshape(rows, width, samples)
    summed = np.cumsum(values, axis=1, dtype=np.uint8 if bits == 8 else np.uint16)
    return summed.astype(dtype).tobytes()


def _assemble_samples(layout, pieces, name):
    """Each plane's sample values, (H, W, samples of the plane) as uint8
    or uint16, from the strips' or tiles' row bytes."""
    bps, spp, planes = layout["bps"], layout["spp"], layout["planes"]
    bits = bps[0]
    per_plane = spp // planes
    dtype = np.uint8 if bits <= 8 else np.uint16
    out = [np.zeros((layout["height"], layout["width"], per_plane), dtype)
           for _ in range(planes)]
    for plane, y, x, rows, cols, data, stride in pieces:
        raw = np.frombuffer(data, np.uint8)[: stride * rows].reshape(rows, stride)
        if bits == 16:
            values = raw.view(layout["order"] + "u2").astype(np.uint16)
        elif bits == 8:
            values = raw
        else:
            values = _unpack_bits(raw, bits, stride * 8 // bits)
        values = values[:, : cols * per_plane].reshape(rows, cols, per_plane)
        out[plane][y : y + rows, x : x + cols] = values
    return out


def _tiff_rgb(samples, mode, rawmode, bps, colormap, separate, name):
    """The samples of each plane converted as PIL's raw mode unpacks them
    and ``convert("RGB")`` converts the mode (planes stacked as bands)."""
    values = np.concatenate(samples, axis=-1) if separate else samples[0]
    bits = bps[0]
    if mode == "1":
        bit = values[..., 0] & 1
        return _grey((1 - bit if ";I" in rawmode else bit) * 255)
    if mode in ("L", "LA"):
        grey = values[..., 0].astype(np.int32)
        if bits in (2, 4):
            grey = grey * (255 // ((1 << bits) - 1))
        if rawmode.startswith("L;") and "I" in rawmode[2:]:
            grey = 255 - grey
        return _grey(grey)
    if mode in ("I;16", "I;16B"):
        return _grey(np.minimum(values[..., 0], 255))
    if mode in ("P", "PA"):
        return _palette(values[..., 0], colormap, bps, name)
    if bits == 16:
        values = values >> 8
    values = values.astype(np.uint8)
    if mode == "CMYK":
        return cmyk_to_rgb(values[..., :4])
    if rawmode.startswith("RGBa"):
        return _unpremultiply(values[..., :4])
    return np.ascontiguousarray(values[..., :3])


def _palette(index, colormap, bps, name):
    size = 1 << bps[0]
    if colormap is None or len(colormap) != 3 * size:
        raise ValueError(f"{name}: corrupt TIFF: a palette image without a ColorMap of "
                         f"{3 * size} entries")
    table = np.zeros((256, 3), np.uint8)
    table[:size] = (np.asarray(colormap, np.int64).reshape(3, size).T // 256).astype(np.uint8)
    return table[index]


def _tiff_jpeg(blob, layout, photo, mode, rawmode, tables, name):
    """JPEG-compressed strips or tiles: the ``JPEGTables`` stream joined to
    each one's stream and decoded with :func:`.tools.decode_jpeg`'s
    arithmetic. libtiff has libjpeg convert YCbCr (PhotometricInterpretation
    6) to RGB, with its fancy upsampling; other data comes out as stored."""
    from . import tools

    if layout["planes"] > 1:
        raise NotImplementedError(f"{name}: planar JPEG-compressed TIFF is not supported")
    if layout["fill"] != 1:
        raise NotImplementedError(f"{name}: JPEG-compressed TIFF with FillOrder 2 is "
                                  "not supported")
    if layout["bps"][0] != 8 or mode not in ("L", "RGB", "CMYK"):
        raise NotImplementedError(f"{name}: JPEG-compressed TIFF of {layout['bps']}-bit "
                                  f"samples in mode {mode} is not supported")
    counts = layout["counts"]
    if counts is None or len(counts) < len(layout["offsets"]):
        raise ValueError(f"{name}: corrupt TIFF: no byte count for each strip or tile")
    head = b""
    if tables:
        head = tables[:-2] if tables[-2:] == b"\xff\xd9" else tables
    channels = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    out = np.zeros((layout["height"], layout["width"], channels), np.uint8)
    for index, (plane, y, x, rows, cols) in enumerate(_tile_boxes(layout)):
        offset, count = layout["offsets"][index], counts[index]
        data = blob[offset : offset + count]
        if len(data) != count or data[:2] != b"\xff\xd8":
            raise ValueError(f"{name}: corrupt or truncated TIFF JPEG data")
        stream = head + data[2:] if head else data
        frame, _, _ = tools._jpeg_frame(stream, name)
        if photo != 6 and any((c["h"], c["v"]) != (1, 1) for c in frame["components"]):
            raise NotImplementedError(f"{name}: subsampled JPEG in a TIFF of photometric "
                                      f"{photo} is not supported (libtiff returns it raw)")
        planes = tools._jpeg_planes(frame, name)
        if photo == 6:
            if len(planes) != 3:
                raise ValueError(f"{name}: corrupt TIFF: YCbCr JPEG of {len(planes)} components")
            pixels = tools._ycc_to_rgb(*planes)
        else:
            pixels = np.stack(planes, -1)
        if pixels.shape[0] < rows or pixels.shape[1] < cols or pixels.shape[2] != channels:
            raise ValueError(f"{name}: corrupt TIFF: a JPEG strip or tile of shape "
                             f"{pixels.shape} for {rows}x{cols}")
        out[y : y + rows, x : x + cols] = pixels[:rows, :cols]
    if mode == "RGB":
        return out
    if mode == "CMYK":
        return cmyk_to_rgb(out)
    return _tiff_rgb([out], mode, rawmode, (8,), None, False, name)


# ---------------------------------------------------------------------------
# TIFF codecs: LZW, PackBits
# ---------------------------------------------------------------------------


def _tiff_lzw(data: bytes, need: int, name: str) -> bytes:
    """TIFF's LZW (MSB-first codes, 9-12 bits, one bit wider as soon as
    the next free code reaches 2**bits - 1, clear 256, end 257), as
    libtiff's ``LZWDecode``; the first ``need`` bytes (fewer where the end
    code comes first)."""
    if len(data) >= 2 and data[0] == 0 and data[1] & 1:
        raise NotImplementedError(f"{name}: old-style (LSB-first) TIFF LZW is not supported")
    roots = [bytes([i]) for i in range(256)] + [b"", b""]
    table = list(roots)
    size, limit = 9, 511
    out = []
    produced = 0
    prev = None
    acc = nbits = pos = 0
    length = len(data)
    while produced < need:
        while nbits < size:
            if pos >= length:
                return b"".join(out)
            acc = (acc << 8) | data[pos]
            pos += 1
            nbits += 8
        nbits -= size
        code = (acc >> nbits) & ((1 << size) - 1)
        acc &= (1 << nbits) - 1
        if code == 256:
            del table[258:]
            size, limit = 9, 511
            prev = None
            continue
        if code == 257:
            break
        if prev is None:
            if code > 255:
                raise ValueError(f"{name}: corrupt TIFF LZW data: code {code} after a clear")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError(f"{name}: corrupt TIFF LZW data: code {code} past the table")
            if len(table) < 4096:
                table.append(prev + entry[:1])
                if len(table) >= limit and size < 12:
                    size += 1
                    limit = (1 << size) - 1
        out.append(entry)
        produced += len(entry)
        prev = entry
    return b"".join(out)


def _packbits(data: bytes, need: int) -> bytes:
    """PackBits: a header n < 128 copies n + 1 bytes, n > 128 repeats the
    next byte 257 - n times, 128 is nothing."""
    out = bytearray()
    pos, length = 0, len(data)
    while pos < length and len(out) < need:
        n = data[pos]
        pos += 1
        if n < 128:
            out += data[pos : pos + n + 1]
            pos += n + 1
        elif n > 128:
            if pos >= length:
                break
            out += data[pos : pos + 1] * (257 - n)
            pos += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# CCITT T.4 / T.6 (fax) decoding
# ---------------------------------------------------------------------------

# T.4's run-length codes: terminating codes of runs 0-63, make-up codes
# of 64-1728, and the extended make-up codes of 1792-2560 that both
# colours share.
_WHITE_TERMINATING = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100")
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011")
_BLACK_TERMINATING = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111")
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101")
_EXTENDED_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
    "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
    "000000011111")
_EOL = "000000000001"
# T.4's two-dimensional mode codes: pass, horizontal, vertical with
# a1 - b1 of -3..3, and the extension code (uncompressed mode).
_MODES = {"0001": "P", "001": "H", "1": 0, "011": 1, "000011": 2, "0000011": 3, "010": -1,
          "000010": -2, "0000010": -3, "0000001": "X"}
# Table entries: run << 6 | kind << 4 | code length; kinds below.
_TERMINATING, _MAKEUP, _END_OF_LINE = 1, 2, 3


def _code_table(width, codes):
    """A lookup table of the next ``width`` bits: entry = run << 6 | kind
    << 4 | code length, 0 where no code matches."""
    table = np.zeros(1 << width, np.int64)
    for code, entry in codes:
        shift = width - len(code)
        start = int(code, 2) << shift
        if table[start : start + (1 << shift)].any():
            raise AssertionError(f"fax code {code} overlaps another")
        table[start : start + (1 << shift)] = entry | len(code)
    return table.tolist()


def _run_codes(terminating, makeup):
    codes = [(code, run << 6 | _TERMINATING << 4) for run, code in enumerate(terminating.split())]
    runs = [64 * (i + 1) for i in range(27)] + [1792, 1856, 1920] + [1984 + 64 * i
                                                                     for i in range(10)]
    codes += [(code, run << 6 | _MAKEUP << 4)
              for run, code in zip(runs, makeup.split() + _EXTENDED_MAKEUP.split())]
    return codes + [(_EOL, _END_OF_LINE << 4)]


_FAX_TABLES = {}


def _fax_tables():
    """White (12-bit), black (13-bit) and mode (7-bit) lookup tables,
    built on first use."""
    if not _FAX_TABLES:
        _FAX_TABLES["white"] = _code_table(12, _run_codes(_WHITE_TERMINATING, _WHITE_MAKEUP))
        _FAX_TABLES["black"] = _code_table(13, _run_codes(_BLACK_TERMINATING, _BLACK_MAKEUP))
        modes = {"P": 8, "H": 9, "X": 10}
        _FAX_TABLES["mode"] = _code_table(
            7, [(code, (modes[m] if isinstance(m, str) else m + 3) << 4)
                for code, m in _MODES.items()])
    return _FAX_TABLES["white"], _FAX_TABLES["black"], _FAX_TABLES["mode"]


def _fax_decode(data: bytes, width: int, rows: int, compression: int, t4options: int,
                name: str) -> bytes:
    """``rows`` rows of ``width`` pixels of CCITT data, as libtiff's fax
    decoders read them, packed 1 bit per pixel, MSB first, rows padded to
    bytes; 1 is the second colour of each row's runs (black in T.4's
    terms). Compression 2 is modified Huffman without EOLs, each row
    starting on a byte; 3 (Group 3) finds an EOL before each row
    (T4Options bit 0: a tag bit after it picks 1-D or 2-D coding); 4
    (Group 4) codes every row in 2-D against the row above (white above
    the first)."""
    if compression == 3 and t4options & 2:
        raise NotImplementedError(f"{name}: Group 3 TIFF with uncompressed mode "
                                  "(T4Options bit 1) is not supported")
    white, black, modes = _fax_tables()
    win = windows(data)
    end = 8 * len(data)
    two_d = compression == 4 or (compression == 3 and t4options & 1)
    reference = [width] * 4
    changes = []
    counts = []
    pos = 0

    def run(colour, pos):
        """A run of ``colour``: make-up codes, then a terminating one."""
        table, shift, mask = (black, 27, 0x1FFF) if colour else (white, 28, 0xFFF)
        total = 0
        while True:
            if pos >= end:
                raise ValueError(f"{name}: truncated TIFF CCITT data")
            entry = table[(win[pos >> 3] >> (shift - (pos & 7))) & mask]
            kind = entry >> 4 & 3
            if kind == _TERMINATING:
                return total + (entry >> 6), pos + (entry & 15)
            if kind != _MAKEUP:
                raise ValueError(f"{name}: corrupt TIFF CCITT data: a bad "
                                 f"{'black' if colour else 'white'} run code at bit {pos}")
            total += entry >> 6
            pos += entry & 15

    for _ in range(rows):
        coded_2d = compression == 4
        if compression == 3:
            # libtiff's SYNC_EOL: 11 zero bits, any more zeros, then the 1.
            while True:
                if pos + 11 > end:
                    raise ValueError(f"{name}: truncated TIFF Group 3 data: no EOL")
                if (win[pos >> 3] >> (29 - (pos & 7))) & 0x7FF == 0:
                    break
                pos += 1
            pos += 11
            while pos < end and not (win[pos >> 3] >> (39 - (pos & 7))) & 1:
                pos += 1
            pos += 1
            if two_d:
                coded_2d = not (win[pos >> 3] >> (39 - (pos & 7))) & 1
                pos += 1
        row = []
        if not coded_2d:
            a0, colour = 0, 0
            while a0 < width:
                length, pos = run(colour, pos)
                a0 += length
                if row and row[-1] == a0:
                    row.pop()
                else:
                    row.append(a0)
                colour ^= 1
        else:
            a0, colour, i = -1, 0, 0
            while a0 < width:
                if pos >= end:
                    raise ValueError(f"{name}: truncated TIFF CCITT data")
                entry = modes[(win[pos >> 3] >> (33 - (pos & 7))) & 0x7F]
                if not entry:
                    raise ValueError(f"{name}: corrupt TIFF CCITT data: a bad mode code "
                                     f"(or an early EOL) at bit {pos}")
                pos += entry & 15
                m = (entry >> 4) - 3
                # b1: the first change on the row above right of a0 to the
                # colour opposite a0's (even entries turn to black).
                i = i - 2 if i >= 2 else 0
                while reference[i] <= a0 or (i & 1) != colour:
                    i += 1
                if m == 6:  # horizontal: two runs from a0
                    start = a0 if a0 > 0 else 0
                    first, pos = run(colour, pos)
                    second, pos = run(colour ^ 1, pos)
                    a1 = start + first
                    if row and row[-1] == a1:
                        row.pop()
                    else:
                        row.append(a1)
                    a0 = a1 + second
                    if a0 == a1:
                        row.pop()
                    else:
                        row.append(a0)
                elif m == 5:  # pass: a0 to b2, no change
                    a0 = reference[i + 1]
                elif m == 7:
                    raise NotImplementedError(f"{name}: CCITT uncompressed mode (an extension "
                                              "code) is not supported")
                else:  # vertical: a1 = b1 + m
                    a1 = reference[i] + m
                    if a1 < a0 or a1 > width:
                        raise ValueError(f"{name}: corrupt TIFF CCITT data: a vertical code "
                                         f"to column {a1}")
                    row.append(a1)
                    a0 = a1
                    colour ^= 1
        if a0 > width or (row and row[-1] > width):
            raise ValueError(f"{name}: corrupt TIFF CCITT data: a row of {a0} pixels for "
                             f"{width}")
        changes.extend(row)
        counts.append(len(row))
        reference = row + [width] * 4
        if compression == 2:
            pos = (pos + 7) & ~7
    return _fax_rows(changes, counts, width, rows)


def _fax_rows(changes, counts, width, rows) -> bytes:
    """Rows of pixels from each row's change positions (the colour flips
    at each), packed to bits."""
    stride = width + 1
    flat = np.asarray(changes, np.int64) + np.repeat(
        np.arange(rows, dtype=np.int64) * stride, counts)
    flips = np.bincount(flat, minlength=rows * stride).astype(np.uint8).reshape(rows, stride)
    pixels = np.cumsum(flips, axis=1, dtype=np.uint8)[:, :width] & 1
    return np.packbits(pixels, axis=1).tobytes()


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------

# PIL's ``BmpImagePlugin``: the raw mode of each depth, and of each
# bit-field mask layout it reads (red, green, blue[, alpha]).
_BMP_RAWMODES = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}
_BMP_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_BMP_COMPRESSIONS = {0: "BI_RGB", 1: "BI_RLE8", 2: "BI_RLE4", 3: "BI_BITFIELDS", 4: "BI_JPEG",
                     5: "BI_PNG", 6: "BI_ALPHABITFIELDS", 11: "BI_CMYK", 12: "BI_CMYKRLE8",
                     13: "BI_CMYKRLE4"}
_RAWMODE_BITS = {"1": 1, "P;1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16, "BGR;16": 16,
                 "BGR": 24}


def decode_bmp(blob: bytes, name: str = "image") -> np.ndarray:
    """A BMP file as (H, W, 3) uint8, as PIL's
    ``Image.open(...).convert("RGB")`` gives it (see the module's
    docstring). Raises NotImplementedError naming a header, depth,
    compression or bit-field layout that PIL does not read either,
    ValueError on a truncated or corrupt file."""
    if blob[:2] != b"BM" or len(blob) < 18:
        raise ValueError(f"{name} is not a BMP file")
    (offset,) = struct.unpack_from("<I", blob, 10)
    layout = _dib_layout(blob, 14, offset, name)
    return _dib_rgb(blob, layout, layout["height"], name)


# ``BmpImagePlugin._dib_accept``: the header sizes PIL takes for a DIB.
DIB_HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)


def is_dib(blob: bytes) -> bool:
    """PIL's ``_dib_accept``: the first little-endian word is a bitmap
    header's size."""
    return len(blob) >= 4 and struct.unpack_from("<I", blob)[0] in DIB_HEADER_SIZES


def decode_dib(blob: bytes, name: str = "image") -> np.ndarray:
    """A DIB (a BMP without its 14-byte file header: the bitmap header,
    masks and palette, then the pixels) as (H, W, 3) uint8, as PIL's
    ``DibImageFile`` and ``convert("RGB")`` give it. Raises as
    :func:`decode_bmp` does."""
    if not is_dib(blob):
        raise ValueError(f"{name} is not a DIB file")
    layout = _dib_layout(blob, 0, 0, name)
    return _dib_rgb(blob, layout, layout["height"], name)


def _dib_layout(blob: bytes, at: int, offset: int, name: str) -> dict:
    """The bitmap header at ``at`` as ``BmpImagePlugin._bitmap`` reads it:
    size, depth, PIL's mode and raw mode, palette, row order and where the
    pixel data starts (``offset``, a BMP file header's, or 0 for the data
    after the header and palette, as in an icon)."""
    (header_size,) = struct.unpack_from("<I", blob, at) if len(blob) >= at + 4 else (0,)
    header = blob[at + 4 : at + header_size]
    if header_size < 12 or len(header) != header_size - 4:
        raise ValueError(f"{name}: truncated BMP header")
    pos = at + header_size
    direction = -1
    masks = None
    if header_size == 12:
        width, height, _, bits = struct.unpack_from("<HHHH", header)
        compression, colors, padding = 0, 0, 3
    elif header_size in (40, 52, 56, 64, 108, 124):
        flip = header[7] == 0xFF
        direction = 1 if flip else -1
        width, height, _, bits, compression = struct.unpack_from("<IIHHI", header)
        if flip:
            height = 2**32 - height
        (colors,) = struct.unpack_from("<I", header, 28)
        padding = 4
        if compression == 3:
            if len(header) >= 48:
                count = 4 if len(header) >= 52 else 3
                masks = struct.unpack_from("<" + "I" * count, header, 36) + (0,) * (4 - count)
            else:
                # A 40-byte header's three masks follow it.
                if pos + 12 > len(blob):
                    raise ValueError(f"{name}: truncated BMP bit-field masks")
                masks = struct.unpack_from("<III", blob, pos) + (0,)
                pos += 12
    else:
        raise NotImplementedError(f"{name}: BMP header of {header_size} bytes is not supported")
    colors = colors or 1 << bits
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in _BMP_RAWMODES:
        raise NotImplementedError(f"{name}: {bits}-bit BMP is not supported")
    mode, rawmode = ("P" if bits <= 8 else "RGB"), _BMP_RAWMODES[bits]
    if compression == 3:
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _BMP_MASKS:
            raise NotImplementedError(f"{name}: BMP bit-field layout {bits} bits "
                                      f"{[hex(m) for m in masks]} is not supported")
        rawmode = _BMP_MASKS[key]
    elif compression in (1, 2):
        if (compression, bits) not in ((1, 8), (2, 4)):
            raise NotImplementedError(f"{name}: {_BMP_COMPRESSIONS[compression]} BMP of "
                                      f"{bits} bits is not supported")
    elif compression != 0:
        what = _BMP_COMPRESSIONS.get(compression, f"compression {compression}")
        raise NotImplementedError(f"{name}: {what} BMP is not supported")
    palette = None
    if mode == "P":
        if not 0 < colors <= 256:
            raise NotImplementedError(f"{name}: BMP palette of {colors} colours is not supported")
        raw = blob[pos : pos + padding * colors]
        pos += padding * colors
        entries = np.frombuffer(raw[: len(raw) // padding * padding], np.uint8)
        entries = entries.reshape(-1, padding)[:, :3]
        ramp = [0, 255] if colors == 2 else list(range(colors))
        if len(entries) == colors and np.array_equal(entries, np.repeat(
                np.asarray(ramp, np.uint8)[:, None], 3, axis=1)):
            # PIL opens a grey palette as an L (or 1) image of the raw data.
            mode = rawmode = "1" if colors == 2 else "L"
        else:
            palette = np.zeros((256, 3), np.uint8)
            palette[: len(entries)] = entries[:, ::-1]
    return {"width": width, "height": height, "bits": bits, "compression": compression,
            "mode": mode, "rawmode": rawmode, "palette": palette, "direction": direction,
            "start": offset or pos, "stride": ((width * bits + 31) >> 3) & ~3}


def _dib_rgb(blob: bytes, layout: dict, height: int, name: str) -> np.ndarray:
    """The first ``height`` rows of a bitmap's pixel data (an icon's image
    holds half the rows its header states) as RGB."""
    width, rawmode, mode = layout["width"], layout["rawmode"], layout["mode"]
    start = layout["start"]
    if layout["compression"] in (1, 2):
        if mode == "1":
            raise NotImplementedError(f"{name}: run-length BMP with a black and white palette "
                                      "is not supported (PIL does not read it)")
        values = _bmp_rle(blob, start, width, height, layout["compression"] == 2, name)
    else:
        bits_out = _RAWMODE_BITS.get(rawmode, 32)
        need = -(-width * bits_out // 8)
        stride = layout["stride"]
        if need > stride:
            raise NotImplementedError(f"{name}: BMP rows of {stride} bytes for raw mode "
                                      f"{rawmode} (PIL does not read it)")
        data = blob[start : start + stride * height]
        if len(data) != stride * height:
            raise ValueError(f"{name}: truncated BMP in the image data")
        rows = np.frombuffer(data, np.uint8).reshape(height, stride)[:, :need]
        values = _bmp_unpack(rows, rawmode, width)
    if layout["direction"] == -1:
        values = values[::-1]
    if mode == "1":
        return _grey(values * 255)
    if mode == "L":
        return _grey(values)
    if mode == "P":
        return layout["palette"][values]
    return np.ascontiguousarray(values)


def _bmp_unpack(rows: np.ndarray, rawmode: str, width: int) -> np.ndarray:
    """Rows of raw bytes unpacked as PIL's raw mode: palette indices or
    grey (H, W), else RGB (H, W, 3)."""
    if rawmode in ("1", "P;1", "P;4"):
        return _unpack_bits(rows, 4 if rawmode == "P;4" else 1, width)
    if rawmode in ("P", "L"):
        return rows[:, :width]
    if rawmode in ("BGR;15", "BGR;16"):
        pixel = rows.view("<u2")[:, :width].astype(np.int32)
        green_bits = 6 if rawmode == "BGR;16" else 5
        red = (pixel >> (5 + green_bits)) & 31
        green = (pixel >> 5) & ((1 << green_bits) - 1)
        blue = pixel & 31
        return np.stack([red * 255 // 31, green * 255 // ((1 << green_bits) - 1),
                         blue * 255 // 31], -1).astype(np.uint8)
    channels = len(rawmode)
    pixels = rows[:, : width * channels].reshape(len(rows), width, channels)
    return np.ascontiguousarray(pixels[..., [rawmode.index(c) for c in "RGB"]])


def _bmp_rle(blob, pos, width, height, rle4, name) -> np.ndarray:
    """``BI_RLE8`` / ``BI_RLE4`` data, decoded as PIL's ``BmpRleDecoder``:
    (H, W) indices in stored row order."""
    total = width * height
    data = bytearray()
    x = 0
    length = len(blob)
    while len(data) < total:
        if pos + 2 > length:
            break
        count, byte = blob[pos], blob[pos + 1]
        pos += 2
        if count:
            if x + count > width:
                count = max(0, width - x)
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                data += (pair * ((count + 1) // 2))[:count]
            else:
                data += bytes([byte]) * count
            x += count
        elif byte == 0:
            data += bytes(-len(data) % width)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            # PIL reads two bytes, then the offsets from the two after them.
            if pos + 4 > length:
                if pos + 2 > length:
                    break
                raise ValueError(f"{name}: truncated BMP in a delta escape")
            right, up = blob[pos + 2], blob[pos + 3]
            pos += 4
            data += bytes(right + up * width)
            x = len(data) % width
        else:
            if rle4:
                take = byte // 2
                chunk = blob[pos : pos + take]
                pos += len(chunk)
                data += bytes(v for b in chunk for v in (b >> 4, b & 15))
            else:
                take = byte
                chunk = blob[pos : pos + take]
                pos += len(chunk)
                data += chunk
            if len(chunk) < take:
                break
            x += byte
            if pos % 2:
                pos += 1
    if len(data) < total:
        raise ValueError(f"{name}: truncated BMP: run-length data for {len(data)} of "
                         f"{total} pixels")
    return np.frombuffer(bytes(data[:total]), np.uint8).reshape(height, width)


# ---------------------------------------------------------------------------
# PNM (PBM, PGM, PPM)
# ---------------------------------------------------------------------------

_PNM_WHITESPACE = b" \t\n\x0b\x0c\r"


def _pnm_token(blob: bytes, pos: int, name: str) -> typing.Tuple[bytes, int]:
    """PIL's ``PpmImageFile._read_token``: skip whitespace, read up to the
    next whitespace byte (consumed); a ``#`` drops the rest of its line
    without ending the token."""
    token = b""
    length = len(blob)
    while len(token) <= 10:
        if pos >= length:
            break
        c = blob[pos : pos + 1]
        pos += 1
        if c in _PNM_WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while pos < length and blob[pos : pos + 1] not in (b"\r", b"\n"):
                pos += 1
            pos += 1
            continue
        token += c
    if not token:
        raise ValueError(f"{name}: truncated PNM header")
    if len(token) > 10:
        raise ValueError(f"{name}: corrupt PNM header: a token of more than 10 bytes")
    return token, pos


def _pnm_comments(data: bytes) -> bytes:
    """PIL's plain-PNM comment removal: from each ``#`` through the next
    CR or LF, the end included."""
    parts = []
    while True:
        start = data.find(b"#")
        if start < 0:
            parts.append(data)
            return b"".join(parts)
        parts.append(data[:start])
        ends = [e for e in (data.find(b"\n", start), data.find(b"\r", start)) if e >= 0]
        if not ends:
            return b"".join(parts)
        data = data[min(ends) + 1 :]


def decode_pnm(blob: bytes, name: str = "image") -> np.ndarray:
    """The first image of a PBM, PGM or PPM file (P1-P6) as (H, W, 3)
    uint8, as PIL's ``Image.open(...).convert("RGB")`` gives it: samples
    scaled by ``round(v / maxval * 255)`` (Python's rounding, clipped),
    grey of maxval above 255 by ``round(v / maxval * 65535)`` into PIL's
    mode ``I``, which ``convert("RGB")`` clips at 255 (a raw 16-bit grey
    of maxval 65535 is read as it is, then clipped). Raises
    NotImplementedError for the PNM kinds PIL reads beyond these (PF, P0
    CMYK, PIL's Py* test formats), ValueError on a truncated or corrupt
    file."""
    magic = b""
    pos = 0
    for _ in range(6):
        c = blob[pos : pos + 1]
        pos += 1
        if not c or c in _PNM_WHITESPACE:
            break
        magic += c
    if magic in (b"Pf", b"P0CMYK", b"PyP", b"PyRGBA", b"PyCMYK"):
        raise NotImplementedError(f"{name}: the PNM kind {magic.decode()} is not supported")
    if magic not in PNM_SIGNATURES:
        raise ValueError(f"{name} is not a PNM file")
    kind = magic[1] - ord("0")
    width, pos = _pnm_token(blob, pos, name)
    height, pos = _pnm_token(blob, pos, name)
    try:
        width, height = int(width), int(height)
    except ValueError:
        raise ValueError(f"{name}: corrupt PNM header: a size of {width} x {height}") from None
    bands = 3 if kind in (3, 6) else 1
    if kind in (1, 4):
        if kind == 1:
            tokens = b"".join(_pnm_comments(blob[pos:]).split())
            if tokens.strip(b"01"):
                bad = bytes(c for c in tokens if c not in b"01")[:1]
                raise ValueError(f"{name}: corrupt PBM: the token {bad!r}")
            bits = np.frombuffer(tokens[: width * height], np.uint8) - ord("0")
            if bits.size != width * height:
                raise ValueError(f"{name}: truncated PBM data")
            return _grey((1 - bits.reshape(height, width)) * 255)
        stride = -(-width // 8)
        data = blob[pos : pos + stride * height]
        if len(data) != stride * height:
            raise ValueError(f"{name}: truncated PBM data")
        rows = np.frombuffer(data, np.uint8).reshape(height, stride)
        bits = np.unpackbits(rows, axis=1)[:, :width]
        return _grey((1 - bits) * 255)
    token, pos = _pnm_token(blob, pos, name)
    try:
        maxval = int(token)
    except ValueError:
        raise ValueError(f"{name}: corrupt PNM header: maxval {token!r}") from None
    if not 0 < maxval < 65536:
        raise ValueError(f"{name}: corrupt PNM header: maxval {maxval}")
    wide = maxval > 255 and bands == 1
    out_max = 65535 if wide else 255
    count = width * height * bands
    if kind in (2, 3):
        tokens = _pnm_comments(blob[pos:]).split()[:count]
        if len(tokens) < count:
            raise ValueError(f"{name}: truncated plain PNM data")
        if any(len(t) > 10 for t in tokens):
            raise ValueError(f"{name}: corrupt plain PNM data: a token of more than 10 bytes")
        try:
            values = np.array([int(t) for t in tokens], np.int64)
        except ValueError:
            raise ValueError(f"{name}: corrupt plain PNM data") from None
        if values.min() < 0 or values.max() > maxval:
            raise ValueError(f"{name}: corrupt plain PNM data: a sample outside 0-{maxval}")
        values = np.round(values / maxval * out_max)
    else:
        size = 1 if maxval < 256 else 2
        data = blob[pos : pos + count * size]
        if len(data) != count * size:
            raise ValueError(f"{name}: truncated PNM data")
        values = np.frombuffer(data, np.uint8 if size == 1 else ">u2").astype(np.int64)
        if maxval != 255 and not (wide and maxval == 65535):
            values = np.minimum(np.round(values / maxval * out_max), out_max)
    values = values.astype(np.int64).reshape(height, width, bands)
    if bands == 1:
        return _grey(np.minimum(values[..., 0], 255))
    return values.astype(np.uint8)


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------

# PIL's ``TgaImagePlugin.MODES``: raw mode by (image type & 7, depth).
_TGA_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
                 (2, 24): "BGR", (2, 32): "BGRA"}
_TGA_BITS = {"P": 8, "1": 1, "L": 8, "LA": 16, "BGRA;15Z": 16, "BGR": 24, "BGRA": 32}


def is_tga(blob: bytes) -> bool:
    """Whether PIL's ``TgaImageFile._open`` takes the header: TGA has no
    magic bytes, so PIL tries it after the formats that have them."""
    if len(blob) < 18:
        return False
    cmap, kind, width, height, depth = blob[1], blob[2], *struct.unpack_from("<HH", blob, 12), \
        blob[16]
    return (cmap in (0, 1) and width > 0 and height > 0 and depth in (1, 8, 16, 24, 32)
            and kind in (1, 2, 3, 9, 10, 11) and (not cmap or blob[7] in (16, 24, 32)))


def _rgb555(words: np.ndarray) -> np.ndarray:
    """Little-endian ``xRRRRRGGGGGBBBBB`` words as RGB, each 5-bit field
    scaled by 255 // 31 as PIL's ``BGRA;15Z`` unpacker does."""
    words = words.astype(np.int64)
    return (np.stack([(words >> 10) & 31, (words >> 5) & 31, words & 31], -1) * 255 // 31
            ).astype(np.uint8)


def decode_tga(blob: bytes, name: str = "image") -> np.ndarray:
    """A TGA file as (H, W, 3) uint8, as PIL's ``convert("RGB")`` of its
    ``TgaImagePlugin`` gives it: image types 1, 2, 3 (raw) and 9, 10, 11
    (run-length); colour-mapped 8-bit with 16- or 24-bit map entries from
    any first index (entries before it and past the map are black),
    1-bit, 8-bit and 16-bit (grey and alpha) grey, 16-bit (5 bits a
    channel), 24- and 32-bit colour; rows bottom first unless the
    descriptor's top bit is set, and mirrored with its right-to-left bit;
    run-length literal packets that go on past a row's end. Raises
    NotImplementedError naming what PIL does not read either (a run packet
    past a row's end, a 1-bit run-length image, 32-bit map entries, a map
    beside true colour, a depth the image type has no raw mode for),
    ValueError on a truncated file."""
    if not is_tga(blob):
        raise ValueError(f"{name} is not a TGA file")
    id_len, cmap, kind = blob[0], blob[1], blob[2]
    map_start, map_len, map_depth = struct.unpack_from("<HHB", blob, 3)
    width, height = struct.unpack_from("<HH", blob, 12)
    depth, flags = blob[16], blob[17]
    rawmode = _TGA_RAWMODES.get((kind & 7, depth))
    if rawmode is None:
        raise NotImplementedError(f"{name}: {depth}-bit TGA of image type {kind} (PIL has no "
                                  "raw mode for it)")
    if kind & 7 == 1 and not cmap:
        raise NotImplementedError(f"{name}: colour-mapped TGA without a colour map (PIL does "
                                  "not read it)")
    if cmap and (kind & 7 == 2 or depth == 1):
        raise NotImplementedError(f"{name}: {depth}-bit TGA of image type {kind} with a colour "
                                  "map (PIL does not read it)")
    pos = 18 + id_len
    palette = None
    if cmap:
        if map_depth == 32:
            raise NotImplementedError(f"{name}: TGA colour map of 32-bit entries (PIL does not "
                                      "read it)")
        size = map_depth // 8
        raw = blob[pos : pos + size * map_len]
        pos += size * map_len
        if map_start + len(raw) // size > 256:
            raise NotImplementedError(f"{name}: TGA colour map past entry 256")
        palette = np.zeros((256, 3), np.uint8)
        count = len(raw) // size
        if map_depth == 16:
            entries = _rgb555(np.frombuffer(raw[: 2 * count], "<u2"))
        else:
            entries = np.frombuffer(raw[: 3 * count], np.uint8).reshape(-1, 3)[:, ::-1]
        palette[map_start : map_start + count] = entries
    bits = _TGA_BITS[rawmode]
    stride = (width * bits + 7) // 8
    if kind & 8:
        if depth == 1:
            raise NotImplementedError(f"{name}: 1-bit run-length TGA (PIL does not read it)")
        rows = _tga_rle(blob, pos, stride, height, depth // 8, name)
    else:
        rows = blob[pos : pos + stride * height]
        if len(rows) != stride * height:
            raise ValueError(f"{name}: truncated TGA in the image data")
    rows = np.frombuffer(rows, np.uint8).reshape(height, stride)
    if not flags & 0x20:
        rows = rows[::-1]
    if rawmode == "1":
        rgb = _grey(_unpack_bits(rows, 1, width) * 255)
    elif rawmode in ("L", "LA"):
        grey = rows[:, :: 2 if rawmode == "LA" else 1]
        # A colour map makes PIL's image a palette image of the grey values.
        rgb = _grey(grey) if palette is None else palette[grey]
    elif rawmode == "P":
        rgb = palette[rows]
    elif rawmode == "BGRA;15Z":
        rgb = _rgb555(rows.view("<u2"))
    else:
        rgb = rows.reshape(height, width, -1)[..., 2::-1]
    if flags & 0x10:
        rgb = rgb[:, ::-1]
    return np.ascontiguousarray(rgb)


def _tga_rle(blob, pos, stride, height, size, name) -> bytes:
    """Run-length data as PIL's ``TgaRleDecode`` reads it: a packet's high
    bit makes it a run of one ``size``-byte pixel, else a literal of
    pixels; a literal may go on into the next rows, a run past a row's
    end is a decoder error."""
    total = stride * height
    out = bytearray()
    length = len(blob)
    while len(out) < total:
        if pos >= length:
            raise ValueError(f"{name}: truncated TGA: run-length data for {len(out)} of "
                             f"{total} bytes")
        head = blob[pos]
        count = size * ((head & 0x7F) + 1)
        if head & 0x80:
            if pos + 1 + size > length:
                raise ValueError(f"{name}: truncated TGA in a run-length packet")
            if len(out) % stride + count > stride:
                raise NotImplementedError(f"{name}: TGA run-length packet past a row's end "
                                          "(PIL's decoder does not read it)")
            out += blob[pos + 1 : pos + 1 + size] * (count // size)
            pos += 1 + size
        else:
            if pos + 1 + count > length:
                raise ValueError(f"{name}: truncated TGA in a run-length packet")
            out += blob[pos + 1 : pos + 1 + count]
            pos += 1 + count
    return bytes(out[:total])


# ---------------------------------------------------------------------------
# PCX
# ---------------------------------------------------------------------------


def is_pcx(blob: bytes) -> bool:
    """PIL's ``PcxImagePlugin._accept``."""
    return len(blob) >= 2 and blob[0] == 10 and blob[1] in (0, 2, 3, 5)


def decode_pcx(blob: bytes, name: str = "image") -> np.ndarray:
    """A PCX file as (H, W, 3) uint8, as PIL's ``PcxImagePlugin`` and its
    ``convert("RGB")`` give it: 1-bit; 1-bit over 2 or 4 planes with the
    header's 16-colour palette; version 5 8-bit, grey or with the
    trailing 256-colour palette (``0x0C``, a grey ramp reads as grey); 8-bit
    RGB over 3 planes. Rows are run-length coded (``0xC0 | n`` runs) in
    PIL's stride: the header's bytes per line only says whether the
    computed one is padded to an even count. Raises NotImplementedError
    naming what PIL does not read either (other depths and plane counts,
    a run past a row's end), ValueError on a truncated file."""
    if not is_pcx(blob) or len(blob) < 68:
        raise ValueError(f"{name} is not a PCX file")
    xmin, ymin, xmax, ymax = struct.unpack_from("<HHHH", blob, 4)
    if xmax + 1 <= xmin or ymax + 1 <= ymin:
        raise ValueError(f"{name}: bad PCX image size")
    version, bits, planes = blob[1], blob[3], blob[65]
    (provided,) = struct.unpack_from("<H", blob, 66)
    width, height = xmax + 1 - xmin, ymax + 1 - ymin
    palette = None
    if bits == 1 and planes == 1:
        rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        rawmode = f"P;{planes}L"
        palette = np.zeros((256, 3), np.uint8)
        palette[:16] = np.frombuffer(blob[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        rawmode = "L"
        tail = blob[-769:]
        if len(tail) == 769 and tail[0] == 12:
            entries = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
            if not np.array_equal(entries, np.repeat(np.arange(256, dtype=np.uint8)[:, None],
                                                     3, 1)):
                rawmode, palette = "P", entries
    elif version == 5 and bits == 8 and planes == 3:
        rawmode = "RGB;L"
    else:
        raise NotImplementedError(f"{name}: {bits}-bit PCX over {planes} planes (version "
                                  f"{version}) is not supported (PIL does not read it)")
    stride = (width * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    rows = _pcx_rows(blob, 128, planes * stride, height, name)
    if rawmode == "1":
        return _grey(_unpack_bits(rows, 1, width) * 255)
    if rawmode == "L":
        return _grey(rows[:, :width])
    if rawmode == "P":
        return palette[rows[:, :width]]
    if rawmode == "RGB;L":
        # PIL moves padded planes together, ``width`` bytes apart, only
        # where the row's size is not a multiple of the width.
        size, starts = 3 * stride, [0, width, 2 * width]
        if size % width and size > width:
            band = size // (size // width)
            starts = [0, band, 2 * band]
        return np.ascontiguousarray(np.stack([rows[:, at : at + width] for at in starts], -1))
    index = np.zeros((height, width), np.int64)  # P;2L / P;4L: bit planes a stride apart
    for k in range(planes):
        index |= _unpack_bits(rows[:, k * stride : (k + 1) * stride], 1, width).astype(
            np.int64) << k
    return palette[index]


DCX_MAGIC = 987654321


def is_dcx(blob: bytes) -> bool:
    """PIL's ``DcxImagePlugin._accept``."""
    return len(blob) >= 4 and struct.unpack_from("<I", blob)[0] == DCX_MAGIC


def decode_dcx(blob: bytes, name: str = "image") -> np.ndarray:
    """A DCX file's first page as (H, W, 3) uint8, as PIL's
    ``DcxImagePlugin`` gives it: the page directory (up to 1024 offsets,
    ended by 0), then :func:`decode_pcx` from the first page's offset to
    the end of the file (PIL looks for an 8-bit page's palette at the end
    of the file). Raises ValueError on a file without pages or a
    directory cut short, else as :func:`decode_pcx` does."""
    if not is_dcx(blob):
        raise ValueError(f"{name} is not a DCX file")
    count = min(1024, (len(blob) - 4) // 4)
    offsets = struct.unpack_from(f"<{count}I", blob, 4)
    if 0 not in offsets and count < 1024:
        raise ValueError(f"{name}: truncated DCX page directory")
    if not offsets or offsets[0] == 0:
        raise ValueError(f"{name}: DCX file without pages")
    return decode_pcx(blob[offsets[0]:], name)


def _pcx_rows(blob, pos, size, height, name) -> np.ndarray:
    """PIL's ``PcxDecode``: rows of ``size`` bytes (every plane's line)
    from runs (``0xC0 | n`` then the byte) and literal bytes."""
    out = np.zeros((height, size), np.uint8)
    data = blob
    length = len(data)
    for y in range(height):
        row = bytearray()
        while len(row) < size:
            if pos >= length:
                raise ValueError(f"{name}: truncated PCX: {y} of {height} rows")
            byte = data[pos]
            if byte & 0xC0 == 0xC0:
                if pos + 1 >= length:
                    raise ValueError(f"{name}: truncated PCX in a run")
                count = byte & 0x3F
                if len(row) + count > size:
                    raise NotImplementedError(f"{name}: PCX run past a row's end (PIL's decoder "
                                              "does not read it)")
                row += data[pos + 1 : pos + 2] * count
                pos += 2
            else:
                row.append(byte)
                pos += 1
        out[y] = np.frombuffer(bytes(row), np.uint8)
    return out


# ---------------------------------------------------------------------------
# ICO and CUR
# ---------------------------------------------------------------------------

ICO_SIGNATURE, CUR_SIGNATURE = b"\0\0\1\0", b"\0\0\2\0"


def is_ico(blob: bytes) -> bool:
    """Whether PIL's ICO or CUR plugin takes the file: the magic bytes and
    a whole directory of at least one entry (else PIL goes on to the next
    plugin: a TGA of image type 1 or 2 with no ID and no colour map starts
    with the same bytes)."""
    if blob[:4] not in (ICO_SIGNATURE, CUR_SIGNATURE) or len(blob) < 6:
        return False
    (count,) = struct.unpack_from("<H", blob, 4)
    return count > 0 and len(blob) >= 6 + 16 * count


def decode_ico(blob: bytes, name: str = "image") -> np.ndarray:
    """An ICO or CUR file's image as (H, W, 3) uint8, as PIL's
    ``IcoImagePlugin`` / ``CurImagePlugin`` and ``convert("RGB")`` give it.
    An icon shows its largest entry (PIL sorts the entries by colour depth,
    then by area, largest first, and shows the first of the largest area:
    of equal ones, the lowest colour depth); a cursor its first entry, or
    a later one wider and taller than the one so far. A PNG entry is
    decoded as PNG; a DIB entry by the BMP decoder at half its stated
    height (the AND mask's half). An icon's DIB must hold its AND mask (or
    32-bit alpha) where PIL reads it, though the mask only sets alpha,
    which ``convert("RGB")`` drops. Raises as :func:`decode_bmp` and
    :func:`.tools.decode_png` do."""
    from .tools import _PNG_SIGNATURE, decode_png

    if not is_ico(blob):
        raise ValueError(f"{name} is not an ICO or CUR file")
    cursor = blob[:4] == CUR_SIGNATURE
    (count,) = struct.unpack_from("<H", blob, 4)
    entries = [blob[6 + 16 * i : 22 + 16 * i] for i in range(count)]
    if cursor:
        chosen = entries[0]
        for entry in entries[1:]:
            if entry[0] > chosen[0] and entry[1] > chosen[1]:
                chosen = entry
        (at,) = struct.unpack_from("<I", chosen, 12)
        layout = _dib_layout(blob, at or 6 + 16 * count, 0, name)
        return _dib_rgb(blob, layout, layout["height"] // 2, name)
    icons = []
    for entry in entries:
        width, height, colours = entry[0] or 256, entry[1] or 256, entry[2]
        bpp, size, offset = struct.unpack_from("<HII", entry, 6)
        depth = bpp or (colours != 0 and math.ceil(math.log(colours, 2))) or 256
        icons.append((width * height, depth, bpp, size, offset))
    icons.sort(key=lambda icon: icon[1])
    icons.sort(key=lambda icon: icon[0], reverse=True)
    _, _, bpp, size, offset = icons[0]
    if blob[offset : offset + 8] == _PNG_SIGNATURE:
        return decode_png(blob[offset:], name)
    layout = _dib_layout(blob, offset, 0, name)
    width, height = layout["width"], int(layout["height"] / 2)
    rgb = _dib_rgb(blob, layout, height, name)
    if bpp == 32:
        need, where = width * height * 4, layout["start"]
    else:
        need = -(-width // 32) * 4 * height
        where = offset + size - need
    if where < 0 or where + need > len(blob):
        raise ValueError(f"{name}: truncated ICO: no room for the entry's "
                         f"{'alpha' if bpp == 32 else 'AND mask'}")
    return rgb
