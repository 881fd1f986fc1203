"""Write the TIFF, BMP, PNM and CMYK/YCCK JPEG fixtures that
``tests/test_torch_image_formats.py`` and ``chip_smoke.py`` read, with the
sha256 of PIL's decode of each.

    python scripts/make_image_fixtures.py [--out tests/fixtures/images]

PIL writes what its writers produce (TIFF with CCITT Group 3 1-D and
2-D, Group 4, modified Huffman, LZW, Deflate, PackBits and JPEG; CMYK
JPEG; BMP; PPM/PGM/PBM), the writers here the rest: :func:`write_tiff`
(either byte order, strips or tiles, planar data, ``Predictor`` 2, 1-16
bits, ``FillOrder`` 2, Deflate as compression 32946, strips compressed
elsewhere), :func:`write_bmp` (the OS/2 and v2-v5 headers, RLE4, RLE8,
bit fields, top-down rows, short palettes) and :func:`write_pnm` (P1-P6,
comments, any maxval); a YCCK JPEG is PIL's CMYK JPEG with its Adobe
transform set to 2. ``hashes.json`` beside the files holds, for each, the
shape and the sha256 of ``np.array(PIL.Image.open(f).convert("RGB"))``.
The script needs PIL; the files it writes do not.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as libtiff's ``LZWEncode`` writes it: a clear code first,
    9-12-bit codes MSB first, one bit wider once the next free code passes
    2**bits - 1, a clear code when the table reaches 4094, then the end
    code."""
    codes = []
    table = {bytes([i]): i for i in range(256)}
    free, width = 258, 9
    codes.append((256, width))
    word = b""
    for value in data:
        extended = word + bytes([value])
        if extended in table:
            word = extended
            continue
        codes.append((table[word], width))
        table[extended] = free
        free += 1
        if free == 4094:
            codes.append((256, width))
            table = {bytes([i]): i for i in range(256)}
            free, width = 258, 9
        elif free > (1 << width) - 1:
            width += 1
        word = bytes([value])
    if word:
        codes.append((table[word], width))
        free += 1
        if free == 4094:
            codes.append((256, width))
            width = 9
        elif free > (1 << width) - 1:
            width += 1
    codes.append((257, width))
    acc = nbits = 0
    out = bytearray()
    for code, size in codes:
        acc = (acc << size) | code
        nbits += size
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
        acc &= (1 << nbits) - 1
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3 or more equal bytes as repeats, the rest as
    literal runs of up to 128 bytes."""
    out = bytearray()
    pos, n = 0, len(data)
    literal = bytearray()

    def flush():
        for start in range(0, len(literal), 128):
            chunk = literal[start:start + 128]
            out.append(len(chunk) - 1)
            out.extend(chunk)
        literal.clear()

    while pos < n:
        run = 1
        while pos + run < n and run < 128 and data[pos + run] == data[pos]:
            run += 1
        if run >= 3:
            flush()
            out.append(257 - run)
            out.append(data[pos])
            pos += run
        else:
            literal.extend(data[pos:pos + run])
            pos += run
    flush()
    return bytes(out)


def _reverse_bits(data: bytes) -> bytes:
    table = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
    return data.translate(table)


def _pack_rows(values: np.ndarray, bits: int, order: str) -> np.ndarray:
    """(rows, samples per row) values -> (rows, bytes per row) uint8."""
    if bits == 16:
        return values.astype(order + "u2").view(np.uint8).reshape(len(values), -1)
    if bits == 8:
        return values.astype(np.uint8)
    shifts = np.arange(bits - 1, -1, -1)
    bitplanes = (values[..., None].astype(np.uint8) >> shifts) & 1
    return np.packbits(bitplanes.reshape(len(values), -1), axis=1)


def _compress(data: bytes, compression: int) -> bytes:
    if compression == 1:
        return data
    if compression == 5:
        return lzw_encode(data)
    if compression in (8, 32946):
        return zlib.compress(data, 9)
    if compression == 32773:
        return packbits_encode(data)
    raise ValueError(f"the writer does not compress with {compression}")


_TIFF_FORMATS = {1: "B", 2: "B", 3: "H", 4: "I", 7: "B"}


def write_tiff(samples=None, *, photometric, bits=8, order="<", compression=1, predictor=1,
               rows_per_strip=None, tile=None, planar=1, fill_order=1, extra_samples=(),
               colormap=None, strips=None, size=None, tags=None) -> bytes:
    """A one-image TIFF. ``samples`` is (H, W, samples per pixel) of
    unsigned values of ``bits`` bits, stored in strips of
    ``rows_per_strip`` rows or in ``tile`` = (height, width) tiles,
    contiguous (``planar`` 1) or one plane after another (2), differenced
    (``predictor`` 2), compressed (1 none, 5 LZW, 8 / 32946 Deflate, 32773
    PackBits) and, with ``fill_order`` 2, each byte's bits reversed.
    ``strips`` are already compressed strips instead (of an image of
    ``size`` = (H, W)), e.g. CCITT or JPEG data. ``tags``: more entries,
    tag -> (type, values) or tag -> bytes (UNDEFINED)."""
    if strips is None:
        samples = np.asarray(samples)
        if samples.ndim == 2:
            samples = samples[..., None]
        height, width, spp = samples.shape
    else:
        height, width = size
        spp = len(np.atleast_1d(bits))
    bits_list = [bits] * spp if np.isscalar(bits) else list(bits)
    if strips is None:
        planes = [samples[..., i:i + 1] for i in range(spp)] if planar == 2 else [samples]
        if tile:
            tile_h, tile_w = tile
        else:
            tile_h, tile_w = (rows_per_strip or height), width
        strips = []
        for plane in planes:
            for y in range(0, height, tile_h):
                for x in range(0, width, tile_w):
                    block = plane[y:y + tile_h, x:x + tile_w]
                    if tile:
                        padded = np.zeros((tile_h, tile_w, plane.shape[2]), block.dtype)
                        padded[:block.shape[0], :block.shape[1]] = block
                        block = padded
                    values = block.reshape(len(block), -1).astype(np.int64)
                    if predictor == 2:
                        per = block.shape[2]
                        diff = values.copy()
                        diff[:, per:] = values[:, per:] - values[:, :-per]
                        values = diff % (1 << bits_list[0])
                    data = _pack_rows(values, bits_list[0], order).tobytes()
                    strips.append(_compress(data, compression))
    if fill_order == 2:
        strips = [_reverse_bits(s) for s in strips]
    entries = {256: (4, [width]), 257: (4, [height]), 258: (3, bits_list),
               259: (3, [compression]), 262: (3, [photometric]), 277: (3, [spp]),
               284: (3, [planar])}
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra_samples:
        entries[338] = (3, list(extra_samples))
    if colormap is not None:
        entries[320] = (3, list(np.asarray(colormap).T.ravel()))
    if tile:
        entries[322], entries[323] = (3, [tile[1]]), (3, [tile[0]])
        offsets_tag, counts_tag = 324, 325
    else:
        entries[278] = (4, [rows_per_strip or height])
        offsets_tag, counts_tag = 273, 279
    for tag, value in (tags or {}).items():
        entries[tag] = (7, list(value)) if isinstance(value, bytes) else value
    entries[offsets_tag] = (4, [0] * len(strips))
    entries[counts_tag] = (4, [len(s) for s in strips])
    count = len(entries)
    data_start = 8 + 2 + 12 * count + 4
    blobs = bytearray()
    fields = {}
    for tag in sorted(entries):
        kind, values = entries[tag]
        raw = struct.pack(order + _TIFF_FORMATS[kind] * len(values), *values)
        fields[tag] = (kind, len(values), raw)
        if len(raw) > 4 and tag != offsets_tag:
            blobs += b"\x00" * (len(blobs) % 2)
            fields[tag] = (kind, len(values), data_start + len(blobs))
            blobs += raw
    offsets_at = data_start + len(blobs) + len(blobs) % 2
    blobs += b"\x00" * (len(blobs) % 2)
    if len(strips) > 1:
        blobs += b"\x00" * (4 * len(strips))
    strip_start = data_start + len(blobs)
    offsets, pos = [], strip_start
    for strip in strips:
        offsets.append(pos)
        pos += len(strip) + len(strip) % 2
    raw = struct.pack(order + "I" * len(offsets), *offsets)
    if len(strips) > 1:
        fields[offsets_tag] = (4, len(offsets), offsets_at)
        blobs[offsets_at - data_start: offsets_at - data_start + len(raw)] = raw
    else:
        fields[offsets_tag] = (4, 1, raw)
    out = bytearray(b"II*\x00" if order == "<" else b"MM\x00*")
    out += struct.pack(order + "I", 8) + struct.pack(order + "H", count)
    for tag in sorted(fields):
        kind, n, value = fields[tag]
        field = value.ljust(4, b"\x00") if isinstance(value, bytes) else struct.pack(
            order + "I", value)
        out += struct.pack(order + "HHI", tag, kind, n) + field
    out += struct.pack(order + "I", 0) + blobs
    for strip in strips:
        out += strip + b"\x00" * (len(strip) % 2)
    return bytes(out)


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def rle8_rows(indices, delta_after=None) -> bytes:
    """BI_RLE8 data of (H, W) indices, bottom row first: runs of 2 or
    more equal indices encoded, 3 or more others absolute (padded to a
    word), an end-of-line after each row and an end of bitmap. With
    ``delta_after`` = (row, column), that row's rest and the next row
    up to the column are a delta escape (0, 2, dx, dy) instead."""
    out = bytearray()
    rows = np.asarray(indices, np.uint8)[::-1]
    for y, row in enumerate(rows):
        x, width = 0, len(row)
        while x < width:
            if delta_after and (y, x) == delta_after:
                out += bytes([0, 2, 0, 1])
                break
            run = 1
            while x + run < width and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 2:
                out += bytes([run, row[x]])
                x += run
                continue
            end = x + 1
            while end < width and end - x < 255 and (end + 1 >= width or row[end] != row[end + 1]):
                end += 1
            if end - x >= 3:
                chunk = bytes(row[x:end])
                out += bytes([0, len(chunk)]) + chunk + b"\x00" * (len(chunk) % 2)
            else:
                for value in row[x:end]:
                    out += bytes([1, value])
            x = end
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def rle4_rows(indices) -> bytes:
    """BI_RLE4 data of (H, W) 4-bit indices, bottom row first: runs that
    alternate two indices (a repeated pair) encoded, the rest absolute in
    runs of an even length (PIL reads an odd one a pixel short), an
    end-of-line after each row and an end of bitmap."""
    out = bytearray()
    rows = np.asarray(indices, np.uint8)[::-1]
    for row in rows:
        x, width = 0, len(row)
        while x < width:
            run = 1
            while x + run < width and run < 255 and row[x + run] == row[x + (run % 2)]:
                run += 1
            if run >= 4 or x + run == width:
                second = row[x + 1] if run > 1 else 0
                out += bytes([run, row[x] << 4 | second])
                x += run
                continue
            count = min(width - x, 32) // 2 * 2
            chunk = row[x:x + count]
            packed = bytes(int(a) << 4 | int(b) for a, b in zip(chunk[0::2], chunk[1::2]))
            out += bytes([0, count]) + packed + b"\x00" * (len(packed) % 2)
            x += count
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def write_bmp(pixels, bits, *, header=40, compression=0, palette=None, colors_used=None,
              top_down=False, masks=None, data=None) -> bytes:
    """A BMP of (H, W) palette indices or (H, W, 3) RGB ``pixels`` at
    ``bits`` bits: header of 12 (OS/2 1.x), 40, 52, 56, 108 or 124 bytes;
    ``compression`` 0 (BI_RGB), 1 (RLE8), 2 (RLE4) or 3 (bit fields, with
    ``masks``, in the header from 52 bytes, after it at 40);
    ``palette`` (n, 3) RGB, written as ``colors_used`` (default n) entries;
    ``data``: the pixel data as stored, instead of packing ``pixels``."""
    pixels = np.asarray(pixels)
    height, width = pixels.shape[:2]
    if data is None:
        rows = pixels[::1 if top_down else -1]
        if bits <= 8:
            packed = _pack_rows(rows.astype(np.int64), bits, "<")
        elif bits == 16:
            red, green, blue = (rows[..., i].astype(np.int64) for i in range(3))
            if masks and masks[0] == 0xF800:
                value = (red >> 3) << 11 | (green >> 2) << 5 | blue >> 3
            else:
                value = (red >> 3) << 10 | (green >> 3) << 5 | blue >> 3
            packed = value.astype("<u2").view(np.uint8).reshape(height, -1)
        elif bits == 24:
            packed = rows[..., ::-1].reshape(height, -1).astype(np.uint8)
        else:
            packed = np.concatenate([rows[..., ::-1], np.full((height, width, 1), 255, np.uint8)],
                                    -1).reshape(height, -1).astype(np.uint8)
        stride = ((width * bits + 31) >> 3) & ~3
        padded = np.zeros((height, stride), np.uint8)
        padded[:, :packed.shape[1]] = packed
        data = padded.tobytes()
    table = b""
    if palette is not None:
        entries = np.asarray(palette, np.uint8)[:, ::-1]
        if header != 12:
            entries = np.concatenate([entries, np.zeros((len(entries), 1), np.uint8)], 1)
        table = entries.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height, 1,
                           bits, compression, len(data), 2835, 2835,
                           colors_used if colors_used is not None else
                           (0 if palette is None else len(palette)), 0)
        if header >= 52:
            info += struct.pack("<III", *(masks or (0, 0, 0))[:3])
        if header >= 56:
            info += struct.pack("<I", (masks or (0, 0, 0, 0))[3] if masks and len(masks) > 3
                                else 0)
        info = info.ljust(header, b"\x00")
        if header == 40 and compression == 3:
            info += struct.pack("<III", *masks[:3])
    offset = 14 + len(info) + len(table)
    head = b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset)
    return head + info + table + data


# ---------------------------------------------------------------------------
# PNM
# ---------------------------------------------------------------------------


def write_pnm(values, kind, maxval=255, comment=None) -> bytes:
    """A PNM of kind 1-6 (``values``: (H, W) 0/1 for P1/P4 with 1 black,
    (H, W) grey or (H, W, 3) RGB samples up to ``maxval``), with a
    ``comment`` line inside the header."""
    values = np.asarray(values)
    height, width = values.shape[:2]
    note = b"" if comment is None else b"# " + comment + b"\n"
    head = b"P%d\n%s%d %d\n" % (kind, note, width, height)
    if kind in (1, 4):
        if kind == 1:
            rows = [b" ".join(b"%d" % v for v in row) for row in values]
            return head + b"\n".join(rows) + b"\n"
        return head + np.packbits(values.astype(np.uint8), axis=1).tobytes()
    head += b"%d\n" % maxval
    if kind in (2, 3):
        flat = values.reshape(height, -1)
        return head + b"\n".join(b" ".join(b"%d" % v for v in row) for row in flat) + b"\n"
    return head + values.astype(">u2" if maxval > 255 else np.uint8).tobytes()


# ---------------------------------------------------------------------------
# TGA, PCX, ICO and CUR
# ---------------------------------------------------------------------------


def _rle_packets(pixels, size, run_flag, max_run, literal=True) -> bytes:
    """Run-length packets of a row of ``size``-byte pixels (bytes): a run
    of 2 or more equal pixels as ``run_flag | (n - 1)`` and one pixel, the
    rest as literal packets ``(n - 1)`` and their pixels (TGA)."""
    out = bytearray()
    units = [bytes(pixels[i:i + size]) for i in range(0, len(pixels), size)]
    x = 0
    while x < len(units):
        run = 1
        while x + run < len(units) and run < max_run and units[x + run] == units[x]:
            run += 1
        if run >= 2 or not literal:
            out += bytes([run_flag | (run - 1)]) + units[x]
            x += run
            continue
        end = x + 1
        while end < len(units) and end - x < max_run and (
                end + 1 >= len(units) or units[end] != units[end + 1]):
            end += 1
        out += bytes([end - x - 1]) + b"".join(units[x:end])
        x = end
    return bytes(out)


def tga_pixels(values, image_type, depth) -> np.ndarray:
    """(H, W, bytes) of TGA pixel data, rows top first, left to right:
    indices or grey (8), grey + alpha (16, types 3 and 11), 16-bit words
    as given (types 2 and 10), BGR (24) or BGRA (32) of RGB(A) values;
    (H, ceil(W / 8), 1) packed bits at depth 1."""
    values = np.asarray(values)
    if depth == 1:
        return np.packbits(values.astype(np.uint8), axis=1)[..., None]
    if depth == 8:
        return values.astype(np.uint8)[..., None]
    if depth == 16 and image_type & 7 == 3:
        return values.astype(np.uint8)
    if depth == 16:
        return values.astype("<u2").view(np.uint8).reshape(values.shape + (2,))
    order = [2, 1, 0] + ([3] if depth == 32 else [])
    return values[..., order].astype(np.uint8)


def write_tga(values, image_type, depth, *, colormap=None, map_depth=24, map_start=0,
              top=False, right=False, span_rows=False, id_section=b"", alpha_bits=0,
              data=None) -> bytes:
    """A TGA file of ``values`` (see :func:`tga_pixels`) of image type 1,
    2, 3 (raw) or 9, 10, 11 (run-length) at ``depth`` bits: rows bottom
    first unless ``top``, right to left if ``right``; a colour map of
    (n, 3) or (n, 4) RGB(A) ``colormap`` entries of ``map_depth`` 16, 24
    or 32 bits from index ``map_start``; run-length packets within rows,
    or across them with ``span_rows``; ``data``: the image data as
    stored."""
    pixels = tga_pixels(values, image_type, depth)
    height, width = np.asarray(values).shape[:2]
    if data is None:
        rows = pixels if top else pixels[::-1]
        if right:
            rows = rows[:, ::-1]
        size = rows.shape[2]
        if image_type & 8:
            if span_rows:
                data = _rle_packets(rows.tobytes(), size, 0x80, 128)
            else:
                data = b"".join(_rle_packets(row.tobytes(), size, 0x80, 128) for row in rows)
        else:
            data = rows.tobytes()
    table = b""
    if colormap is not None:
        entries = np.asarray(colormap, np.int64)
        if map_depth == 16:
            word = (entries[:, 0] >> 3) << 10 | (entries[:, 1] >> 3) << 5 | entries[:, 2] >> 3
            table = word.astype("<u2").tobytes()
        else:
            channels = [2, 1, 0] + ([3] if map_depth == 32 else [])
            if entries.shape[1] == 3 and map_depth == 32:
                entries = np.concatenate([entries, np.full((len(entries), 1), 255)], 1)
            table = entries[:, channels].astype(np.uint8).tobytes()
    descriptor = alpha_bits | (0x10 if right else 0) | (0x20 if top else 0)
    header = struct.pack("<BBBHHBHHHHBB", len(id_section), colormap is not None, image_type,
                         map_start, 0 if colormap is None else len(colormap),
                         map_depth if colormap is not None else 0, 0, 0, width, height, depth,
                         descriptor)
    return header + id_section + table + data


def write_pcx(values, bits, planes, *, palette=None, version=5, stride=None, span_rows=False,
              origin=(0, 0), header_stride=None) -> bytes:
    """A PCX file: ``values`` (H, W) indices (1-bit over 1, 2 or 4 planes,
    8-bit over 1) or (H, W, 3) RGB (8-bit over 3 planes), each plane's
    row padded to ``stride`` bytes (default: even), run-length coded per
    row (``0xC0 | n`` runs of up to 63), or across rows with
    ``span_rows``; ``palette``: 16 header entries, or 256 after the data
    (``0x0C``); ``header_stride``: the bytes per line the header states."""
    values = np.asarray(values)
    height, width = values.shape[:2]
    need = (width * bits + 7) // 8
    stride = stride or need + need % 2
    lines = np.zeros((height, planes, stride), np.uint8)
    if bits == 1:
        for p in range(planes):
            lines[:, p, :need] = np.packbits(((values >> p) & 1).astype(np.uint8), axis=1)
    elif bits < 8:
        lines[:, 0, :need] = _pack_rows(values.astype(np.int64), bits, "<")
    elif planes == 3:
        lines[:, :, :width] = values.transpose(0, 2, 1)
    else:
        lines[:, 0, :width] = values
    head = np.zeros(16, np.uint8) if palette is None or len(palette) != 16 else None
    header = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, origin[0], origin[1],
                         origin[0] + width - 1, origin[1] + height - 1, 72, 72)
    header += (np.asarray(palette, np.uint8).tobytes() if head is None else bytes(48))
    header += bytes([0, planes]) + struct.pack("<HH", header_stride or stride, 1)
    header = header.ljust(128, b"\x00")
    rows = lines.reshape(height, -1)
    if span_rows:
        data = _pcx_rle(rows.tobytes())
    else:
        data = b"".join(_pcx_rle(row.tobytes()) for row in rows)
    tail = b""
    if palette is not None and len(palette) == 256:
        tail = b"\x0c" + np.asarray(palette, np.uint8).tobytes()
    return header + data + tail


def _pcx_rle(data: bytes) -> bytes:
    out = bytearray()
    x = 0
    while x < len(data):
        run = 1
        while x + run < len(data) and run < 63 and data[x + run] == data[x]:
            run += 1
        if run > 1 or data[x] >= 0xC0:
            out += bytes([0xC0 | run, data[x]])
        else:
            out.append(data[x])
        x += run
    return bytes(out)


def dib_entry(values, bits, *, palette=None, alpha=None, and_mask=None) -> bytes:
    """An icon's DIB: a BITMAPINFOHEADER of twice the height, the XOR image
    (as :func:`write_bmp` stores it; 32-bit BGRA with ``alpha``) and the
    1-bit AND mask (``and_mask``, default clear), rows bottom first."""
    values = np.asarray(values)
    height, width = values.shape[:2]
    data = None
    if bits == 32:
        alpha = np.full((height, width), 255) if alpha is None else alpha
        bgra = np.concatenate([values[..., ::-1], np.asarray(alpha)[..., None]], -1)
        data = bgra[::-1].astype(np.uint8).tobytes()
    bmp = write_bmp(values, bits, palette=palette, data=data)
    info = bytearray(bmp[14:])
    struct.pack_into("<i", info, 8, 2 * height)
    mask = np.zeros((height, width), bool) if and_mask is None else np.asarray(and_mask, bool)
    stride = ((width + 31) // 32) * 4
    rows = np.zeros((height, stride), np.uint8)
    packed = np.packbits(mask[::-1].astype(np.uint8), axis=1)
    rows[:, :packed.shape[1]] = packed
    return bytes(info) + rows.tobytes()


def write_ico(entries, kind=1) -> bytes:
    """An ICO (``kind`` 1) or CUR (2) file of ``entries``, each (width
    byte, height byte, colour count, planes or hot spot x, bits or hot spot
    y, image bytes: a DIB or a PNG)."""
    head = struct.pack("<HHH", 0, kind, len(entries))
    offset = len(head) + 16 * len(entries)
    directory, body = b"", b""
    for width, height, colors, planes, bits, blob in entries:
        directory += struct.pack("<BBBBHHII", width, height, colors, 0, planes, bits, len(blob),
                                 offset + len(body))
        body += blob
    return head + directory + body


# ---------------------------------------------------------------------------
# The fixtures
# ---------------------------------------------------------------------------


def scene(height, width, seed=21) -> np.ndarray:
    """A (H, W, 3) uint8 test picture: gradients, a noisy block and
    stripes, so that every codec sees runs and noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:height, :width]
    rgb = np.stack([(xx * 255 // max(width - 1, 1)), (yy * 255 // max(height - 1, 1)),
                    ((xx // 6 + yy // 6) % 2) * 200 + 30], -1)
    rgb[height // 4:height // 2, width // 5:width // 2] = rng.randint(
        0, 256, (height // 2 - height // 4, width // 2 - width // 5, 3))
    rgb[(yy % 11 == 0)] = (250, 250, 250)
    return rgb.astype(np.uint8)


def text_page(height=3300, width=2550, seed=0) -> np.ndarray:
    """A bilevel (H, W) page of text lines as a 300-dpi letter scan
    holds them (True is black), rendered with PIL's default font."""
    from PIL import Image, ImageDraw, ImageFont

    rng = np.random.RandomState(seed)
    words = ("image format scanner page text line detection recognition optical character "
             "group four fax document letter paper ink") .split()
    page = Image.new("1", (width, height), 1)
    draw = ImageDraw.Draw(page)
    font = ImageFont.load_default(size=42)
    y = 180
    while y < height - 240:
        line = " ".join(rng.choice(words, rng.randint(6, 11)))
        draw.text((200, y), line, font=font, fill=0)
        y += 64 if rng.rand() > 0.15 else 130
    return ~np.array(page)


def _pil_tiff(image, **kwargs) -> bytes:
    out = io.BytesIO()
    image.save(out, "TIFF", **kwargs)
    return out.getvalue()


def _pil_bytes(image, fmt, **kwargs) -> bytes:
    out = io.BytesIO()
    image.save(out, fmt, **kwargs)
    return out.getvalue()


def adobe_transform(jpeg: bytes, transform: int) -> bytes:
    """A JPEG with its Adobe APP14 marker's transform byte replaced."""
    at = jpeg.index(b"\xff\xeeAdobe" if b"\xff\xeeAdobe" in jpeg else b"\xff\xee")
    data = bytearray(jpeg)
    data[at + 4 + 11] = transform
    return bytes(data)


def fixture_files() -> dict:
    """The fixtures: name -> file bytes. Each is at most 128x128 but the
    Group 4 page."""
    from PIL import Image

    rgb = scene(48, 64)
    image = Image.fromarray(rgb)
    grey = np.asarray(image.convert("L"))
    bilevel = grey < 128
    rng = np.random.RandomState(22)
    palette16 = rng.randint(0, 256, (16, 3)).astype(np.uint8)
    index16 = (grey // 16).astype(np.uint8)
    ycc_strips = []
    for y in range(0, 48, 16):
        ycc_strips.append(_pil_bytes(Image.fromarray(rgb[y:y + 16]), "JPEG", quality=85,
                                     subsampling="4:2:0"))
    cmyk_jpeg = _pil_bytes(image.convert("CMYK"), "JPEG", quality=90, subsampling="4:2:0")
    colormap = (np.repeat(palette16.astype(np.int64), 1, 0) * 257)
    files = {
        # PIL's writers (libtiff for the compressed TIFFs).
        "page_g4.tif": _pil_tiff(Image.fromarray(~text_page()), compression="group4"),
        "g3_1d.tif": _pil_tiff(Image.fromarray(~bilevel), compression="group3"),
        "g3_2d_fill.tif": _pil_tiff(Image.fromarray(~bilevel), compression="group3",
                                    tiffinfo={292: 5}),
        "g4.tif": _pil_tiff(Image.fromarray(~bilevel), compression="group4"),
        "ccitt_rle.tif": _pil_tiff(Image.fromarray(~bilevel), compression="tiff_ccitt"),
        "lzw_rgb.tif": _pil_tiff(image, compression="tiff_lzw"),
        "deflate_grey.tif": _pil_tiff(image.convert("L"), compression="tiff_adobe_deflate"),
        "packbits_rgba.tif": _pil_tiff(image.convert("RGBA"), compression="packbits"),
        "jpeg_rgb.tif": _pil_tiff(image, compression="jpeg", tiffinfo={278: 16}),
        "cmyk.jpg": cmyk_jpeg,
        "ycck.jpg": adobe_transform(cmyk_jpeg, 2),
        "rgb24.bmp": _pil_bytes(image, "BMP"),
        "grey8.bmp": _pil_bytes(image.convert("L"), "BMP"),
        "bilevel1.bmp": _pil_bytes(Image.fromarray(~bilevel), "BMP"),
        "raw.ppm": _pil_bytes(image, "PPM"),
        "raw.pgm": _pil_bytes(image.convert("L"), "PPM"),
        "raw.pbm": _pil_bytes(Image.fromarray(~bilevel), "PPM"),
        # The writers here.
        "be_lzw_predictor_rgb.tif": write_tiff(rgb, photometric=2, order=">", compression=5,
                                               predictor=2, rows_per_strip=20),
        "tiled_deflate_rgb.tif": write_tiff(rgb, photometric=2, compression=32946,
                                            tile=(32, 32)),
        "planar_packbits_rgb.tif": write_tiff(rgb, photometric=2, compression=32773,
                                              planar=2, rows_per_strip=16),
        "grey16_lzw_predictor.tif": write_tiff(grey.astype(np.uint16) * 3 - 200 * (grey > 80),
                                               photometric=1, bits=16, compression=5,
                                               predictor=2),
        "grey4_whiteiszero.tif": write_tiff(index16, photometric=0, bits=4),
        "grey2.tif": write_tiff(grey // 64, photometric=1, bits=2, compression=32773),
        "palette4.tif": write_tiff(index16, photometric=3, bits=4, compression=5,
                                   colormap=colormap),
        "fillorder2_g4.tif": write_tiff(
            photometric=0, bits=1, compression=4, fill_order=2, size=bilevel.shape,
            strips=[_g4_strip(bilevel)]),
        "cmyk_lzw.tif": write_tiff(np.asarray(image.convert("CMYK")), photometric=5,
                                   compression=5, tags={332: (3, [1])}),
        "rgba_associated.tif": write_tiff(
            np.concatenate([rgb // 2, np.full((48, 64, 1), 128, np.uint8)], -1),
            photometric=2, extra_samples=(1,), compression=8),
        "ycbcr_jpeg.tif": write_tiff(photometric=6, compression=7, bits=(8, 8, 8),
                                     size=(48, 64), strips=ycc_strips, rows_per_strip=16,
                                     tags={530: (3, [2, 2])}),
        "rle8.bmp": write_bmp(grey // 4, 8, compression=1, data=rle8_rows(grey // 4),
                              palette=rng.randint(0, 256, (64, 3))),
        "rle4.bmp": write_bmp(index16, 4, compression=2, data=rle4_rows(index16),
                              palette=palette16),
        "bitfields565.bmp": write_bmp(rgb, 16, compression=3, header=40,
                                      masks=(0xF800, 0x7E0, 0x1F)),
        "os2_8bit.bmp": write_bmp(index16, 8, header=12, palette=palette16),
        "v5_topdown_short_palette.bmp": write_bmp(grey // 8, 8, header=124, top_down=True,
                                                  palette=rng.randint(0, 256, (20, 3))),
        "plain.pbm": write_pnm(bilevel[:24, :40], 1, comment=b"plain bitmap"),
        "plain.pgm": write_pnm(grey[:24, :40], 2, comment=b"plain greymap"),
        "plain_1023.ppm": write_pnm(rgb[:24, :40].astype(np.int64) * 4 + 3, 3, maxval=1023),
        "raw_1023.ppm": write_pnm(rgb.astype(np.int64) * 4 + 3, 6, maxval=1023),
        "raw_65535.ppm": write_pnm(rgb.astype(np.int64) * 257, 6, maxval=65535),
        "raw_1023.pgm": write_pnm(grey.astype(np.int64) // 2, 5, maxval=1023),
        # TGA, PCX, ICO and CUR: PIL's writers, then the writers here.
        "rle_rgb.tga": _pil_bytes(image, "TGA", compression="tga_rle"),
        "top_rgba.tga": _pil_bytes(image.convert("RGBA"), "TGA", orientation=1,
                                   id_section=b"fixture"),
        "grey.tga": _pil_bytes(image.convert("L"), "TGA"),
        "palette_rle.tga": _pil_bytes(image.convert("P"), "TGA", rle=True),
        "colormap16_rle.tga": write_tga(index16, 9, 8, colormap=palette16, map_depth=16,
                                        map_start=3),
        "rgb15_rle_right.tga": write_tga((rgb[..., 0].astype(np.int64) >> 3) << 10
                                         | (rgb[..., 1] >> 3) << 5 | rgb[..., 2] >> 3, 10, 16,
                                         right=True, top=True),
        "la_rle_spanning.tga": write_tga(np.stack([grey, rgb[..., 2]], -1), 11, 16,
                                         span_rows=True, data=_spanning_literals(grey, rgb)),
        "bilevel.tga": write_tga(bilevel, 3, 1, right=True),
        "bilevel.pcx": _pil_bytes(Image.fromarray(~bilevel), "PCX"),
        "grey.pcx": _pil_bytes(image.convert("L"), "PCX"),
        "palette.pcx": _pil_bytes(image.convert("P"), "PCX"),
        "rgb.pcx": _pil_bytes(image, "PCX"),
        "planes4.pcx": write_pcx(index16, 1, 4, palette=palette16),
        "planes2_odd.pcx": write_pcx(index16[:, :61] // 4, 1, 2, palette=palette16,
                                     origin=(3, 5)),
        "rgb_odd_stride.pcx": write_pcx(rgb[:, :63], 8, 3, stride=63, header_stride=63),
        "sizes_png.ico": _pil_bytes(Image.fromarray(scene(32, 32)), "ICO",
                                    sizes=[(16, 16), (32, 32)]),
        "sizes_bmp.ico": _pil_bytes(Image.fromarray(scene(32, 32)), "ICO",
                                    sizes=[(16, 16), (32, 32)], bitmap_format="bmp"),
        # PIL shows the 4-bit entry (of equal sizes, the lowest depth): last.
        "dib_depths.ico": write_ico([
            (48, 48, 0, 1, 32, dib_entry(rgb[:48, :48], 32, alpha=grey[:48, :48])),
            (48, 48, 0, 1, 8, dib_entry(grey[:48, :48] // 4, 8, palette=rng.randint(
                0, 256, (64, 3)), and_mask=bilevel[:48, :48])),
            (48, 48, 16, 1, 4, dib_entry(index16[:48, :48], 4, palette=palette16))]),
        "cursor.cur": write_ico([(16, 16, 0, 2, 3, dib_entry(index16[:16, :16], 4,
                                                             palette=palette16)),
                                 (32, 32, 0, 9, 9, dib_entry(rgb[:32, :32], 24))], kind=2),
    }
    return files


def _spanning_literals(grey, rgb) -> bytes:
    """Run-length TGA data of (grey, alpha) pixels whose literal packets
    run across rows (rows bottom first): 100-pixel literals, then a run
    to the end of each row they leave short."""
    pixels = np.stack([grey, rgb[..., 2]], -1)[::-1].reshape(-1, 2)
    width = grey.shape[1]
    out = bytearray()
    at = 0
    while at < len(pixels):
        take = min(100, len(pixels) - at)
        out += bytes([take - 1]) + pixels[at:at + take].tobytes()
        at += take
        rest = -at % width
        if rest and at < len(pixels):
            out += bytes([0x80 | (rest - 1)]) + pixels[at].tobytes()
            at += rest
    return bytes(out)


def _g4_strip(bilevel) -> bytes:
    """PIL's (libtiff's) Group 4 data of a bilevel image, 1 black."""
    from PIL import Image

    blob = _pil_tiff(Image.fromarray(~bilevel), compression="group4")
    image = Image.open(io.BytesIO(blob))
    offset, count = image.tag_v2[273][0], image.tag_v2[279][0]
    return blob[offset:offset + count]


def pil_hash(blob: bytes) -> dict:
    from PIL import Image

    pixels = np.array(Image.open(io.BytesIO(blob)).convert("RGB"))
    return {"shape": list(pixels.shape),
            "decoded_sha256": hashlib.sha256(pixels.tobytes()).hexdigest()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    parser.add_argument("--out", default=os.path.join(here, "..", "tests", "fixtures", "images"))
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    hashes = {}
    for name, blob in fixture_files().items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(blob)
        hashes[name] = pil_hash(blob)
        print(name, len(blob), "bytes", hashes[name]["shape"], hashes[name]["decoded_sha256"])
    with open(os.path.join(args.out, "hashes.json"), "w") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
