"""Write the PSD, QOI, SGI, Sun raster, DIB, DCX, ICNS, IM, MSP, XBM and XPM
fixtures that ``tests/test_torch_rasters.py`` and ``chip_smoke.py`` read,
with the sha256 of PIL's decodes as their hashes.

    python scripts/make_raster_fixtures.py [--out tests/fixtures/rasters]

PIL writes QOI, SGI (verbatim), DIB, ICNS (PNG entries), IM, MSP
(version 1) and XBM; the writers here make what it does not: PSD (PIL has
no writer) raw and PackBits in every colour mode PIL reads, with image
resources and a layer section to skip; QOI streams of chosen ops; SGI RLE
at 8 and 16 bits; Sun rasters (PIL has no writer) of every depth and file
type; DCX pages; ICNS run-length, raw and JPEG 2000 entries with masks;
IM files of every image type of PIL's table; MSP version 2; XPM. Each file
is decoded by PIL as it is written (``pil_hash``), so a file PIL cannot
read stops the script.

``hashes.json`` beside them holds each file's shape and the sha256 of
``np.array(PIL.Image.open(f).convert("RGB"))``. It also holds those of the
large files, which are not committed: the 12 golden scenes of
``tests/fixtures/golden_offline`` as PackBits RGB PSD and as QOI, scene 3
as raw PSD and as RLE SGI, and the 640x480 photo
(``tests/fixtures/test_image.jpg``) as PackBits PSD, with each file's own
sha256; ``write_large`` writes them where they are read (the tests, and
``chip_smoke.py`` with ``tools.read`` for PIL). The script needs PIL; the
writers and the files do not.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from make_image_fixtures import packbits_encode, scene, write_bmp, write_pcx  # noqa: E402

GOLDEN = os.path.join(HERE, "..", "tests", "fixtures", "golden_offline")
PHOTO = os.path.join(HERE, "..", "tests", "fixtures", "test_image.jpg")

# ---------------------------------------------------------------------------
# PSD
# ---------------------------------------------------------------------------

PSD_COLOUR = {"bitmap": 0, "grey": 1, "indexed": 2, "RGB": 3, "CMYK": 4, "multichannel": 7,
              "duotone": 8, "Lab": 9}


def psd_resources(*items) -> bytes:
    """An image resource section's body: ``(id, name, data)`` items, each
    name a padded Pascal string, each data block padded to even."""
    out = bytearray()
    for ident, name, data in items:
        pascal = bytes([len(name)]) + name
        out += b"8BIM" + struct.pack(">H", ident) + pascal + b"\0" * (len(pascal) % 2)
        out += struct.pack(">I", len(data)) + data + b"\0" * (len(data) % 2)
    return bytes(out)


def write_psd(planes, colour, *, bits=8, compression=1, colour_data=b"", resources=b"",
              layers=b"", channels=None, version=1, counts=None, width=None) -> bytes:
    """A PSD file of ``planes`` ((C, H, W) uint8 channels; bytes of packed
    bits for a bitmap): ``colour`` a key of ``PSD_COLOUR`` or its number;
    ``compression`` 0 (raw) or 1 (PackBits, with every channel's row byte
    counts, or ``counts`` as given); ``channels`` the count the header
    states (default: the planes'); ``width`` a bitmap's width in pixels."""
    planes = np.asarray(planes, np.uint8)
    count, height = planes.shape[:2]
    width = width or (planes.shape[2] * 8 if bits == 1 else planes.shape[2])
    colour = PSD_COLOUR.get(colour, colour)
    out = bytearray(b"8BPS" + struct.pack(">H6xHIIHH", version, channels or count, height,
                                          width, bits, colour))
    out += struct.pack(">I", len(colour_data)) + colour_data
    out += struct.pack(">I", len(resources)) + resources
    out += struct.pack(">I", len(layers)) + layers
    out += struct.pack(">H", compression)
    if compression == 0:
        out += planes.tobytes()
    else:
        rows = [packbits_encode(row.tobytes()) for plane in planes for row in plane]
        table = counts if counts is not None else [len(r) for r in rows]
        out += struct.pack(f">{len(table)}H", *table) + b"".join(rows)
    return bytes(out)


def psd_layers() -> bytes:
    """A layer and mask section for PIL to skip: a layer-info block of one
    layer record's worth of bytes, then a global mask block."""
    info = struct.pack(">h", 1) + struct.pack(">iiii", 0, 0, 4, 4) + struct.pack(">H", 1)
    info += struct.pack(">hI", 0, 18) + b"8BIMnorm" + bytes([255, 0, 0, 0])
    info += struct.pack(">I", 0) + bytes(18)
    return struct.pack(">I", len(info)) + info + struct.pack(">I", 0)


def rgb_planes(rgb) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(np.asarray(rgb, np.uint8), -1, 0))


# ---------------------------------------------------------------------------
# QOI
# ---------------------------------------------------------------------------


def qoi_header(width, height, channels=4, colourspace=0) -> bytes:
    return b"qoif" + struct.pack(">IIBB", width, height, channels, colourspace)


QOI_END = b"\0" * 7 + b"\1"


def qoi_encode(pixels, channels=None) -> bytes:
    """The QOI reference encoder on (H, W, 3 or 4) uint8 pixels."""
    pixels = np.asarray(pixels, np.uint8)
    height, width, depth = pixels.shape
    rgba = pixels if depth == 4 else np.concatenate(
        [pixels, np.full((height, width, 1), 255, np.uint8)], -1)
    flat = [tuple(p) for p in rgba.reshape(-1, 4).tolist()]
    out = bytearray(qoi_header(width, height, channels or depth))
    index = [(0, 0, 0, 0)] * 64
    prev, run = (0, 0, 0, 255), 0
    for k, px in enumerate(flat):
        if px == prev:
            run += 1
            if run == 62 or k == len(flat) - 1:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        slot = (px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64
        if index[slot] == px:
            out.append(slot)
        else:
            index[slot] = px
            if px[3] == prev[3]:
                dr, dg, db = ((px[i] - prev[i] + 128) % 256 - 128 for i in range(3))
                if -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
                    out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2))
                elif -32 <= dg <= 31 and -8 <= dr - dg <= 7 and -8 <= db - dg <= 7:
                    out += bytes([0x80 | (dg + 32), (dr - dg + 8) << 4 | (db - dg + 8)])
                else:
                    out += bytes([0xFE, *px[:3]])
            else:
                out += bytes([0xFF, *px])
        prev = px
    return bytes(out + QOI_END)


# ---------------------------------------------------------------------------
# SGI
# ---------------------------------------------------------------------------


def sgi_header(width, height, channels, bpc, rle, dimension=None) -> bytes:
    if dimension is None:
        dimension = 3 if channels > 1 else (1 if height == 1 else 2)
    head = struct.pack(">HBBHHHHII4x", 474, rle, bpc, dimension, width, height, channels, 0,
                       255 if bpc == 1 else 65535)
    return (head + b"fixture".ljust(80, b"\0") + struct.pack(">I", 0)).ljust(512, b"\0")


def _sgi_rle_row(samples, bpc) -> bytes:
    """One channel's row in SGI RLE: runs of 3 or more as repeats, the rest
    as literals of up to 127, then the end marker; 16-bit samples and
    counts as big-endian shorts."""
    word = (lambda v: struct.pack(">H", v)) if bpc == 2 else (lambda v: bytes([v]))
    out = bytearray()
    values = [int(v) for v in samples]
    pos, n = 0, len(values)
    literal = []

    def flush():
        for start in range(0, len(literal), 127):
            chunk = literal[start:start + 127]
            out.extend(word(0x80 | len(chunk)))
            for v in chunk:
                out.extend(word(v))
        literal.clear()

    while pos < n:
        run = 1
        while pos + run < n and run < 127 and values[pos + run] == values[pos]:
            run += 1
        if run >= 3:
            flush()
            out.extend(word(run))
            out.extend(word(values[pos]))
        else:
            literal.extend(values[pos:pos + run])
        pos += run
    flush()
    out.extend(word(0))
    return bytes(out)


def write_sgi(pixels, *, bpc=1, rle=False, dimension=None, share_rows=False,
              rows=None, lengths=None) -> bytes:
    """An SGI file of (H, W) or (H, W, C) samples (uint8, or uint16 for
    ``bpc`` 2), rows stored bottom up; RLE rows (identical rows stored
    once with ``share_rows``; ``rows`` maps (channel, stored row) to the
    bytes to store instead; ``lengths`` likewise the table's lengths)."""
    pixels = np.asarray(pixels)
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    height, width, channels = pixels.shape
    head = sgi_header(width, height, channels, bpc, int(rle), dimension)
    planes = np.moveaxis(pixels, -1, 0)[:, ::-1]
    if not rle:
        dtype = ">u2" if bpc == 2 else np.uint8
        return head + np.ascontiguousarray(planes).astype(dtype).tobytes()
    table = 512 + 8 * channels * height
    data, starts, sizes, seen = bytearray(), [], [], {}
    for c in range(channels):
        for r in range(height):
            body = (rows or {}).get((c, r)) or _sgi_rle_row(planes[c, r], bpc)
            if share_rows and body in seen:
                starts.append(seen[body])
            else:
                seen[body] = table + len(data)
                starts.append(table + len(data))
                data += body
            sizes.append((lengths or {}).get((c, r), len(body)))
    return head + struct.pack(f">{len(starts)}I", *starts) + struct.pack(
        f">{len(sizes)}I", *sizes) + bytes(data)


# ---------------------------------------------------------------------------
# Sun raster
# ---------------------------------------------------------------------------


def sun_rle(data: bytes) -> bytes:
    """Sun's byte encoding: runs of 3 or more (up to 256) as ``0x80 n-1
    v``, a lone 0x80 as ``0x80 0``, two as two of those, the rest as is."""
    out = bytearray()
    pos, n = 0, len(data)
    while pos < n:
        run = 1
        while pos + run < n and run < 256 and data[pos + run] == data[pos]:
            run += 1
        if run >= 3 or (data[pos] == 0x80 and run >= 2):
            out += bytes([0x80, run - 1, data[pos]])
        elif data[pos] == 0x80:
            out += b"\x80\x00"
        else:
            out += bytes(data[pos:pos + run])
        pos += run
    return bytes(out)


def write_sun(values, depth, *, kind=1, palette=None, map_type=1, map_bytes=None,
              padded=True, data=None) -> bytes:
    """A Sun raster of (H, W) values (1-, 4- or 8-bit) or (H, W, 3) RGB
    (24 or 32 bits, stored BGR unless ``kind`` is 3); ``palette`` (n, 3)
    written as planar ``RGB;L`` (``map_bytes`` as given instead); rows
    padded to 16 bits (RLE rows unpadded unless ``padded``); ``data`` the
    stored pixel bytes as given."""
    values = np.asarray(values)
    height, width = values.shape[:2]
    if data is None:
        if depth in (1, 4, 8):
            bits = values.astype(np.uint8)
            if depth < 8:
                per = 8 // depth
                cols = -(-width // per) * per
                full = np.zeros((height, cols), np.uint8)
                full[:, :width] = bits
                weights = (1 << (depth * np.arange(per - 1, -1, -1))).astype(np.uint8)
                rows = (full.reshape(height, -1, per) * weights).sum(-1).astype(np.uint8)
            else:
                rows = bits
        else:
            pixels = values[..., :3] if kind == 3 else values[..., 2::-1]
            if depth == 32:
                pixels = np.concatenate([pixels, np.full((height, width, 1), 7, np.uint8)], -1)
            rows = np.ascontiguousarray(pixels).reshape(height, -1)
        stride = ((width * depth + 15) // 16) * 2
        if kind != 2 or padded:
            rows = np.concatenate([rows, np.zeros((height, stride - rows.shape[1]), np.uint8)],
                                  1)
        data = rows.tobytes()
        if kind == 2:
            data = sun_rle(data)
    cmap = map_bytes if map_bytes is not None else (
        b"" if palette is None else np.ascontiguousarray(np.asarray(palette, np.uint8).T).tobytes())
    head = struct.pack(">8I", 0x59A66A95, width, height, depth, len(data), kind,
                       map_type if cmap else 0, len(cmap))
    return head + cmap + data


# ---------------------------------------------------------------------------
# DIB, DCX
# ---------------------------------------------------------------------------


def write_dib(*args, **kwargs) -> bytes:
    """``write_bmp`` without its 14-byte file header."""
    return write_bmp(*args, **kwargs)[14:]


def write_dcx(pages, offsets=None) -> bytes:
    """A DCX file of PCX ``pages``: the magic, the page offsets ended by 0
    (``offsets`` as given instead), the pages."""
    count = len(pages) if offsets is None else len(offsets)
    at = 4 + 4 * (count + 1)
    if offsets is None:
        offsets = []
        for page in pages:
            offsets.append(at)
            at += len(page)
    return struct.pack(f"<I{len(offsets)}I", 987654321, *offsets) + b"\0\0\0\0" + b"".join(pages)


# ---------------------------------------------------------------------------
# ICNS
# ---------------------------------------------------------------------------


def icns_rle(plane: bytes) -> bytes:
    """ICNS channel runs: 3-130 equal bytes as ``count + 125`` and the
    byte, the rest as literals of up to 128 (``count - 1``)."""
    out = bytearray()
    data = bytes(plane)
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
        while pos + run < n and run < 130 and data[pos + run] == data[pos]:
            run += 1
        if run >= 3:
            flush()
            out += bytes([run + 125, data[pos]])
        else:
            literal.extend(data[pos:pos + run])
        pos += run
    flush()
    return bytes(out)


def icns_rgb(rgb, kind, raw=False) -> bytes:
    """An ``is32`` / ``il32`` / ``ih32`` / ``it32`` entry's body."""
    rgb = np.asarray(rgb, np.uint8)
    if raw:
        body = rgb.tobytes()
    else:
        body = b"".join(icns_rle(rgb[..., c].tobytes()) for c in range(3))
    return (b"\0\0\0\0" if kind == b"it32" else b"") + body


def write_icns(entries, total=None) -> bytes:
    """An ICNS file of ``(type, body)`` entries; ``total`` the header's
    file length as given instead."""
    body = b"".join(kind + struct.pack(">I", 8 + len(data)) + data for kind, data in entries)
    return b"icns" + struct.pack(">I", total if total is not None else 8 + len(body)) + body


# ---------------------------------------------------------------------------
# IM
# ---------------------------------------------------------------------------


def write_im(kind, width, height, data, *, lut=None, lines=(), pad=True, header=None) -> bytes:
    """An IM file: ``Image type: <kind>``, the size, ``lines`` of header,
    a ``Lut`` palette ((256, 3), written planar) if given, then ``data``
    (the stored rows, bottom up); the header padded with NULs to 511
    bytes before its 0x1a, as PIL's writer does, unless not ``pad``;
    ``header`` the header text as given instead."""
    text = header if header is not None else (
        f"Image type: {kind}\r\nImage size (x*y): {width}*{height}\r\n".encode("latin-1")
        + b"".join(line + b"\r\n" for line in lines) + (b"Lut: 1\r\n" if lut is not None else b""))
    head = text + b"\0" * (511 - len(text)) if pad else text
    table = b"" if lut is None else np.ascontiguousarray(np.asarray(lut, np.uint8).T).tobytes()
    return head + b"\x1a" + table + bytes(data)


# ---------------------------------------------------------------------------
# MSP, XBM, XPM
# ---------------------------------------------------------------------------


def msp_header(magic, width, height) -> bytes:
    words = [0] * 16
    words[0], words[1] = struct.unpack("<HH", magic)
    words[2], words[3], words[4], words[5] = width, height, 1, 1
    words[6], words[7] = width, height
    checksum = 0
    for w in words[:12]:
        checksum ^= w
    words[12] = checksum
    return struct.pack("<16H", *words)


def write_msp_v2(bits, *, blank_rows=(), literal_only=False) -> bytes:
    """A Windows Paint 2 (``LinS``) file of (H, W) bits (1 white): the
    row map, then each row's runs (``0 n v`` repeats, ``n`` then n
    bytes); rows in ``blank_rows`` stored with length 0."""
    bits = np.asarray(bits, np.uint8)
    height, width = bits.shape
    rows = np.packbits(bits, axis=1)
    lengths, data = [], bytearray()
    for y, row in enumerate(rows):
        if y in blank_rows:
            lengths.append(0)
            continue
        line = bytearray()
        raw = row.tobytes()
        pos = 0
        while pos < len(raw):
            run = 1
            while pos + run < len(raw) and run < 255 and raw[pos + run] == raw[pos]:
                run += 1
            if run >= 3 and not literal_only:
                line += bytes([0, run, raw[pos]])
                pos += run
            else:
                take = min(255, len(raw) - pos) if literal_only else run
                line += bytes([take]) + raw[pos:pos + take]
                pos += take
        lengths.append(len(line))
        data += line
    return msp_header(b"LinS", width, height) + struct.pack(f"<{height}H", *lengths) + bytes(data)


def write_xbm(bits, name="fixture", *, hotspot=None, upper=False, per_line=12,
              lead=b"") -> bytes:
    """An X11 bitmap of (H, W) bits (1 set), least significant bit first."""
    bits = np.asarray(bits, np.uint8)
    height, width = bits.shape
    values = np.packbits(bits, axis=1, bitorder="little").reshape(-1)
    text = lead + f"#define {name}_width {width}\n#define {name}_height {height}\n".encode()
    if hotspot:
        text += f"#define {name}_x_hot {hotspot[0]}\n#define {name}_y_hot {hotspot[1]}\n".encode()
    text += f"static unsigned char {name}_bits[] = {{\n".encode()
    form = "0x{:02X}" if upper else "0x{:02x}"
    items = [form.format(v) for v in values.tolist()]
    for start in range(0, len(items), per_line):
        text += ("   " + ", ".join(items[start:start + per_line]) + ",\n").encode()
    return text + b"};\n"


def write_xpm(indices, colours, *, chars=1, keys=None, extra_keys=b"", pixels_comment=True,
              spill=0, comment_lines=False, line_end=b'",') -> bytes:
    """An X11 pixmap of (H, W) indices into ``colours`` (a list of
    ``#rrggbb`` byte strings or ``None``), ``chars`` characters a pixel
    (``keys`` the key of each colour as given instead); each colour line
    ``"<key> <extra_keys> c <colour>",``; the first line ``spill`` pixels
    longer and the last as many shorter (PIL reads pixels as a stream)."""
    indices = np.asarray(indices)
    height, width = indices.shape
    alphabet = b".#abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789+@$%&*=-;:>,<1"
    if keys is None:
        keys = []
        for k in range(len(colours)):
            key, v = b"", k
            for _ in range(chars):
                key = alphabet[v % len(alphabet):v % len(alphabet) + 1] + key
                v //= len(alphabet)
            keys.append(key)
    out = bytearray(b"/* XPM */\nstatic char *fixture[] = {\n")
    out += b"/* columns rows colors chars-per-pixel */\n"
    out += f'"{width} {height} {len(colours)} {chars}",\n'.encode()
    for key, colour in zip(keys, colours):
        out += b'"' + key + b" " + extra_keys + b"c " + (colour or b"None") + b'",\n'
    if pixels_comment:
        out += b"/* pixels */\n"
    stream = [keys[i] for i in indices.reshape(-1).tolist()]
    lengths = [width] * height
    if spill:
        lengths[0] += spill
        lengths[-1] -= spill
    rows, at = [], 0
    for n in lengths:
        rows.append(b"".join(stream[at:at + n]))
        at += n
    for y, row in enumerate(rows):
        if comment_lines and y % 3 == 1:
            out += b"/* a comment */\n"
        out += b'"' + row + (line_end if y < height - 1 else b'"') + b"\n"
    return bytes(out + b"};\n")


# ---------------------------------------------------------------------------
# The fixtures
# ---------------------------------------------------------------------------


def _pil_bytes(image, fmt, **kwargs) -> bytes:
    out = io.BytesIO()
    image.save(out, fmt, **kwargs)
    return out.getvalue()


def small_fixtures() -> dict:
    """The small committed files, one or more of each format's kinds."""
    from PIL import Image

    rgb = scene(27, 34, seed=5)
    grey = np.asarray(Image.fromarray(rgb).convert("L"))
    rng = np.random.RandomState(25)
    palette = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    out = {}
    # PSD: every colour mode, raw and PackBits; resources and layers.
    resources = psd_resources((1005, b"", bytes(16)), (1039, b"icc", bytes(7)),
                              (1036, b"thumb", bytes(9)))
    for name, planes, colour, extra in (
            ("rgb", rgb_planes(rgb), "RGB", {}),
            ("rgba", np.concatenate([rgb_planes(rgb), grey[None]]), "RGB", {}),
            ("grey", grey[None], "grey", {}),
            ("indexed", (grey // 4)[None], "indexed",
             {"colour_data": np.ascontiguousarray(palette.T).tobytes()}),
            ("cmyk", rgb_planes(np.concatenate([rgb, grey[..., None]], -1)), "CMYK", {}),
            ("lab", rgb_planes(rgb), "Lab", {}),
            ("duotone", grey[None], "duotone", {"colour_data": bytes(40)}),
            ("multichannel", np.stack([grey, grey // 2]), "multichannel", {})):
        for compression in (0, 1):
            out[f"psd_{name}_{'packbits' if compression else 'raw'}.psd"] = write_psd(
                planes, colour, compression=compression, resources=resources,
                layers=psd_layers(), **extra)
    bitmap = np.packbits(grey > 120, axis=1)
    out["psd_bitmap_packbits.psd"] = write_psd(bitmap[None], "bitmap", bits=1, width=34)
    # QOI: PIL's writer and the reference encoder, RGB and RGBA.
    rgba = np.concatenate([rgb, grey[..., None]], -1)
    out["qoi_rgb.qoi"] = _pil_bytes(Image.fromarray(rgb), "QOI")
    out["qoi_rgba.qoi"] = qoi_encode(rgba)
    # SGI: verbatim and RLE, 8 and 16 bits, 1, 3 and 4 channels.
    wide = (rgb.astype(np.uint16) * 257 + rng.randint(0, 256, rgb.shape)).astype(np.uint16)
    for label, pixels in (("grey", grey), ("rgb", rgb), ("rgba", rgba)):
        out[f"sgi_{label}_rle.sgi"] = write_sgi(pixels, rle=True, share_rows=True)
    out["sgi_rgb16_rle.sgi"] = write_sgi(wide, bpc=2, rle=True)
    out["sgi_rgb16_verbatim.sgi"] = write_sgi(wide, bpc=2)
    out["sgi_pil_rgba.sgi"] = _pil_bytes(Image.fromarray(rgba), "SGI")
    # Sun: every depth; raw, RLE and RGB-order types; a colour map.
    out["sun_bilevel.ras"] = write_sun(grey > 120, 1)
    out["sun_grey4_map.ras"] = write_sun(grey // 16, 4, palette=palette[:16])
    out["sun_grey8_rle.ras"] = write_sun(grey, 8, kind=2)
    out["sun_bgr24.ras"] = write_sun(rgb, 24)
    out["sun_rgb32_type3.ras"] = write_sun(rgb, 32, kind=3)
    out["sun_map8_rle.ras"] = write_sun(grey // 4, 8, kind=2, palette=palette[:64])
    # DIB and DCX.
    out["dib_pil_rgb.dib"] = _pil_bytes(Image.fromarray(rgb), "DIB")
    out["dib_rle8.dib"] = write_dib(grey // 8, 8, compression=1, palette=palette[:32])
    out["dcx_two_pages.dcx"] = write_dcx([write_pcx(rgb, 8, 3), write_pcx(grey > 99, 1, 1)])
    # ICNS: run-length with masks, it32, PNG and JPEG 2000 entries.
    icon16, icon32 = scene(16, 16, seed=6), scene(32, 32, seed=7)
    mask16 = np.full((16, 16), 200, np.uint8).tobytes()
    out["icns_rle.icns"] = write_icns([(b"is32", icns_rgb(icon16, b"is32")), (b"s8mk", mask16),
                                       (b"il32", icns_rgb(icon32, b"il32")),
                                       (b"l8mk", bytes(1024))])
    icon128 = scene(128, 128, seed=8)
    out["icns_it32.icns"] = write_icns([(b"it32", icns_rgb(icon128, b"it32")),
                                        (b"t8mk", bytes(128 * 128))])
    out["icns_png.icns"] = write_icns([(b"icp6", _pil_bytes(Image.fromarray(
        scene(64, 64, seed=9)).convert("P"), "PNG")), (b"is32", icns_rgb(icon16, b"is32"))])
    out["icns_jp2.icns"] = write_icns([(b"icp6", _pil_bytes(Image.fromarray(
        scene(64, 64, seed=10)), "JPEG2000", irreversible=False))])
    # IM: PIL's writer and the types it does not write.
    image = Image.fromarray(rgb)
    for mode in ("1", "L", "P", "RGB", "RGBA", "CMYK", "YCbCr", "I", "F"):
        converted = image.convert(mode) if mode not in ("I", "F") else image.convert("L").convert(
            mode)
        out[f"im_pil_{mode.lower()}.im"] = _pil_bytes(converted, "IM")
    out["im_b4.im"] = write_im("B4 image", 34, 27, np.packbits(
        ((grey[::-1] // 16)[..., None] >> np.arange(3, -1, -1) & 1).reshape(27, -1), axis=1))
    out["im_rgb3.im"] = write_im("RGB3 image", 34, 27, np.stack(
        [rgb[::-1, :, 1], rgb[::-1, :, 0], rgb[::-1, :, 2]]).tobytes())
    out["im_float12.im"] = write_im("L*12 image", 34, 27, _im_bits(
        (grey.astype(np.int64) * 13)[::-1], 12))
    # MSP version 1 (PIL) and 2.
    out["msp_pil.msp"] = _pil_bytes(Image.fromarray(grey > 120), "MSP")
    out["msp_v2.msp"] = write_msp_v2(grey > 120, blank_rows=(3,))
    # XBM (PIL) and XPM.
    out["xbm_pil.xbm"] = _pil_bytes(Image.fromarray(grey > 120), "XBM")
    out["xbm_hotspot.xbm"] = write_xbm(grey < 90, hotspot=(3, 4), upper=True)
    colours = [b"#%02x%02x%02x" % tuple(c) for c in palette[:40].tolist()]
    out["xpm_palette.xpm"] = write_xpm(grey // 7, colours, extra_keys=b"s name ")
    many = [b"#%06x" % (k * 1021 % (1 << 24)) for k in range(300)]
    out["xpm_rgb_300_colours.xpm"] = write_xpm((grey.astype(np.int64) * 300) // 256, many,
                                              chars=2)
    return out


def _im_bits(values, bits) -> bytes:
    """Rows of ``bits``-bit values packed least significant bit first,
    each row padded to whole bytes (PIL's ``bit`` decoder's layout)."""
    out = bytearray()
    for row in np.asarray(values, np.int64):
        acc = count = 0
        for v in row.tolist():
            acc |= int(v) << count
            count += bits
            while count >= 8:
                out.append(acc & 255)
                acc >>= 8
                count -= 8
        if count:
            out.append(acc & 255)
    return bytes(out)


def large_fixtures(read=None) -> dict:
    """The golden scenes as PackBits RGB PSD and as QOI, scene 3 as raw PSD
    and RLE SGI, and the 640x480 photo as PackBits PSD: written at run time
    (``write_large``), not committed. ``read`` decodes a PNG or JPEG path
    to RGB (PIL by default; ``tools.read`` where PIL is missing)."""
    if read is None:
        read = _pil_read
    out = {}
    for k in range(12):
        image = read(os.path.join(GOLDEN, f"scene_{k:02d}.png"))
        out[f"scene_{k:02d}.psd"] = write_psd(rgb_planes(image), "RGB")
        out[f"scene_{k:02d}.qoi"] = qoi_encode(image)
    scene3 = read(os.path.join(GOLDEN, "scene_03.png"))
    out["scene_03_raw.psd"] = write_psd(rgb_planes(scene3), "RGB", compression=0)
    out["scene_03_rle.sgi"] = write_sgi(scene3, rle=True, share_rows=True)
    out["photo_640x480.psd"] = write_psd(rgb_planes(read(PHOTO)), "RGB")
    return out


def write_large(out_dir: str, read=None) -> dict:
    """``large_fixtures`` written into ``out_dir``: name -> path."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, blob in large_fixtures(read).items():
        paths[name] = os.path.join(out_dir, name)
        with open(paths[name], "wb") as f:
            f.write(blob)
    return paths


def _pil_read(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def pil_decode(blob: bytes) -> np.ndarray:
    """The oracle: ``np.array(PIL.Image.open(f).convert("RGB"))``."""
    from PIL import Image

    with Image.open(io.BytesIO(blob)) as image:
        return np.array(image.convert("RGB"))


def pil_hash(blob: bytes) -> dict:
    rgb = pil_decode(blob)
    return {"shape": list(rgb.shape), "decoded_sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(HERE, "..", "tests", "fixtures",
                                                      "rasters"))
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    hashes = {}
    for name, blob in small_fixtures().items():
        hashes[name] = pil_hash(blob)
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(blob)
        print(name, len(blob), "bytes", hashes[name]["shape"], hashes[name]["decoded_sha256"])
    # The large files are written where they are read; their own sha256
    # says the writers made the same bytes there.
    for name, blob in large_fixtures().items():
        hashes[name] = {**pil_hash(blob), "file_sha256": hashlib.sha256(blob).hexdigest(),
                        "written_at_run_time": True}
        print(name, len(blob), "bytes (not committed)", hashes[name]["decoded_sha256"])
    with open(os.path.join(args.out, "hashes.json"), "w") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
