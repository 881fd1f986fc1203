"""Write the data slice's image fixtures: ``python scripts/make_data_fixtures.py``
(needs PIL; run where PIL is installed, since the card's machine has none).

- ``tests/fixtures/progressive.jpg``: ``tests/fixtures/test_image.jpg``
  halved to 320x240 by PIL and saved by PIL as a progressive JPEG
  (quality 90, 4:2:0, a restart marker every 4 MCU rows);
- ``tests/fixtures/interlaced.png``: the word "Eventdock" cut from the same
  image and halved (42x220 RGB), written as an Adam7-interlaced 8-bit PNG
  by :func:`adam7_png` (PIL reads interlaced PNGs but does not write them),
  every scanline under a different one of the five filters.

It prints each file's size and the sha256 of PIL's RGB decode of it,
which ``chip_smoke.py`` and ``tests/test_torch_tools.py`` hold the port's
``tools.read`` to.
"""

from __future__ import annotations

import hashlib
import io
import os
import struct
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def filtered(rows, bpp, first_filter=0):
    """Scanlines of bytes, each with its filter byte: filter types cycle
    0-4 from ``first_filter``; the first line's prior line is zeros."""
    out = []
    prior = np.zeros(rows.shape[1], np.int64)
    for r, row in enumerate(rows.astype(np.int64)):
        kind = (first_filter + r) % 5
        line = bytearray()
        for i, x in enumerate(row):
            a = int(row[i - bpp]) if i >= bpp else 0
            b = int(prior[i])
            c = int(prior[i - bpp]) if i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[kind]
            line.append((int(x) - pred) & 0xFF)
        out.append(bytes([kind]) + bytes(line))
        prior = row
    return b"".join(out)


def adam7_png(image):
    """An (H, W, 3) uint8 image as an Adam7-interlaced 8-bit RGB PNG."""
    height, width = image.shape[:2]
    data = b"".join(
        filtered(image[y0::dy, x0::dx].reshape(len(range(y0, height, dy)), -1), 3, index)
        for index, (x0, y0, dx, dy) in enumerate(ADAM7)
        if x0 < width and y0 < height)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 1))
            + _chunk(b"IDAT", zlib.compress(data, 9)) + _chunk(b"IEND", b""))


def main() -> int:
    from PIL import Image

    source = Image.open(os.path.join(FIXTURES, "test_image.jpg")).convert("RGB")
    half = source.resize((320, 240), Image.BILINEAR)
    buffer = io.BytesIO()
    half.save(buffer, "JPEG", quality=90, subsampling=2, progressive=True,
              restart_marker_rows=4)
    word = np.asarray(source.crop((160, 215, 600, 300)).resize((220, 42), Image.BILINEAR))
    files = {"progressive.jpg": buffer.getvalue(), "interlaced.png": adam7_png(word)}
    for name, blob in files.items():
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(blob)
        decoded = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
        print(f"tests/fixtures/{name}: {len(blob)} bytes, {decoded.shape}, sha256 of PIL's "
              f"RGB decode {hashlib.sha256(decoded.tobytes()).hexdigest()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
