"""Host image utilities the pipeline needs: ``read`` and ``pad``.

Counterparts of ``keras_ocr_tpu/tools.py:read`` and ``:pad`` with numpy
and the standard library only: PNG files are decoded by a small reader
(8-bit RGB or RGBA, not interlaced).
"""

from __future__ import annotations

import os
import struct
import typing
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter(raw: bytes, height: int, width: int, channels: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (PNG spec, section 9)."""
    stride = width * channels
    data = np.frombuffer(raw, dtype=np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), dtype=np.uint8)
    prior = np.zeros(stride, dtype=np.int32)
    for row in range(height):
        kind = data[row, 0]
        line = data[row, 1:].astype(np.int32)
        if kind == 0:
            recon = line
        elif kind == 1:  # Sub: serial dependency along the row
            recon = line.copy()
            for i in range(channels, stride):
                recon[i] = (recon[i] + recon[i - channels]) & 0xFF
        elif kind == 2:  # Up
            recon = (line + prior) & 0xFF
        elif kind == 3:  # Average
            recon = line.copy()
            for i in range(stride):
                left = recon[i - channels] if i >= channels else 0
                recon[i] = (recon[i] + ((left + prior[i]) >> 1)) & 0xFF
        elif kind == 4:  # Paeth
            recon = line.copy()
            for i in range(stride):
                a = recon[i - channels] if i >= channels else 0
                b = prior[i]
                c = prior[i - channels] if i >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                recon[i] = (recon[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {kind} in row {row}")
        out[row] = recon
        prior = recon
    return out


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit RGB/RGBA non-interlaced PNG into (H, W, 3) uint8."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path!r} is not a PNG file")
    pos = 8
    header = None
    idat = []
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        body = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path!r} has no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    channels = {2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace != 0:
        raise NotImplementedError(
            f"{path!r}: only 8-bit RGB/RGBA non-interlaced PNG is supported "
            f"(depth {depth}, colour type {color}, interlace {interlace})"
        )
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width, channels)
    image = pixels.reshape(height, width, channels)
    if channels == 4:
        # PIL's RGBA -> RGB conversion drops alpha.
        image = image[..., :3]
    return np.ascontiguousarray(image)


def read(filepath_or_array: typing.Union[str, np.ndarray]) -> np.ndarray:
    """An ndarray as is, or a PNG path decoded to RGB uint8."""
    if isinstance(filepath_or_array, np.ndarray):
        return filepath_or_array
    if isinstance(filepath_or_array, str):
        if not os.path.isfile(filepath_or_array):
            raise FileNotFoundError(f"Could not find image at path: {filepath_or_array}")
        return read_png(filepath_or_array)
    raise ValueError(f"Unsupported input type: {type(filepath_or_array)}")


def pad(image, width: int, height: int, cval: int = 255):
    """Bottom/right-pad an image up to (height, width) with ``cval``."""
    src_h, src_w = image.shape[:2]
    if src_h > height or src_w > width:
        raise ValueError(
            f"Cannot pad a ({src_h}, {src_w}) image to smaller ({height}, {width})."
        )
    canvas = np.full((height, width) + image.shape[2:], cval, dtype=image.dtype)
    canvas[:src_h, :src_w] = image
    return canvas
