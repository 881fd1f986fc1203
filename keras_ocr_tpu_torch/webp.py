"""WebP decoding for :func:`keras_ocr_tpu_torch.tools.read`.

JAX's ``tools.read`` is PIL's ``Image.open(f).convert("RGB")``
(``keras_ocr_tpu/tools.py``), and PIL opens WebP through libwebp's
animation decoder. :func:`decode_webp` gives the same pixels, bit for bit,
with numpy and the standard library only:

* the RIFF container: simple ``VP8 `` and ``VP8L`` files, and ``VP8X``
  files with ``ICCP``, ``EXIF`` and ``XMP `` chunks (skipped: ``convert``
  applies no profile), an ``ALPH`` chunk before a ``VP8 `` frame (read
  only under the alpha flag, as libwebp's demuxer reads it), and
  animations (``ANIM`` + ``ANMF``), of which the first frame is read as
  the animation decoder gives it: on a canvas cleared to transparent
  black, at twice the frame's offsets, without blending;
* VP8L, the lossless format: the predictor (14 modes), colour and
  subtract-green transforms and colour indexing (1, 2, 4 or 8 bits a
  pixel), prefix codes (simple and normal, with the ``max_symbol``
  field), meta prefix codes, LZ77 backward references through the 120
  plane codes, and the colour cache;
* VP8, the lossy format (RFC 6386 key frames, as libwebp decodes them):
  segments, 1-8 token partitions, the 16x16, 4x4 and chroma intra modes
  predicted from the unfiltered reconstruction, libwebp's inverse DCT and
  WHT, the simple and the normal loop filter, and YUV to RGB through
  libwebp's "fancy" 4:2:0 upsampler and its 14-bit fixed-point colour;
* ``ALPH``: raw or VP8L-coded alpha and its horizontal, vertical and
  gradient unfilters, decoded in full so that a corrupt plane raises, then
  dropped: PIL's RGBA is not premultiplied, so ``convert("RGB")`` keeps
  the colour the stream codes under transparent pixels.

A truncated or corrupt file raises ``ValueError``, as do the fourccs at
bytes 12:16 that PIL does not identify and VP8 frames that are not key
frames. The boolean decoder and the VP8L pixel loop run in Python over
ints; the transforms, the loop filter (by waves of macroblocks that do
not touch), the upsampler and the colour conversion run in numpy.
"""

from __future__ import annotations

import struct

import numpy as np

# Features the decoders reached, by name: the tests' coverage hook.
_SEEN: set = set()

_FOURCCS = (b"VP8 ", b"VP8L", b"VP8X")
_ANIMATION_FLAG = 0x02
_ALPHA_FLAG = 0x10
_VALID_FLAGS = 0x3E  # ICCP, alpha, EXIF, XMP and animation


def _le24(data: bytes, offset: int) -> int:
    return data[offset] | data[offset + 1] << 8 | data[offset + 2] << 16


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


# ---------------------------------------------------------------------------
# Container
# ---------------------------------------------------------------------------


def _chunk_list(blob: bytes, start: int, end: int, name: str) -> list:
    """(fourcc, payload offset, payload size) of each chunk in
    ``blob[start:end]``; a chunk whose padded payload runs past ``end``,
    or a tail too short for a chunk header, raises."""
    chunks = []
    pos = start
    while pos < end:
        if end - pos < 8:
            raise ValueError(f"{name}: WebP chunk header cut short at byte {pos}")
        fourcc = blob[pos:pos + 4]
        size = struct.unpack_from("<I", blob, pos + 4)[0]
        if size + (size & 1) > end - pos - 8:
            raise ValueError(f"{name}: WebP chunk {fourcc!r} runs past the end of its file")
        chunks.append((fourcc, pos + 8, size))
        pos += 8 + size + (size & 1)
    return chunks


def _padded(blob: bytes, offset: int, size: int) -> bytes:
    # libwebp's demuxer hands a frame's chunks to the decoder with their
    # padding byte, so a bitstream may read it.
    return blob[offset:offset + size + (size & 1)]


def _frame(blob: bytes, chunks: list, use_alpha: bool, name: str):
    """One frame's RGB (H, W, 3) and alpha (H, W) uint8, alpha None
    without an ``ALPH`` chunk: an optional ``ALPH`` chunk, then a
    ``VP8 `` or ``VP8L`` chunk, first in ``chunks``."""
    alpha = None
    if chunks and chunks[0][0] == b"ALPH":
        alpha = chunks[0] if use_alpha else None
        chunks = chunks[1:]
    if not chunks or chunks[0][0] not in (b"VP8 ", b"VP8L"):
        raise ValueError(f"{name}: a WebP frame without a VP8 or VP8L bitstream")
    fourcc, offset, size = chunks[0]
    data = _padded(blob, offset, size)
    if fourcc == b"VP8L":
        if alpha is not None:
            raise ValueError(f"{name}: an ALPH chunk before a VP8L bitstream")
        argb = _decode_vp8l(data, name)
        rgba = np.stack([argb >> 16, argb >> 8, argb, argb >> 24], axis=-1) & 0xFF
        return rgba[..., :3].astype(np.uint8), rgba[..., 3].astype(np.uint8)
    planes, width, height = _decode_vp8(data, size, name)
    if alpha is not None:
        alpha = _decode_alpha(blob[alpha[1]:alpha[1] + alpha[2]], width, height, name)
    return _yuv_to_rgb(*planes, width, height), alpha


def _decode_rgba(blob: bytes, name: str = "image") -> np.ndarray:
    """A WebP file's first frame as (H, W, 4) uint8 RGBA, not
    premultiplied, alpha 255 where the file has none: what libwebp's
    animation decoder gives PIL."""
    blob = bytes(blob)
    if len(blob) < 12 or blob[:4] != b"RIFF" or blob[8:12] != b"WEBP":
        raise ValueError(f"{name} is not a WebP file")
    if blob[12:16] not in _FOURCCS:
        raise ValueError(f"{name}: a WebP file whose first chunk is {blob[12:16]!r}, which "
                         f"PIL does not identify (it takes VP8, VP8L and VP8X)")
    riff_end = struct.unpack_from("<I", blob, 4)[0] + 8
    if riff_end < 16 or len(blob) < max(riff_end, 20):
        raise ValueError(f"{name}: a WebP file cut short ({len(blob)} bytes of {riff_end})")
    chunks = _chunk_list(blob, 12, riff_end, name)
    fourcc, offset, size = chunks[0]
    x0 = y0 = 0
    if fourcc != b"VP8X":
        _SEEN.add("container.simple")
        rgb, alpha = _frame(blob, chunks[:1], False, name)
        canvas_h, canvas_w = rgb.shape[:2]
    else:
        if size < 10:
            raise ValueError(f"{name}: a VP8X chunk of {size} bytes")
        flags = blob[offset]
        canvas_w, canvas_h = 1 + _le24(blob, offset + 4), 1 + _le24(blob, offset + 7)
        if flags & ~_VALID_FLAGS & 0xFF:
            raise ValueError(f"{name}: VP8X flags {flags:#04x} set reserved bits")
        rest = chunks[1:]
        _SEEN.add("container.vp8x")
        for fourcc, _, _ in rest:
            if fourcc in (b"ICCP", b"EXIF", b"XMP "):
                _SEEN.add("container." + fourcc.decode().strip().lower())
            elif fourcc == b"VP8X":
                raise ValueError(f"{name}: a second VP8X chunk")
        if flags & _ANIMATION_FLAG:
            rgb, alpha, x0, y0 = _first_frame(blob, rest, name)
        else:
            images = [i for i, c in enumerate(rest) if c[0] in (b"ALPH", b"VP8 ", b"VP8L")]
            if not images:
                raise ValueError(f"{name}: a VP8X file without an image")
            first = images[0]
            if any(c[0] == b"ANIM" for c in rest[:first]):
                raise ValueError(f"{name}: a still VP8X image after an ANIM chunk")
            after = first + (2 if rest[first][0] == b"ALPH" else 1)
            if any(c[0] in (b"ALPH", b"VP8 ", b"VP8L") for c in rest[after:]):
                raise ValueError(f"{name}: a still VP8X file with more than one image")
            rgb, alpha = _frame(blob, rest[first:after], bool(flags & _ALPHA_FLAG), name)
            if rgb.shape[:2] != (canvas_h, canvas_w):
                raise ValueError(f"{name}: a {rgb.shape[1]}x{rgb.shape[0]} image on a "
                                 f"{canvas_w}x{canvas_h} VP8X canvas")
    height, width = rgb.shape[:2]
    if x0 + width > canvas_w or y0 + height > canvas_h:
        raise ValueError(f"{name}: a {width}x{height} frame at ({x0}, {y0}) past its "
                         f"{canvas_w}x{canvas_h} canvas")
    # The animation decoder clears the canvas to transparent black and
    # draws frame 1, a key frame, without blending.
    canvas = np.zeros((canvas_h, canvas_w, 4), np.uint8)
    canvas[y0:y0 + height, x0:x0 + width, :3] = rgb
    canvas[y0:y0 + height, x0:x0 + width, 3] = 255 if alpha is None else alpha
    return canvas


def _first_frame(blob: bytes, rest: list, name: str):
    """An animation's first frame: (RGB, alpha, x, y) of the first
    ``ANMF`` chunk, at twice its stored offsets; every ``ANMF`` chunk's
    inner chunks must fit it."""
    _SEEN.add("container.animation")
    anim = [i for i, c in enumerate(rest) if c[0] == b"ANIM"]
    frames = [i for i, c in enumerate(rest) if c[0] == b"ANMF"]
    if not anim or rest[anim[0]][2] < 6 or not frames or frames[0] < anim[0]:
        raise ValueError(f"{name}: an animated WebP file without ANIM before its frames")
    if any(c[0] in (b"ALPH", b"VP8 ", b"VP8L") for c in rest):
        raise ValueError(f"{name}: an animated WebP file with an image outside its frames")
    inner = []  # each frame's chunks, after its 16-byte header
    for index in frames:
        _, offset, size = rest[index]
        if size < 16:
            raise ValueError(f"{name}: an ANMF chunk of {size} bytes")
        inner.append(_chunk_list(blob, offset + 16, offset + size, name))
    offset = rest[frames[0]][1]
    rgb, alpha = _frame(blob, inner[0][:2], True, name)
    return rgb, alpha, 2 * _le24(blob, offset), 2 * _le24(blob, offset + 3)


def decode_webp(blob: bytes, name: str = "image") -> np.ndarray:
    """A WebP file's bytes as (H, W, 3) uint8 RGB, as PIL's
    ``Image.open(f).convert("RGB")`` gives it (the first frame of an
    animation)."""
    return np.ascontiguousarray(_decode_rgba(blob, name)[..., :3])


# ---------------------------------------------------------------------------
# VP8L: the lossless format
# ---------------------------------------------------------------------------


class _BitReader:
    """VP8L's bits, least significant first. Reading past the end reads
    zeros; :meth:`check` raises once more bits were read than the stream
    holds (libwebp's end of stream, whose window is at least 64 bits)."""

    __slots__ = ("data", "pos", "value", "nbits", "limit", "name")

    def __init__(self, data: bytes, name: str):
        self.data, self.name = data, name
        self.pos = self.value = self.nbits = 0
        self.limit = 8 * max(len(data), 8)

    def fill(self, n: int):
        """At least ``n`` (at most 64) bits in ``value``."""
        if self.nbits < n:
            self.value |= int.from_bytes(self.data[self.pos:self.pos + 8], "little") << self.nbits
            self.pos += 8
            self.nbits += 64

    def read(self, n: int) -> int:
        self.fill(n)
        out = self.value & ((1 << n) - 1)
        self.value >>= n
        self.nbits -= n
        return out

    def symbol(self, code) -> int:
        table, mask = code
        self.fill(15)
        entry = table[self.value & mask]
        self.value >>= entry & 15
        self.nbits -= entry & 15
        return entry >> 4

    def check(self):
        if 8 * self.pos - self.nbits > self.limit:
            raise ValueError(f"{self.name}: the VP8L bitstream ends early")


_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# The WebP lossless specification's distance map: (dx, dy) of plane codes
# 1-120, a distance dx + dy * width, at least 1.
_PLANE_CODES = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2),
    (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3),
    (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4),
    (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2),
    (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
    (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7),
)


def _prefix_code(lengths, name: str):
    """(table, mask) of a canonical prefix code read LSB first: ``table[bits
    & mask]`` is ``symbol << 4 | length``. A code of one used symbol reads
    no bits; any other code must be complete."""
    used = sorted((length, symbol) for symbol, length in enumerate(lengths) if length)
    if not used:
        raise ValueError(f"{name}: a VP8L prefix code without symbols")
    if len(used) == 1:
        return [used[0][1] << 4], 0
    longest = used[-1][0]
    if sum(1 << (longest - length) for length, _ in used) != 1 << longest:
        raise ValueError(f"{name}: an incomplete or over-subscribed VP8L prefix code")
    size = 1 << longest
    table = [0] * size
    code, last = 0, used[0][0]
    for length, symbol in used:
        code <<= length - last
        last = length
        reverse = int(format(code, f"0{length}b")[::-1], 2)
        table[reverse::1 << length] = [symbol << 4 | length] * (size >> length)
        code += 1
    return table, size - 1


def _code_lengths(br: _BitReader, code_length_lengths, count: int, name: str) -> list:
    code = _prefix_code(code_length_lengths, name)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > count:
            raise ValueError(f"{name}: a VP8L max_symbol past its alphabet")
    else:
        max_symbol = count
    lengths = [0] * count
    symbol, previous = 0, 8
    while symbol < count and max_symbol > 0:
        max_symbol -= 1
        length = br.symbol(code)
        if length < 16:
            lengths[symbol] = length
            symbol += 1
            if length:
                previous = length
            continue
        _SEEN.add(f"vp8l.code_length_code.{length}")
        extra, offset = ((2, 3), (3, 3), (7, 11))[length - 16]
        repeat = br.read(extra) + offset
        if symbol + repeat > count:
            raise ValueError(f"{name}: a VP8L code-length repeat past its alphabet")
        lengths[symbol:symbol + repeat] = [previous if length == 16 else 0] * repeat
        symbol += repeat
    return lengths


def _read_code(br: _BitReader, count: int, name: str):
    if br.read(1):  # a simple code: one or two symbols of length 1
        symbols = br.read(1) + 1
        _SEEN.add(f"vp8l.simple_code.{symbols}")
        lengths = [0] * count
        first = br.read(8 if br.read(1) else 1)
        if first < count:
            lengths[first] = 1
        if symbols == 2:
            second = br.read(8)
            if second < count:
                lengths[second] = 1
    else:
        code_length_lengths = [0] * 19
        for index in range(br.read(4) + 4):
            code_length_lengths[_CODE_LENGTH_ORDER[index]] = br.read(3)
        lengths = _code_lengths(br, code_length_lengths, count, name)
    br.check()
    return _prefix_code(lengths, name)


def _entropy_image(br: _BitReader, width: int, height: int, meta_codes: bool,
                   name: str) -> list:
    """The ARGB ints of one entropy-coded image: its colour cache, its
    prefix codes (meta codes only where ``meta_codes``) and its pixels."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"{name}: a VP8L colour cache of {cache_bits} bits")
        _SEEN.add("vp8l.color_cache")
    meta, meta_bits, meta_width = [0], 30, 1
    if meta_codes and br.read(1):
        _SEEN.add("vp8l.meta_codes")
        meta_bits = br.read(3) + 2
        meta_width = _subsample(width, meta_bits)
        image = _entropy_image(br, meta_width, _subsample(height, meta_bits), False, name)
        meta = [(argb >> 8) & 0xFFFF for argb in image]
    sizes = (280 + (1 << cache_bits if cache_bits else 0), 256, 256, 256, 40)
    groups = []
    for _ in range(max(meta) + 1):
        group = ()
        for size in sizes:
            group += _read_code(br, size, name)
        groups.append(group)
    pixels = _pixels(br, width, height, groups, meta, meta_bits, meta_width, cache_bits)
    br.check()
    return pixels


def _pixels(br, width, height, groups, meta, meta_bits, meta_width, cache_bits):
    """The LZ77 and colour-cache decode loop (libwebp's DecodeImageData):
    green, red, blue, alpha literals, backward references and cache hits;
    the group is fetched again whenever x enters a new block, and after
    every backward reference."""
    total = width * height
    out = [0] * total
    data, pos, value, nbits = br.data, br.pos, br.value, br.nbits
    mask = (1 << meta_bits) - 1
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    plane = [dx + dy * width for dx, dy in _PLANE_CODES]
    i = x = y = 0
    fetch = True
    while i < total:
        if fetch or not x & mask:
            (gt, gm, rt, rm, bt, bm, at, am, dt, dm) = groups[
                meta[(y >> meta_bits) * meta_width + (x >> meta_bits)]]
            fetch = False
        if nbits < 64:
            value |= int.from_bytes(data[pos:pos + 8], "little") << nbits
            pos += 8
            nbits += 64
        entry = gt[value & gm]
        value >>= entry & 15
        nbits -= entry & 15
        code = entry >> 4
        if code < 256:
            entry = rt[value & rm]
            value >>= entry & 15
            red = entry >> 4
            nbits -= entry & 15
            entry = bt[value & bm]
            value >>= entry & 15
            blue = entry >> 4
            nbits -= entry & 15
            entry = at[value & am]
            value >>= entry & 15
            nbits -= entry & 15
            argb = (entry >> 4) << 24 | red << 16 | code << 8 | blue
        elif code < 280:
            symbol = code - 256
            if symbol < 4:
                length = symbol + 1
            else:
                extra = (symbol - 2) >> 1
                length = ((2 + (symbol & 1)) << extra) + (value & ((1 << extra) - 1)) + 1
                value >>= extra
                nbits -= extra
            entry = dt[value & dm]
            value >>= entry & 15
            nbits -= entry & 15
            symbol = entry >> 4
            if symbol < 4:
                distance = symbol + 1
            else:
                extra = (symbol - 2) >> 1
                distance = ((2 + (symbol & 1)) << extra) + (value & ((1 << extra) - 1)) + 1
                value >>= extra
                nbits -= extra
            if distance > 120:
                distance -= 120
            else:
                distance = max(plane[distance - 1], 1)
            if distance > i or i + length > total:
                raise ValueError(f"{br.name}: a VP8L backward reference outside its image")
            if distance >= length:
                out[i:i + length] = out[i - distance:i - distance + length]
            else:
                out[i:i + length] = (out[i - distance:i] * (length // distance + 1))[:length]
            if cache is not None:
                for argb in out[i:i + length]:
                    cache[((argb * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = argb
            i += length
            x += length
            while x >= width:
                x -= width
                y += 1
            fetch = True
            continue
        else:
            argb = cache[code - 280]
        out[i] = argb
        if cache is not None:
            cache[((argb * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = argb
        i += 1
        x += 1
        if x == width:
            x = 0
            y += 1
    br.pos, br.value, br.nbits = pos, value, nbits
    return out


def _add(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00
            | ((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _average(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _select(top: int, left: int, top_left: int) -> int:
    score = 0
    for s in (24, 16, 8, 0):
        t, l, c = (top >> s) & 0xFF, (left >> s) & 0xFF, (top_left >> s) & 0xFF
        score += abs(l - c) - abs(t - c)
    return top if score <= 0 else left


def _clamp_full(left: int, top: int, top_left: int) -> int:
    out = 0
    for s in (24, 16, 8, 0):
        v = ((left >> s) & 0xFF) + ((top >> s) & 0xFF) - ((top_left >> s) & 0xFF)
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _clamp_half(left: int, top: int, top_left: int) -> int:
    average = _average(left, top)
    out = 0
    for s in (24, 16, 8, 0):
        a, b = (average >> s) & 0xFF, (top_left >> s) & 0xFF
        d = a - b
        v = a + (d // 2 if d >= 0 else -(-d // 2))  # C's division truncates
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


# The predictors of modes 0-13 from (left, top, top-left, top-right);
# modes 14 and 15 predict as mode 0, as libwebp's do.
_PREDICTORS = (
    lambda l, t, tl, tr: 0xFF000000,
    lambda l, t, tl, tr: l,
    lambda l, t, tl, tr: t,
    lambda l, t, tl, tr: tr,
    lambda l, t, tl, tr: tl,
    lambda l, t, tl, tr: _average(_average(l, tr), t),
    lambda l, t, tl, tr: _average(l, tl),
    lambda l, t, tl, tr: _average(l, t),
    lambda l, t, tl, tr: _average(tl, t),
    lambda l, t, tl, tr: _average(t, tr),
    lambda l, t, tl, tr: _average(_average(l, tl), _average(t, tr)),
    lambda l, t, tl, tr: _select(t, l, tl),
    lambda l, t, tl, tr: _clamp_full(l, t, tl),
    lambda l, t, tl, tr: _clamp_half(l, t, tl),
)
_PREDICTORS += (_PREDICTORS[0], _PREDICTORS[0])


def _unpredict(px: list, width: int, height: int, bits: int, modes: list) -> list:
    """The predictor transform undone in place, in raster order: the top
    left pixel by mode 0, the rest of the top row by L, the left column by
    T, the rest by each tile's mode. A pixel of the rightmost column takes
    the leftmost pixel of its own row as its top-right."""
    px[0] = _add(px[0], 0xFF000000)
    for i in range(1, width):
        px[i] = _add(px[i], px[i - 1])
    tiles = _subsample(width, bits)
    used = set()
    for y in range(1, height):
        row = y * width
        px[row] = _add(px[row], px[row - width])
        tile_row = (y >> bits) * tiles
        x = 1
        while x < width:
            mode = (modes[tile_row + (x >> bits)] >> 8) & 15
            used.add(mode)
            predict = _PREDICTORS[mode]
            end = min(((x >> bits) + 1) << bits, width)
            for i in range(row + x, row + end):
                up = i - width
                px[i] = _add(px[i], predict(px[i - 1], px[up], px[up - 1], px[up + 1]))
            x = end
    _SEEN.update(f"vp8l.predictor.{mode}" for mode in used)
    return px


def _int8(values: np.ndarray) -> np.ndarray:
    return ((values & 0xFF) ^ 0x80).astype(np.int32) - 0x80


def _tile_map(data: list, width: int, height: int, bits: int) -> np.ndarray:
    tiles = np.array(data, np.int64).reshape(_subsample(height, bits), _subsample(width, bits))
    return np.repeat(np.repeat(tiles, 1 << bits, 0), 1 << bits, 1)[:height, :width]


def _vp8l_image(br: _BitReader, width: int, height: int, name: str) -> np.ndarray:
    """A VP8L image stream (after the header): its transforms, its
    entropy-coded image, the transforms undone in reverse order. ARGB as
    (height, width) int64."""
    transforms, seen, coded_width = [], 0, width
    while br.read(1):
        kind = br.read(2)
        if seen >> kind & 1:
            raise ValueError(f"{name}: a VP8L transform used twice")
        seen |= 1 << kind
        _SEEN.add("vp8l.transform." + ("predictor", "color", "subtract_green",
                                       "color_indexing")[kind])
        if kind in (0, 1):
            bits = br.read(3) + 2
            data = _entropy_image(br, _subsample(coded_width, bits),
                                  _subsample(height, bits), False, name)
            transforms.append((kind, coded_width, bits, data))
        elif kind == 3:
            colours = br.read(8) + 1
            bits = 3 if colours <= 2 else 2 if colours <= 4 else 1 if colours <= 16 else 0
            palette = _entropy_image(br, colours, 1, False, name)
            transforms.append((kind, coded_width, bits, palette))
            coded_width = _subsample(coded_width, bits)
        else:
            transforms.append((kind, coded_width, 0, None))
    pixels = _entropy_image(br, coded_width, height, True, name)
    for kind, out_width, bits, data in reversed(transforms):
        if kind == 0:
            if not isinstance(pixels, list):
                pixels = pixels.reshape(-1).tolist()
            pixels = _unpredict(pixels, out_width, height, bits, data)
            continue
        argb = np.array(pixels, np.int64).reshape(height, -1)
        if kind == 1:  # the colour transform; red_to_blue takes the new red
            codes = _tile_map(data, out_width, height, bits)
            green = _int8(argb >> 8)
            red = ((argb >> 16) + ((_int8(codes) * green) >> 5)) & 0xFF
            blue = argb + ((_int8(codes >> 8) * green) >> 5)
            blue = (blue + ((_int8(codes >> 16) * _int8(red)) >> 5)) & 0xFF
            pixels = (argb & 0xFF00FF00) | red << 16 | blue
        elif kind == 2:  # subtract green
            green = (argb >> 8) & 0xFF
            pixels = ((argb & 0xFF00FF00) | (((argb >> 16) + green) & 0xFF) << 16
                      | ((argb + green) & 0xFF))
        else:  # colour indexing: bytewise deltas, indices past the palette 0
            _SEEN.add(f"vp8l.index_bits.{8 >> bits}")
            colour_map = [0] * (1 << (8 >> bits))
            colour_map[0] = data[0]
            for index in range(1, len(data)):
                colour_map[index] = _add(data[index], colour_map[index - 1])
            colour_map = np.array(colour_map, np.int64)
            index = (argb >> 8) & 0xFF
            if bits == 0:
                pixels = colour_map[index]
            else:
                per_byte, depth = 1 << bits, 8 >> bits
                out = np.empty((height, argb.shape[1] * per_byte), np.int64)
                for k in range(per_byte):
                    out[:, k::per_byte] = colour_map[(index >> (k * depth)) & ((1 << depth) - 1)]
                pixels = out[:, :out_width]
    return np.asarray(pixels, np.int64).reshape(height, width)


def _decode_vp8l(data: bytes, name: str) -> np.ndarray:
    """A ``VP8L`` chunk's payload as ARGB (height, width) int64."""
    if len(data) < 5 or data[0] != 0x2F:
        raise ValueError(f"{name}: a VP8L bitstream without its 0x2f signature")
    br = _BitReader(data, name)
    br.read(8)  # the signature
    width, height = br.read(14) + 1, br.read(14) + 1
    br.read(1)  # the alpha hint
    if br.read(3):
        raise ValueError(f"{name}: a VP8L bitstream of version other than 0")
    _SEEN.add("vp8l")
    return _vp8l_image(br, width, height, name)


# ---------------------------------------------------------------------------
# ALPH
# ---------------------------------------------------------------------------


def _unfilter(deltas: np.ndarray, method: int) -> np.ndarray:
    """libwebp's alpha unfilters (method 1 horizontal, 2 vertical, 3
    gradient ``clip(left + top - top_left)``), mod 256: the first row is
    horizontal from 0 in each; below it a row's first pixel comes from the
    pixel above."""
    if method == 0:
        return deltas
    d = deltas.astype(np.int64)
    out = np.empty_like(d)
    out[0] = np.cumsum(d[0]) & 0xFF
    if method == 1:
        first = np.cumsum(d[:, 0]) & 0xFF
        out[1:] = (np.cumsum(d[1:], axis=1) - d[1:, :1] + first[1:, None]) & 0xFF
    elif method == 2:
        out[1:] = (np.cumsum(d[1:], axis=0) + out[0]) & 0xFF
    else:
        for y in range(1, d.shape[0]):
            top = out[y - 1].tolist()
            left = top_left = top[0]
            row = []
            for t, delta in zip(top, d[y].tolist()):
                g = left + t - top_left
                left = (delta + (0 if g < 0 else 255 if g > 255 else g)) & 0xFF
                top_left = t
                row.append(left)
            out[y] = row
    return out.astype(np.uint8)


def _decode_alpha(data: bytes, width: int, height: int, name: str) -> np.ndarray:
    """An ``ALPH`` payload as (height, width) uint8, as libwebp decodes it
    (no dithering: PIL asks for none)."""
    if len(data) <= 1:
        raise ValueError(f"{name}: an ALPH chunk without data")
    header = data[0]
    compression, method, preprocessing = header & 3, (header >> 2) & 3, (header >> 4) & 3
    if compression > 1 or preprocessing > 1 or header >> 6:
        raise ValueError(f"{name}: an ALPH header {header:#04x} libwebp refuses")
    _SEEN.add(f"alph.compression.{compression}.filter.{method}")
    if compression == 0:
        if len(data) - 1 < width * height:
            raise ValueError(f"{name}: a raw ALPH plane cut short")
        deltas = np.frombuffer(data, np.uint8, width * height, 1).reshape(height, width)
    else:
        br = _BitReader(data[1:], name)
        deltas = ((_vp8l_image(br, width, height, name) >> 8) & 0xFF).astype(np.uint8)
    return _unfilter(deltas, method)


# ---------------------------------------------------------------------------
# VP8: the lossy format
# ---------------------------------------------------------------------------

# RFC 6386 section 14.1: dc_qlookup and ac_qlookup.
_DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
)
_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
)

# RFC 6386 section 13.5: default_coeff_probs[4][8][3][11], flattened.
_COEFF_PROBS = (
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
)

# RFC 6386 section 13.4: coeff_update_probs[4][8][3][11], flattened.
_COEFF_UPDATE_PROBS = (
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
)

# RFC 6386 section 11.5: kf_bmode_probs[above][left][9], flattened, with the
# modes in the order of _B_MODES (the RFC lists LD before RD and VR).
_BMODE_PROBS = (
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
)

# libwebp's order of the 4x4 modes, in which _BMODE_PROBS is indexed; the
# 16x16 and chroma modes DC, TM, V and H share the first four numbers.
_B_MODES = ("DC", "TM", "VE", "HE", "RD", "VR", "LD", "VL", "HD", "HU")
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
# RFC 6386 section 13.2: the extra bits of DCT categories 3-6.
_CATEGORY_PROBS = (
    (173, 148, 140),
    (176, 155, 140, 135),
    (180, 157, 141, 134, 130),
    (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129),
)
# For a range of 1-255 after a decision: the bits it is shifted by to reach
# 128-255, and libwebp's stored range (the shifted range less one).
_SHIFT = [0] + [8 - r.bit_length() for r in range(1, 256)]
_RANGE = [0] + [(r << (8 - r.bit_length())) - 1 for r in range(1, 256)]


class _BoolDecoder:
    """RFC 6386's boolean decoder as libwebp runs it: ``value >> bits`` is
    the 8-bit window, ``rng`` the range less one. ``eof`` is set when the
    window needs a byte past the partition's end (libwebp's condition for
    "premature end"), which then reads as zero."""

    __slots__ = ("data", "pos", "end", "value", "bits", "rng", "eof")

    def __init__(self, data: bytes, start: int, size: int):
        self.data, self.pos, self.end = data, start, start + size
        self.value, self.bits, self.rng, self.eof = 0, -8, 254, False
        self.load()

    def load(self):
        pos = self.pos
        if pos < self.end:
            count = min(7, self.end - pos)
            self.value = (self.value << (8 * count)
                          | int.from_bytes(self.data[pos:pos + count], "big"))
            self.pos = pos + count
            self.bits += 8 * count
        else:
            self.value <<= 8
            self.bits += 8
            self.eof = True

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self.load()
        split = (self.rng * prob) >> 8
        bits = self.bits
        if (self.value >> bits) > split:
            r = self.rng - split
            self.value -= (split + 1) << bits
            out = 1
        else:
            r = split + 1
            out = 0
        self.bits = bits - _SHIFT[r]
        self.rng = _RANGE[r]
        return out

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v


def _large_value(d: _BoolDecoder, p) -> int:
    """libwebp's GetLargeValue: a token of 2 or more (DCT_CAT1-6)."""
    bit = d.bit
    if not bit(p[3]):
        return 2 if not bit(p[4]) else 3 + bit(p[5])
    if not bit(p[6]):
        if not bit(p[7]):
            return 5 + bit(159)
        return 7 + 2 * bit(165) + bit(145)
    high = bit(p[8])
    category = 2 * high + bit(p[9 + high])
    _SEEN.add(f"vp8.dct_category.{category + 3}")
    v = 0
    for prob in _CATEGORY_PROBS[category]:
        v = v + v + bit(prob)
    return v + 3 + (8 << category)


def _tokens(d: _BoolDecoder, bands, ctx: int, dq, first: int, base: int, index, values) -> int:
    """One block's coefficients (libwebp's GetCoeffs): each non-zero one,
    dequantised, appended as (flat index, value); returns the position
    after the last coefficient read."""
    bit = d.bit
    n = first
    p = bands[n][ctx]
    while n < 16:
        if not bit(p[0]):
            return n  # end of block
        while not bit(p[1]):  # a zero
            n += 1
            if n == 16:
                return 16
            p = bands[n][0]
        if not bit(p[2]):
            v, p_next = 1, 1
        else:
            v, p_next = _large_value(d, p), 2
        index.append(base + _ZIGZAG[n])
        values.append((-v if bit(128) else v) * dq[n > 0])
        n += 1
        p = bands[n][p_next]
    return 16


def _frame_header(data: bytes, chunk_size: int, name: str):
    """A key frame's tag and start code (RFC 6386 section 9.1): the first
    partition's size, the width and the height."""
    if len(data) < 10:
        raise ValueError(f"{name}: a VP8 frame header cut short")
    tag = data[0] | data[1] << 8 | data[2] << 16
    if tag & 1:
        raise ValueError(f"{name}: a VP8 frame that is not a key frame")
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"{name}: a VP8 frame without its start code")
    width = (data[6] | data[7] << 8) & 0x3FFF  # the 2-bit scales are ignored
    height = (data[8] | data[9] << 8) & 0x3FFF
    first_size = tag >> 5
    if ((tag >> 1) & 7) > 3 or not (tag >> 4) & 1 or first_size >= chunk_size or not (
            width and height):
        raise ValueError(f"{name}: a VP8 frame header libwebp refuses")
    if first_size > len(data) - 10:
        raise ValueError(f"{name}: a VP8 first partition cut short")
    return first_size, width, height


def _partitions(data: bytes, start: int, count: int, name: str) -> list:
    """The token partitions after the first (section 9.5): the sizes of
    all but the last, each clipped to what is left; the last takes the
    rest and must not be empty."""
    left = len(data) - start
    if left < 3 * (count - 1):
        raise ValueError(f"{name}: VP8 partition sizes cut short")
    sizes_at = start
    start, left = start + 3 * (count - 1), left - 3 * (count - 1)
    out = []
    for p in range(count - 1):
        size = min(_le24(data, sizes_at + 3 * p), left)
        out.append(_BoolDecoder(data, start, size))
        start, left = start + size, left - size
    if left <= 0:
        raise ValueError(f"{name}: the last VP8 token partition is empty")
    out.append(_BoolDecoder(data, start, left))
    return out


def _frame_parameters(d: _BoolDecoder, name: str) -> dict:
    """The rest of the first partition's header: segments (section 9.3),
    the loop filter (9.6), the partition count, the quantisers (libwebp's
    VP8ParseQuant), the coefficient probabilities (13.4) and the skip
    probability."""
    bit = d.bit
    bit(128), bit(128)  # colour space and clamping type, unused
    use_segment = bit(128)
    update_map, absolute = 0, 1
    quantizer, strength, segment_probs = [0] * 4, [0] * 4, [255] * 3
    if use_segment:
        _SEEN.add("vp8.segments")
        update_map = bit(128)
        if bit(128):
            absolute = bit(128)
            quantizer = [d.signed(7) if bit(128) else 0 for _ in range(4)]
            strength = [d.signed(6) if bit(128) else 0 for _ in range(4)]
        if update_map:
            segment_probs = [d.literal(8) if bit(128) else 255 for _ in range(3)]
    simple, level, sharpness = bit(128), d.literal(6), d.literal(3)
    ref_delta = mode_delta = 0
    if bit(128) and bit(128):  # deltas in use, and updated
        deltas = [d.signed(6) if bit(128) else 0 for _ in range(8)]
        ref_delta, mode_delta = deltas[0], deltas[4]  # intra frame, B_PRED
    partition_count = 1 << d.literal(2)
    base_q = d.literal(7)
    dq = [d.signed(4) if bit(128) else 0 for _ in range(5)]
    quant, strengths = [], []
    for s in range(4):
        q = quantizer[s] + (0 if absolute else base_q) if use_segment else base_q

        def at(delta, top=127, q=q):
            return min(max(q + delta, 0), top)

        quant.append(((_DC_TABLE[at(dq[0])], _AC_TABLE[at(0)]),
                      (_DC_TABLE[at(dq[1])] * 2, max((_AC_TABLE[at(dq[2])] * 101581) >> 16, 8)),
                      (_DC_TABLE[at(dq[3], 117)], _AC_TABLE[at(dq[4])])))
        # libwebp's PrecomputeFilterStrengths: (limit, interior limit, hev
        # threshold) for a 16x16 and a 4x4 macroblock of this segment.
        base = strength[s] + (0 if absolute else level) if use_segment else level
        row = []
        for i4 in (0, 1):
            lvl = min(max(base + ref_delta + (mode_delta if i4 else 0), 0), 63)
            interior = lvl
            if sharpness:
                interior >>= 2 if sharpness > 4 else 1
                interior = min(interior, 9 - sharpness)
            interior = max(interior, 1)
            row.append((2 * lvl + interior if lvl else 0, interior,
                        2 if lvl >= 40 else 1 if lvl >= 15 else 0))
        strengths.append(row)
    bit(128)  # refresh_entropy_probs: one key frame, nothing to keep
    probs = list(_COEFF_PROBS)
    for k, update in enumerate(_COEFF_UPDATE_PROBS):
        if bit(update):
            probs[k] = d.literal(8)
    bands = [[[probs[((t * 8 + _BANDS[n]) * 3 + c) * 11:((t * 8 + _BANDS[n]) * 3 + c + 1) * 11]
               for c in range(3)] for n in range(17)] for t in range(4)]
    skip_prob = d.literal(8) if bit(128) else None
    filter_type = 0 if level == 0 else 1 if simple else 2
    return dict(use_segment=use_segment, update_map=update_map, segment_probs=segment_probs,
                level=level, sharpness=sharpness, filter_type=filter_type,
                partitions=partition_count, quant=quant, strengths=strengths, bands=bands,
                skip_prob=skip_prob)


def _intra_modes(d: _BoolDecoder, mb_w: int, p: dict, intra_top: list) -> list:
    """One macroblock row's headers from the first partition (libwebp's
    ParseIntraMode): (segment, skip, 4x4 modes or the 16x16 mode, chroma
    mode) per macroblock."""
    bit = d.bit
    seg_p, skip_p = p["segment_probs"], p["skip_prob"]
    intra_left = [0] * 4
    row = []
    for mx in range(mb_w):
        segment = ((2 + bit(seg_p[2]) if bit(seg_p[0]) else bit(seg_p[1]))
                   if p["update_map"] else 0)
        skip = bit(skip_p) if skip_p is not None else 0
        top = intra_top[4 * mx:4 * mx + 4]
        if bit(145):  # 16x16
            ymode = (1 if bit(128) else 3) if bit(156) else (2 if bit(163) else 0)
            intra_top[4 * mx:4 * mx + 4] = [ymode] * 4
            intra_left = [ymode] * 4
            modes = ymode
        else:
            modes = []
            for y in range(4):
                ymode = intra_left[y]
                for x in range(4):
                    prob = _BMODE_PROBS[(top[x] * 10 + ymode) * 9:(top[x] * 10 + ymode + 1) * 9]
                    if not bit(prob[0]):
                        ymode = 0
                    elif not bit(prob[1]):
                        ymode = 1
                    elif not bit(prob[2]):
                        ymode = 2
                    elif not bit(prob[3]):
                        ymode = (3 if not bit(prob[4]) else 4 if not bit(prob[5]) else 5)
                    else:
                        ymode = (6 if not bit(prob[6]) else 7 if not bit(prob[7]) else
                                 8 if not bit(prob[8]) else 9)
                    top[x] = ymode
                modes.extend(top)
                intra_left[y] = ymode
            intra_top[4 * mx:4 * mx + 4] = top
        uvmode = 0 if not bit(142) else 2 if not bit(114) else 1 if bit(183) else 3
        row.append((segment, skip, modes, uvmode))
    return row


def _residuals(d: _BoolDecoder, p: dict, segment: int, i16: bool, top: list, left: list,
               base: int, index: list, values: list) -> bool:
    """One macroblock's tokens (libwebp's ParseResiduals), with the
    non-zero contexts ``top`` and ``left`` (Y 0-3, U 4-5, V 6-7, Y2 8)
    updated; the coefficients go to ``index`` / ``values`` at ``base``
    (blocks 0-15 Y, 16-19 U, 20-23 V, 24 Y2). True if a block has a
    coefficient past its first position."""
    bands = p["bands"]
    y1, y2, uv = p["quant"][segment]
    ac = False
    if i16:
        nz = _tokens(d, bands[1], top[8] + left[8], y2, 0, base + 384, index, values)
        top[8] = left[8] = int(nz > 0)
        first, y_bands = 1, bands[0]
    else:
        first, y_bands = 0, bands[3]
    for y in range(4):
        l = left[y]
        for x in range(4):
            nz = _tokens(d, y_bands, l + top[x], y1, first, base + (4 * y + x) * 16, index, values)
            l = top[x] = int(nz > first)
            ac = ac or nz > 1
        left[y] = l
    for channel, block in ((4, 16), (6, 20)):
        for y in range(2):
            l = left[channel + y]
            for x in range(2):
                nz = _tokens(d, bands[2], l + top[channel + x], uv, 0,
                             base + (block + 2 * y + x) * 16, index, values)
                l = top[channel + x] = int(nz > 0)
                ac = ac or nz > 1
            left[channel + y] = l
    return ac


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(coeffs: np.ndarray) -> np.ndarray:
    """libwebp's TransformOne on (N, 16) coefficients: the (N, 4, 4)
    values added to the prediction, ``(x + 4) >> 3`` of the second pass."""
    c = coeffs.reshape(-1, 4, 4)
    r0, r1, r2, r3 = c[:, 0], c[:, 1], c[:, 2], c[:, 3]  # vertical pass, per column
    a, b = r0 + r2, r0 - r2
    cc, dd = _mul2(r1) - _mul1(r3), _mul1(r1) + _mul2(r3)
    t = np.stack([a + dd, b + cc, b - cc, a - dd], axis=1)  # (N, row, column)
    dc = t[:, :, 0] + 4
    a, b = dc + t[:, :, 2], dc - t[:, :, 2]
    cc, dd = _mul2(t[:, :, 1]) - _mul1(t[:, :, 3]), _mul1(t[:, :, 1]) + _mul2(t[:, :, 3])
    return np.stack([a + dd, b + cc, b - cc, a - dd], axis=2) >> 3


def _iwht(coeffs: np.ndarray) -> np.ndarray:
    """libwebp's TransformWHT on (N, 16) Y2 coefficients: the (N, 16) DCs
    of the sixteen Y blocks, in raster order, as int16."""
    c = coeffs.reshape(-1, 4, 4)
    a0, a1 = c[:, 0] + c[:, 3], c[:, 1] + c[:, 2]
    a2, a3 = c[:, 1] - c[:, 2], c[:, 0] - c[:, 3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=1)  # (N, row, column)
    dc = t[:, :, 0] + 3
    a0, a1 = dc + t[:, :, 3], t[:, :, 1] + t[:, :, 2]
    a2, a3 = t[:, :, 1] - t[:, :, 2], dc - t[:, :, 3]
    out = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=2) >> 3
    return out.reshape(-1, 16).astype(np.int16)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _predict4(mode: int, w: list, r: int, c: int) -> list:
    """The 16 predicted values (row by row) of the 4x4 block at ``w[r][c]``
    (libwebp's VP8PredLuma4): top A-D, top-right E-H, top-left X, left
    I-L."""
    above = w[r - 1]
    X, A, B, C, D, E, F, G, H = above[c - 1:c + 8]
    I, J, K, L = w[r][c - 1], w[r + 1][c - 1], w[r + 2][c - 1], w[r + 3][c - 1]
    if mode == 0:  # DC
        return [(A + B + C + D + I + J + K + L + 4) >> 3] * 16
    if mode == 1:  # TM
        out = []
        for v in (I, J, K, L):
            out += [min(max(v + t - X, 0), 255) for t in (A, B, C, D)]
        return out
    if mode == 2:  # VE
        return [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)] * 4
    if mode == 3:  # HE
        out = []
        for v in (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L)):
            out += [v] * 4
        return out
    if mode == 4:  # RD: by x - y
        e = (_avg3(J, K, L), _avg3(I, J, K), _avg3(X, I, J), _avg3(A, X, I),
             _avg3(B, A, X), _avg3(C, B, A), _avg3(D, C, B))
        return [e[3 + x - y] for y in range(4) for x in range(4)]
    if mode == 5:  # VR
        return [_avg2(X, A), _avg2(A, B), _avg2(B, C), _avg2(C, D),
                _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D),
                _avg3(J, I, X), _avg2(X, A), _avg2(A, B), _avg2(B, C),
                _avg3(K, J, I), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C)]
    if mode == 6:  # LD: by x + y
        e = (_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
             _avg3(E, F, G), _avg3(F, G, H), _avg3(G, H, H))
        return [e[x + y] for y in range(4) for x in range(4)]
    if mode == 7:  # VL
        return [_avg2(A, B), _avg2(B, C), _avg2(C, D), _avg2(D, E),
                _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
                _avg2(B, C), _avg2(C, D), _avg2(D, E), _avg3(E, F, G),
                _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F), _avg3(F, G, H)]
    if mode == 8:  # HD
        return [_avg2(I, X), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C),
                _avg2(J, I), _avg3(J, I, X), _avg2(I, X), _avg3(I, X, A),
                _avg2(K, J), _avg3(K, J, I), _avg2(J, I), _avg3(J, I, X),
                _avg2(L, K), _avg3(L, K, J), _avg2(K, J), _avg3(K, J, I)]
    # HU
    return [_avg2(I, J), _avg3(I, J, K), _avg2(J, K), _avg3(J, K, L),
            _avg2(J, K), _avg3(J, K, L), _avg2(K, L), _avg3(K, L, L),
            _avg2(K, L), _avg3(K, L, L), L, L,
            L, L, L, L]


def _predict_block(mode: int, top: np.ndarray, left: np.ndarray, corner: int, mx: int,
                   my: int) -> np.ndarray:
    """A 16x16 luma or 8x8 chroma prediction (DC, TM, V, H), DC taking
    only the edges inside the frame (libwebp's CheckMode)."""
    size = top.shape[0]
    shift = size.bit_length() - 1  # 4 for 16, 3 for 8
    if mode == 0:
        if mx and my:
            dc = (int(top.sum()) + int(left.sum()) + size) >> (shift + 1)
        elif my:  # the left column is outside the frame
            dc = (int(top.sum()) + size // 2) >> shift
        elif mx:  # the row above is
            dc = (int(left.sum()) + size // 2) >> shift
        else:
            dc = 128
        return np.full((size, size), dc, np.int32)
    if mode == 1:
        return np.clip(top[None, :] + left[:, None] - corner, 0, 255)
    if mode == 2:
        return np.broadcast_to(top[None, :], (size, size))
    return np.broadcast_to(left[:, None], (size, size))


_CLIP = [0] * 256 + list(range(256)) + [255] * 512  # index v + 256, v in [-256, 767]


def _reconstruct(mbs: list, residual: np.ndarray, mb_w: int, mb_h: int):
    """The unfiltered Y, U and V planes (libwebp's ReconstructRow): each
    plane has one more row above and one more column to the left, 127
    above the frame (its corner too) and 129 to its left; a 4x4 block
    takes its top-right from the macroblock above and to the right, or
    ``top[15]`` repeated on the last column; sub-block rows 1-3 of the
    last column reuse the macroblock's."""
    planes = []
    for size in (16, 8, 8):
        plane = np.zeros((size * mb_h + 1, size * mb_w + 1), np.int32)
        plane[0] = 127
        plane[1:, 0] = 129
        planes.append(plane)
    Y, U, V = planes
    modes4, modes16, modes_uv = set(), set(), set()
    for m, (segment, skip, modes, uvmode) in enumerate(mbs):
        my, mx = divmod(m, mb_w)
        r0, c0 = 16 * my + 1, 16 * mx + 1
        res = residual[m]
        if isinstance(modes, list):
            modes4.update(modes)
            above = Y[r0 - 1, c0 - 1:c0 + 16].tolist()
            if my == 0:
                above += [127] * 4
            elif mx == mb_w - 1:
                above += [above[16]] * 4
            else:
                above += Y[r0 - 1, c0 + 16:c0 + 20].tolist()
            w = [above] + [[v] + [0] * 20 for v in Y[r0:r0 + 16, c0 - 1].tolist()]
            for row in (4, 8, 12):
                w[row][17:21] = above[17:21]
            res_y = res[:16].tolist()
            for n in range(16):
                by, bx = divmod(n, 4)
                pred = _predict4(modes[n], w, 1 + 4 * by, 1 + 4 * bx)
                add = res_y[n]
                for i in range(4):
                    row = w[1 + 4 * by + i]
                    for j in range(4):
                        row[1 + 4 * bx + j] = _CLIP[pred[4 * i + j] + add[4 * i + j] + 256]
            Y[r0:r0 + 16, c0:c0 + 16] = [row[1:17] for row in w[1:]]
        else:
            modes16.add(modes)
            pred = _predict_block(modes, Y[r0 - 1, c0:c0 + 16], Y[r0:r0 + 16, c0 - 1],
                                  int(Y[r0 - 1, c0 - 1]), mx, my)
            blocks = res[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
            Y[r0:r0 + 16, c0:c0 + 16] = np.clip(pred + blocks, 0, 255)
        modes_uv.add(uvmode)
        r0, c0 = 8 * my + 1, 8 * mx + 1
        for plane, first in ((U, 16), (V, 20)):
            pred = _predict_block(uvmode, plane[r0 - 1, c0:c0 + 8], plane[r0:r0 + 8, c0 - 1],
                                  int(plane[r0 - 1, c0 - 1]), mx, my)
            blocks = res[first:first + 4].reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
            plane[r0:r0 + 8, c0:c0 + 8] = np.clip(pred + blocks, 0, 255)
    _SEEN.update(f"vp8.i4.{_B_MODES[m]}" for m in modes4)
    _SEEN.update(f"vp8.i16.{_B_MODES[m]}" for m in modes16)
    _SEEN.update(f"vp8.uv.{_B_MODES[m]}" for m in modes_uv)
    return Y[1:, 1:], U[1:, 1:], V[1:, 1:]


_TAPS = np.arange(-4, 4)


def _filter_lanes(buf: np.ndarray, q0: np.ndarray, step: np.ndarray, thresh: np.ndarray,
                  interior: np.ndarray, hev_thresh: np.ndarray, kind: str):
    """One edge filter on each lane (8 pixels across an edge, ``q0`` the
    first past it) of ``buf``, libwebp's C filters: ``kind`` is "simple"
    (DoFilter2 where NeedsFilter), "edge" (macroblock edges: DoFilter2
    where high edge variance, else DoFilter6) or "inner" (DoFilter4). The
    lanes of one call must not share pixels."""
    at = q0[:, None] + step[:, None] * _TAPS
    px = buf[at]
    p3, p2, p1, p0, q0v, q1, q2, q3 = px.T
    need = 4 * np.abs(p0 - q0v) + np.abs(p1 - q1) <= 2 * thresh + 1
    if kind != "simple":
        need &= ((np.abs(p3 - p2) <= interior) & (np.abs(p2 - p1) <= interior)
                 & (np.abs(p1 - p0) <= interior) & (np.abs(q3 - q2) <= interior)
                 & (np.abs(q2 - q1) <= interior) & (np.abs(q1 - q0v) <= interior))
        hev = (np.abs(p1 - p0) > hev_thresh) | (np.abs(q1 - q0v) > hev_thresh)
        two = need & hev
        rest = need & ~hev
    else:
        two, rest = need, None
    out = px.copy()
    sclip = np.clip(p1 - q1, -128, 127)
    a = 3 * (q0v - p0) + sclip
    a1 = np.clip((a + 4) >> 3, -16, 15)
    a2 = np.clip((a + 3) >> 3, -16, 15)
    out[:, 3] = np.where(two, np.clip(p0 + a2, 0, 255), out[:, 3])
    out[:, 4] = np.where(two, np.clip(q0v - a1, 0, 255), out[:, 4])
    if kind == "edge":
        a = np.clip(3 * (q0v - p0) + sclip, -128, 127)
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        for column, v in ((1, p2 + a3), (2, p1 + a2), (3, p0 + a1), (4, q0v - a1),
                          (5, q1 - a2), (6, q2 - a3)):
            out[:, column] = np.where(rest, np.clip(v, 0, 255), out[:, column])
    elif kind == "inner":
        a = 3 * (q0v - p0)
        a1 = np.clip((a + 4) >> 3, -16, 15)
        a2 = np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        for column, v in ((2, p1 + a3), (3, p0 + a2), (4, q0v - a1), (5, q1 - a3)):
            out[:, column] = np.where(rest, np.clip(v, 0, 255), out[:, column])
    buf[at] = out


# One macroblock's edges in libwebp's order: (vertical edge, offset in the
# macroblock, macroblock edge rather than inner edge).
_FILTER_PHASES = ((True, 0, True), (True, 4, False), (True, 8, False), (True, 12, False),
                  (False, 0, True), (False, 4, False), (False, 8, False), (False, 12, False))


def _loop_filter(planes, mb_w: int, mb_h: int, limit, interior, hev, inner, simple: bool):
    """libwebp's DoFilter over every macroblock in raster order: the left
    edge, the inner vertical edges, the top edge, the inner horizontal
    edges; macroblock edges with ``limit + 4``, inner edges (a 4x4
    macroblock, or one with coefficients) with ``limit``; chroma (the
    normal filter only) has one inner edge, at 4. Macroblock (x, y) waits
    for (x - 1, y) and (x + 1, y - 1), so the macroblocks of one wave
    x + 2y run together."""
    strides = (16 * mb_w, 8 * mb_w, 8 * mb_w)
    offsets = np.cumsum([0] + [plane.size for plane in planes[:2]])
    buf = np.concatenate([plane.ravel() for plane in planes]).astype(np.int64)
    limit, interior, hev, inner = (np.asarray(v, np.int64) for v in (limit, interior, hev, inner))
    for wave in range(mb_w + 2 * (mb_h - 1)):
        ys = np.arange(max(0, (wave - mb_w + 2) // 2), min(mb_h - 1, wave // 2) + 1)
        xs = wave - 2 * ys
        keep = limit[ys * mb_w + xs] > 0
        xs, ys = xs[keep], ys[keep]
        for vertical, offset, edge in _FILTER_PHASES:
            chosen = ((xs if vertical else ys) > 0) if edge else inner[ys * mb_w + xs] > 0
            if not chosen.any():
                continue
            x, y = xs[chosen], ys[chosen]
            m = y * mb_w + x
            q0s, steps, ms = [], [], []
            for plane in ((0,) if simple or offset not in (0, 4) else (0, 1, 2)):
                size = 16 if plane == 0 else 8
                lanes = np.arange(size)
                if vertical:
                    rows = (size * y)[:, None] + lanes
                    cols = np.broadcast_to((size * x + offset)[:, None], rows.shape)
                else:
                    cols = (size * x)[:, None] + lanes
                    rows = np.broadcast_to((size * y + offset)[:, None], cols.shape)
                q0s.append((offsets[plane] + rows * strides[plane] + cols).ravel())
                steps.append(np.full(rows.size, 1 if vertical else strides[plane], np.int64))
                ms.append(np.repeat(m, size))
            mm = np.concatenate(ms)
            kind = "simple" if simple else "edge" if edge else "inner"
            _filter_lanes(buf, np.concatenate(q0s), np.concatenate(steps),
                          limit[mm] + (4 if edge else 0), interior[mm], hev[mm], kind)
    return [buf[o:o + plane.size].reshape(plane.shape) for o, plane in zip(offsets, planes)]


def _decode_vp8(data: bytes, chunk_size: int, name: str):
    """A ``VP8 `` payload (with its padding byte) as its filtered Y, U
    and V planes of whole macroblocks, and the frame's width and height."""
    first_size, width, height = _frame_header(data, chunk_size, name)
    _SEEN.add("vp8")
    d = _BoolDecoder(data, 10, first_size)
    p = _frame_parameters(d, name)
    partitions = _partitions(data, 10 + first_size, p["partitions"], name)
    if p["partitions"] > 1:
        _SEEN.add("vp8.partitions")
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    intra_top = [0] * (4 * mb_w)
    top_nz = [[0] * 9 for _ in range(mb_w)]
    mbs, ac, index, values = [], [], [], []
    for my in range(mb_h):
        row = _intra_modes(d, mb_w, p, intra_top)
        if d.eof:
            raise ValueError(f"{name}: the VP8 first partition ends early")
        tokens = partitions[my & (p["partitions"] - 1)]
        left_nz = [0] * 9
        for mx, (segment, skip, modes, uvmode) in enumerate(row):
            whole = not isinstance(modes, list)  # one 16x16 mode, with a Y2 block
            if skip:
                _SEEN.add("vp8.skip")
                top, left = top_nz[mx], left_nz
                top[:8] = left[:8] = [0] * 8
                if whole:
                    top[8] = left[8] = 0
                ac.append(False)
            else:
                ac.append(_residuals(tokens, p, segment, whole, top_nz[mx], left_nz,
                                     400 * len(mbs), index, values))
            if tokens.eof:
                raise ValueError(f"{name}: a VP8 token partition ends early")
            mbs.append((segment, skip, modes, uvmode))
    coeffs = np.zeros(400 * len(mbs), np.int64)
    coeffs[index] = values
    coeffs = coeffs.astype(np.int16).astype(np.int64).reshape(len(mbs), 25, 16)
    i16 = np.array([not isinstance(mb[2], list) for mb in mbs])
    if i16.any():
        coeffs[i16, :16, 0] = _iwht(coeffs[i16, 24])
    residual = np.clip(_idct(coeffs[:, :24].reshape(-1, 16)), -256, 256)
    planes = _reconstruct(mbs, residual.reshape(len(mbs), 24, 16), mb_w, mb_h)
    if p["filter_type"]:
        _SEEN.add("vp8.filter." + ("simple" if p["filter_type"] == 1 else "normal"))
        has_dc = (coeffs[:, :24, 0] != 0).any(axis=1)
        strengths = [p["strengths"][mb[0]][0 if i else 1] for mb, i in zip(mbs, i16)]
        limit, interior, hev = (np.array(v) for v in zip(*strengths))
        inner = ~i16 | np.array(ac) | has_dc
        planes = _loop_filter(planes, mb_w, mb_h, limit, interior, hev, inner,
                              p["filter_type"] == 1)
    return planes, width, height


def _yuv_to_rgb(Y, U, V, width: int, height: int) -> np.ndarray:
    """libwebp's fancy upsampler (UpsampleRgbaLinePair) and VP8YuvToRgb on
    the frame's planes. Output row 0 pairs chroma row 0 with itself, rows
    2k-1 and 2k pair chroma rows k-1 and k, and an even height's last row
    pairs the last chroma row with itself."""
    y = Y[:height, :width].astype(np.int64)
    half_w = (width + 1) // 2
    rows = np.arange(height)
    k = (rows + 1) // 2
    last = (height + 1) // 2 - 1
    top_rows = np.where(rows == 0, 0, np.maximum(k - 1, 0))
    cur_rows = np.minimum(k, last)
    bottom = (rows % 2 == 0) & (rows > 0)
    channels = []
    for plane in (U, V):
        c = plane[:(height + 1) // 2, :half_w].astype(np.int64)
        t, l = c[top_rows], c[cur_rows]  # the nearer row of each pair first
        near = np.where(bottom[:, None], l, t)
        far = np.where(bottom[:, None], t, l)
        out = np.empty((height, width), np.int64)
        out[:, 0] = (3 * near[:, 0] + far[:, 0] + 2) >> 2
        if half_w > 1:
            avg = t[:, :-1] + t[:, 1:] + l[:, :-1] + l[:, 1:] + 8
            d12 = (avg + 2 * (t[:, 1:] + l[:, :-1])) >> 3
            d03 = (avg + 2 * (t[:, :-1] + l[:, 1:])) >> 3
            odd = np.where(bottom[:, None], (d03 + l[:, :-1]) >> 1, (d12 + t[:, :-1]) >> 1)
            even = np.where(bottom[:, None], (d12 + l[:, 1:]) >> 1, (d03 + t[:, 1:]) >> 1)
            count = (width - 1) >> 1
            out[:, 1:2 * count:2] = odd[:, :count]
            out[:, 2:2 * count + 1:2] = even[:, :count]
        if width % 2 == 0:
            out[:, -1] = (3 * near[:, -1] + far[:, -1] + 2) >> 2
        channels.append(out)
    u, v = channels

    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6, np.where(x < 0, 0, 255))

    luma = (y * 19077) >> 8
    r = clip8(luma + ((v * 26149) >> 8) - 14234)
    g = clip8(luma - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    b = clip8(luma + ((u * 33050) >> 8) - 17685)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)
