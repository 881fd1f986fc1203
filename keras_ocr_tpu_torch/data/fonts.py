"""TrueType fonts in numpy: what the JAX package takes from
``PIL.ImageFont`` and ``fontTools.ttLib``.

:class:`Face` reads an sfnt file with TrueType outlines (``head``, ``hhea``,
``OS/2``, ``maxp``, ``hmtx``, ``loca``, ``glyf`` with composite glyphs,
``cmap`` formats 0, 4, 6, 12 and 13) and refuses anything else with a
``ValueError`` that names it. :class:`FreeTypeFont` opens a face at a pixel
size as ``FT_Set_Pixel_Sizes(face, 0, size)`` does, scales the outlines in
FreeType's 26.6 fixed point and measures and renders them as
``PIL.ImageFont.FreeTypeFont`` does under its default anchor ("la"), with
one deliberate difference: the outlines are not hinted (FreeType's
``FT_LOAD_NO_HINTING``), so ink and boxes can sit a pixel from PIL's. A
character that the cmap lacks takes glyph 0 (``.notdef``), as in FreeType.
:func:`load_default` opens the Aileron face that ``PIL.ImageFont.load_default``
embeds, at size 10.
"""

from __future__ import annotations

import functools
import os
import struct
import typing

import numpy as np

from . import raster
from ._default_font import font_bytes as default_font_bytes

_REQUIRED = ("head", "hhea", "maxp", "hmtx", "loca", "glyf", "cmap")

# Composite glyph flags (the glyf table's component records).
_ARG_WORDS = 0x0001
_ARGS_XY = 0x0002
_HAVE_SCALE = 0x0008
_MORE = 0x0020
_HAVE_XY_SCALE = 0x0040
_HAVE_2X2 = 0x0080
_SCALED_OFFSET = 0x0800


def mul_fix(a, b):
    """FreeType's ``FT_MulFix``: ``a * b / 65536`` rounded half away from
    zero, elementwise on integers."""
    a = np.asarray(a, dtype=np.int64)
    product = np.abs(a) * abs(int(b))
    return np.sign(a) * (1 if b >= 0 else -1) * ((product + 0x8000) >> 16)


def div_fix(a: int, b: int) -> int:
    """FreeType's ``FT_DivFix``: ``a * 65536 / b`` rounded, sign apart."""
    sign = -1 if (a < 0) != (b < 0) else 1
    a, b = abs(a), abs(b)
    return sign * ((a * 65536 + b // 2) // b)


def _pixel(x) -> int:
    """26.6 to whole pixels, rounded (Pillow's ``PIXEL``)."""
    return (int(x) + 32) >> 6


class Outline(typing.NamedTuple):
    """A glyph's points in font units, as ``fontTools``' ``getCoordinates``
    gives them: (N, 2) float64 points, the index of each contour's last
    point, and the on-curve flag of each point."""

    points: np.ndarray
    end_points: typing.List[int]
    on_curve: np.ndarray


class Face:
    """An sfnt file with TrueType (``glyf``) outlines."""

    def __init__(self, source):
        if isinstance(source, (bytes, bytearray, memoryview)):
            data = bytes(source)
        elif isinstance(source, (str, os.PathLike)):
            with open(source, "rb") as f:
                data = f.read()
        else:
            data = source.read()
        self.data = data
        if len(data) < 12:
            raise ValueError("not an sfnt file: too short")
        tag = data[:4]
        if tag == b"ttcf":
            raise ValueError("font collections (ttcf) are not supported")
        if tag == b"OTTO":
            raise ValueError("CFF outlines (OTTO) are not supported")
        if tag not in (b"\x00\x01\x00\x00", b"true"):
            raise ValueError(f"not an sfnt file: version tag {tag!r}")
        (num_tables,) = struct.unpack_from(">H", data, 4)
        self.tables = {}
        for i in range(num_tables):
            name, _, offset, length = struct.unpack_from(">4sIII", data, 12 + 16 * i)
            if offset + length > len(data):
                raise ValueError(f"table {name.decode('latin-1')!r} runs past the file's end")
            self.tables[name.decode("latin-1")] = (offset, length)
        if "glyf" not in self.tables and ("CFF " in self.tables or "CFF2" in self.tables):
            raise ValueError("CFF outlines are not supported")
        for name in _REQUIRED:
            if name not in self.tables:
                raise ValueError(f"missing table {name!r}")
        self._read_head()
        self._read_metrics()
        self._read_cmap()
        self._outlines: typing.Dict[int, Outline] = {}

    def table(self, name: str) -> bytes:
        offset, length = self.tables[name]
        return self.data[offset : offset + length]

    # -- fixed tables ------------------------------------------------------

    def _read_head(self):
        head = self.table("head")
        (self.flags,) = struct.unpack_from(">H", head, 16)
        (self.units_per_em,) = struct.unpack_from(">H", head, 18)
        (self.index_to_loc_format,) = struct.unpack_from(">h", head, 50)
        if not 16 <= self.units_per_em <= 16384:
            raise ValueError(f"unitsPerEm {self.units_per_em} out of range")
        if self.index_to_loc_format not in (0, 1):
            raise ValueError(f"indexToLocFormat {self.index_to_loc_format}")
        maxp = self.table("maxp")
        (self.num_glyphs,) = struct.unpack_from(">H", maxp, 4)
        # FreeType hints a TrueType font with no hinting program of its own
        # (no fpgm, no prep, no glyph instructions) automatically.
        max_instructions = struct.unpack_from(">H", maxp, 26)[0] if len(maxp) >= 28 else 0
        self.autohinted = (max_instructions == 0 and "fpgm" not in self.tables
                           and "prep" not in self.tables)
        loca = self.table("loca")
        count = self.num_glyphs + 1
        if self.index_to_loc_format == 0:
            offsets = np.frombuffer(loca, dtype=">u2", count=count).astype(np.int64) * 2
        else:
            offsets = np.frombuffer(loca, dtype=">u4", count=count).astype(np.int64)
        self._loca = offsets

    def _read_metrics(self):
        hhea = self.table("hhea")
        ascender, descender, line_gap = struct.unpack_from(">hhh", hhea, 4)
        (num_hmetrics,) = struct.unpack_from(">H", hhea, 34)
        # FreeType's choice (sfobjs.c): OS/2's typographic values when its
        # USE_TYPO_METRICS bit is set, else hhea's, else OS/2's typographic
        # or Windows values when hhea has none.
        os2 = self.table("OS/2") if "OS/2" in self.tables else None
        if os2 is not None and len(os2) >= 78:
            (fs_selection,) = struct.unpack_from(">H", os2, 62)
            typo_asc, typo_desc, typo_gap, win_asc, win_desc = struct.unpack_from(">hhhHH", os2, 68)
            if fs_selection & 128:
                ascender, descender, line_gap = typo_asc, typo_desc, typo_gap
            elif not (ascender or descender):
                if typo_asc or typo_desc:
                    ascender, descender, line_gap = typo_asc, typo_desc, typo_gap
                else:
                    ascender, descender, line_gap = win_asc, -win_desc, 0
        self.ascender, self.descender, self.line_gap = ascender, descender, line_gap
        hmtx = self.table("hmtx")
        if num_hmetrics < 1 or len(hmtx) < 4 * num_hmetrics:
            raise ValueError("hmtx is shorter than hhea says")
        pairs = np.frombuffer(hmtx, dtype=">i2", count=2 * num_hmetrics).astype(np.int64)
        advances = pairs[0::2] & 0xFFFF
        bearings = pairs[1::2]
        extra = self.num_glyphs - num_hmetrics
        if extra > 0:
            tail = np.frombuffer(hmtx, dtype=">i2", count=extra,
                                 offset=4 * num_hmetrics).astype(np.int64)
            advances = np.concatenate([advances, np.full(extra, advances[-1])])
            bearings = np.concatenate([bearings, tail])
        self.advances, self.bearings = advances, bearings

    # -- cmap --------------------------------------------------------------

    def _read_cmap(self):
        cmap = self.table("cmap")
        (count,) = struct.unpack_from(">H", cmap, 2)
        self.subtables = []  # (platform, encoding, format, {codepoint: glyph})
        for i in range(count):
            platform, encoding, offset = struct.unpack_from(">HHI", cmap, 4 + 8 * i)
            (fmt,) = struct.unpack_from(">H", cmap, offset)
            self.subtables.append((platform, encoding, fmt, offset))
        # FreeType's unicode charmap: the last UCS-4 table (3, 10) / (0, 4)
        # / (0, 6), else the first unicode one, as ``find_unicode_charmap``.
        def unicode_kind(platform, encoding):
            if (platform, encoding) in ((3, 10), (0, 4), (0, 6)):
                return 2
            if platform == 0 or (platform, encoding) == (3, 1):
                return 1
            return 0

        chosen = None
        for index in reversed(range(len(self.subtables))):
            if unicode_kind(*self.subtables[index][:2]) == 2:
                chosen = index
                break
        if chosen is None:
            chosen = next((i for i, s in enumerate(self.subtables) if unicode_kind(*s[:2])), None)
        if chosen is None:
            raise ValueError("no unicode cmap subtable")
        self.cmap = self._subtable(chosen)

    def _subtable(self, index) -> typing.Dict[int, int]:
        """{codepoint: glyph} of one cmap subtable."""
        _, _, fmt, offset = self.subtables[index]
        data = self.table("cmap")
        if fmt == 0:
            glyphs = data[offset + 6 : offset + 6 + 256]
            return {c: g for c, g in enumerate(glyphs) if g}
        if fmt == 4:
            (seg_x2,) = struct.unpack_from(">H", data, offset + 6)
            n = seg_x2 // 2
            ends = struct.unpack_from(f">{n}H", data, offset + 14)
            starts = struct.unpack_from(f">{n}H", data, offset + 16 + seg_x2)
            deltas = struct.unpack_from(f">{n}h", data, offset + 16 + 2 * seg_x2)
            range_at = offset + 16 + 3 * seg_x2
            ranges = struct.unpack_from(f">{n}H", data, range_at)
            table = {}
            for i in range(n):
                for code in range(starts[i], ends[i] + 1):
                    if code == 0xFFFF:
                        continue
                    if ranges[i] == 0:
                        glyph = (code + deltas[i]) & 0xFFFF
                    else:
                        at = range_at + 2 * i + ranges[i] + 2 * (code - starts[i])
                        (glyph,) = struct.unpack_from(">H", data, at)
                        if glyph:
                            glyph = (glyph + deltas[i]) & 0xFFFF
                    if glyph:
                        table[code] = glyph
            return table
        if fmt == 6:
            first, count = struct.unpack_from(">HH", data, offset + 6)
            glyphs = struct.unpack_from(f">{count}H", data, offset + 10)
            return {first + i: g for i, g in enumerate(glyphs) if g}
        if fmt in (12, 13):
            (groups,) = struct.unpack_from(">I", data, offset + 12)
            table = {}
            for i in range(groups):
                start, end, glyph = struct.unpack_from(">III", data, offset + 16 + 12 * i)
                for code in range(start, end + 1):
                    value = glyph + (code - start) if fmt == 12 else glyph
                    if value:
                        table[code] = value
            return table
        raise ValueError(f"cmap subtable format {fmt} is not supported")

    @functools.cached_property
    def all_codepoints(self) -> typing.List[typing.FrozenSet[int]]:
        """The codes of every cmap subtable (format 14's variation
        sequences map no code), as ``fontTools``' ``table.cmap`` keys."""
        return [frozenset() if fmt == 14 else frozenset(self._subtable(i))
                for i, (_, _, fmt, _) in enumerate(self.subtables)]

    def glyph_index(self, character: str) -> int:
        """The glyph of ``character`` in the unicode cmap, 0 if missing."""
        return self.cmap.get(ord(character), 0)

    @functools.cached_property
    def blue_zones(self) -> typing.List[typing.Tuple[int, int, bool]]:
        """Latin alignment zones in font units, (flat reference, round
        overshoot, top side), from the extremes of reference glyphs: the
        x-height ("x", "o"), the cap height ("H", "O"), the ascender ("l"),
        the baseline ("x", "o") and the descender ("p"). A zone whose
        glyphs the font lacks is left out."""

        def extreme(character, top):
            glyph = self.glyph_index(character)
            points = self.outline(glyph).points if glyph else ()
            if not len(points):
                return None
            return int(points[:, 1].max() if top else points[:, 1].min())

        zones = []
        for flat, rounded, top in (("x", "o", True), ("H", "O", True), ("l", "l", True),
                                   ("x", "o", False), ("p", "p", False)):
            ref, shoot = extreme(flat, top), extreme(rounded, top)
            if ref is not None and shoot is not None:
                zones.append((ref, shoot, top))
        return zones

    # -- glyf --------------------------------------------------------------

    def _glyph_data(self, glyph: int) -> bytes:
        if not 0 <= glyph < self.num_glyphs:
            raise ValueError(f"glyph {glyph} out of range")
        start, end = self._loca[glyph], self._loca[glyph + 1]
        offset, length = self.tables["glyf"]
        if end < start or end > length:
            raise ValueError(f"glyph {glyph}: loca runs past glyf")
        return self.data[offset + start : offset + end]

    def glyph_header(self, glyph: int):
        """(numberOfContours, xMin, yMin, xMax, yMax), zeros when empty."""
        data = self._glyph_data(glyph)
        if not data:
            return 0, 0, 0, 0, 0
        return struct.unpack_from(">hhhhh", data, 0)

    def outline(self, glyph: int, _depth: int = 0) -> Outline:
        """The glyph's points in font units, composites resolved."""
        cached = self._outlines.get(glyph)
        if cached is not None:
            return cached
        if _depth > 16:
            raise ValueError(f"glyph {glyph}: composite nesting too deep")
        data = self._glyph_data(glyph)
        if not data:
            result = Outline(np.zeros((0, 2)), [], np.zeros(0, dtype=bool))
        else:
            (contours,) = struct.unpack_from(">h", data, 0)
            if contours >= 0:
                result = self._simple(data, contours)
            else:
                result = self._composite(data, _depth)
        self._outlines[glyph] = result
        return result

    @staticmethod
    def _simple(data: bytes, contours: int) -> Outline:
        ends = list(struct.unpack_from(f">{contours}H", data, 10))
        count = ends[-1] + 1 if ends else 0
        (instructions,) = struct.unpack_from(">H", data, 10 + 2 * contours)
        at = 12 + 2 * contours + instructions
        flags = bytearray()
        while len(flags) < count:
            flag = data[at]
            at += 1
            flags.append(flag)
            if flag & 0x08:
                flags.extend([flag] * data[at])
                at += 1
        flags = flags[:count]

        def coordinates(short_bit, same_bit):
            nonlocal at
            values = np.zeros(count, dtype=np.int64)
            for i, flag in enumerate(flags):
                if flag & short_bit:
                    value = data[at]
                    at += 1
                    values[i] = value if flag & same_bit else -value
                elif not flag & same_bit:
                    (values[i],) = struct.unpack_from(">h", data, at)
                    at += 2
            return np.cumsum(values)

        xs = coordinates(0x02, 0x10)
        ys = coordinates(0x04, 0x20)
        points = np.stack([xs, ys], axis=1).astype(np.float64)
        on_curve = np.frombuffer(bytes(flags), dtype=np.uint8) & 1
        return Outline(points, ends, on_curve.astype(bool))

    def _composite(self, data: bytes, depth: int) -> Outline:
        at = 10
        points = np.zeros((0, 2))
        ends: typing.List[int] = []
        on_curve = np.zeros(0, dtype=bool)
        while True:
            flags, glyph = struct.unpack_from(">HH", data, at)
            at += 4
            if flags & _ARG_WORDS:
                fmt = ">hh" if flags & _ARGS_XY else ">HH"
                arg1, arg2 = struct.unpack_from(fmt, data, at)
                at += 4
            else:
                fmt = ">bb" if flags & _ARGS_XY else ">BB"
                arg1, arg2 = struct.unpack_from(fmt, data, at)
                at += 2
            transform = None
            if flags & _HAVE_SCALE:
                (scale,) = struct.unpack_from(">h", data, at)
                at += 2
                transform = ((scale / 16384, 0.0), (0.0, scale / 16384))
            elif flags & _HAVE_XY_SCALE:
                sx, sy = struct.unpack_from(">hh", data, at)
                at += 4
                transform = ((sx / 16384, 0.0), (0.0, sy / 16384))
            elif flags & _HAVE_2X2:
                xx, xy, yx, yy = struct.unpack_from(">hhhh", data, at)
                at += 8
                transform = ((xx / 16384, xy / 16384), (yx / 16384, yy / 16384))
            child = self.outline(glyph, depth + 1)
            coords = child.points.copy()

            def apply(c):
                (a, b), (c_, d) = transform
                return np.stack([c[:, 0] * a + c[:, 1] * c_, c[:, 0] * b + c[:, 1] * d], axis=1)

            if not flags & _ARGS_XY:
                # Point matching: the child's point arg2 lands on the
                # parent's point arg1, after the transform.
                if transform is not None:
                    coords = apply(coords)
                if arg1 >= len(points) or arg2 >= len(coords):
                    raise ValueError(f"glyph {glyph}: matched point out of range")
                coords = coords + (points[arg1] - coords[arg2])
            elif transform is None:
                coords = coords + np.array([arg1, arg2], dtype=np.float64)
            elif flags & _SCALED_OFFSET:
                coords = apply(coords + np.array([arg1, arg2], dtype=np.float64))
            else:
                coords = apply(coords) + np.array([arg1, arg2], dtype=np.float64)
            ends.extend(e + len(points) for e in child.end_points)
            points = np.concatenate([points, coords])
            on_curve = np.concatenate([on_curve, child.on_curve])
            if not flags & _MORE:
                break
        return Outline(points, ends, on_curve)


@functools.lru_cache(maxsize=64)
def _face_of_file(path: str, mtime_ns: int, size: int) -> Face:
    return Face(path)


def open_face(source) -> Face:
    """A :class:`Face` from a path (parsed once per file version), a file
    object or bytes."""
    if isinstance(source, (str, os.PathLike)):
        path = os.fspath(source)
        stat = os.stat(path)
        return _face_of_file(path, stat.st_mtime_ns, stat.st_size)
    return Face(source)


class FreeTypeFont:
    """A face opened at ``size`` pixels per em: the counterpart of
    ``PIL.ImageFont.truetype(font, size)``.

    Boxes follow Pillow's rule (the pen line from the origin to the
    rounded advance, joined with each glyph's ink box), on unhinted
    outlines, with the ink box's top and bottom set to whole pixels the way
    FreeType's hinting would move them: rounded for a font with its own
    hinting program; for a font without one, which FreeType hints
    automatically, scaled so that the top of "o" (the x-height's
    overshoot) lands on a pixel as the auto-hinter's scale fit does, then
    rounded outwards from 3/8 of a pixel. Masks are the unhinted ink.
    Each mask is kept per text in the object, so a scene renders each
    glyph once; ``hits`` and ``misses`` count the lookups.
    """

    def __init__(self, font=None, size: float = 10):
        self.face = font if isinstance(font, Face) else open_face(font)
        self.path = os.fspath(font) if isinstance(font, (str, os.PathLike)) else None
        self.size = size
        face = self.face
        ppem = int(round(size * 64))
        # FT_Request_Size (nominal): the scale from the height in 26.6;
        # TrueType fonts flagged for integer ppems rescale from the
        # rounded ppem (tt_size_reset). The ascender and descender are
        # grid-fitted outwards.
        scale = div_fix(ppem, face.units_per_em)
        self.ppem = (ppem + 32) >> 6
        if face.flags & 8:
            scale = div_fix(self.ppem << 6, face.units_per_em)
        self.scale = scale
        self.ascender_26_6 = (int(mul_fix(face.ascender, scale)) + 63) & ~63
        self.descender_26_6 = int(mul_fix(face.descender, scale)) & ~63
        self._masks: typing.Dict[str, typing.Tuple[np.ndarray, typing.Tuple[int, int]]] = {}
        self._glyphs: typing.Dict[int, tuple] = {}
        self.hits = 0
        self.misses = 0
        self._fit = self._vertical_fit()
        self._zones = self._fitted_zones()

    def getmetrics(self) -> typing.Tuple[int, int]:
        """(ascent, descent) in pixels, as PIL's ``getmetrics``."""
        return _pixel(self.ascender_26_6), -_pixel(self.descender_26_6)

    def _vertical_fit(self):
        """(numerator, denominator, round-up bias in 1/64 px) that turn an
        unhinted height in 26.6 into the whole pixels of the boxes."""
        if not self.face.autohinted:
            return 1, 1, 32
        o = self.face.glyph_index("o")
        points = self.face.outline(o).points if o else ()
        scaled = int(mul_fix(int(points[:, 1].max()), self.scale)) if len(points) else 0
        if scaled <= 0:
            return 1, 1, 40
        fitted = (scaled + 40) & ~63
        # The auto-hinter keeps its scale if the fit moves the em by two
        # pixels or more.
        if fitted <= 0 or abs(self.ppem * 64 * (fitted - scaled)) >= 128 * scaled:
            return 1, 1, 40
        return fitted, scaled, 40

    def _fitted_zones(self):
        """The face's alignment zones at this size: (reference, overshoot,
        fitted reference, fitted overshoot, top side), heights in 26.6. The
        reference lands on the nearest pixel (as the boxes round); the
        overshoot stays on it when it strays less than half a pixel, else
        lands that many whole pixels away."""
        numerator, denominator, _ = self._fit
        zones = []
        for ref, shoot, top in self.face.blue_zones:
            ref = int(mul_fix(ref, self.scale)) * numerator // denominator
            shoot = int(mul_fix(shoot, self.scale)) * numerator // denominator
            ref_fit = ((ref + 32) >> 6) << 6
            delta = abs(shoot - ref)
            step = 0 if delta < 32 else ((delta + 32) >> 6) << 6
            zones.append((ref, shoot, ref_fit, ref_fit + (step if shoot >= ref else -step), top))
        return zones

    def _glyph(self, glyph: int):
        """(grid-fitted outline points in 26.6 with the y axis down, contour
        ends, on-curve flags, advance in 26.6, unhinted control box in 26.6
        (y down) or None) of a glyph."""
        cached = self._glyphs.get(glyph)
        if cached is not None:
            return cached
        face = self.face
        outline = face.outline(glyph)
        points = outline.points
        if np.all(points == np.round(points)):
            scaled = mul_fix(points.astype(np.int64), self.scale)
        else:
            scaled = np.round(points * (self.scale / 65536.0)).astype(np.int64)
        contours, x_min = face.glyph_header(glyph)[:2]
        # The outline is shifted so that its left phantom point, xMin
        # less the left side bearing, sits at the origin.
        shift = int(mul_fix(x_min - int(face.bearings[glyph]), self.scale)) if contours else 0
        box = None
        fitted = scaled
        if len(scaled):
            scaled = scaled - np.array([shift, 0])
            fitted = scaled.copy()
            fitted[:, 1] = _fit_rows(points, scaled[:, 1], outline.end_points, self._fit,
                                     self._zones)
            if face.autohinted:
                fitted[:, 0] = _fit_columns(points, scaled[:, 0], outline.end_points)
            scaled[:, 1] = -scaled[:, 1]
            fitted[:, 1] = -fitted[:, 1]
            box = (int(scaled[:, 0].min()), int(scaled[:, 1].min()),
                   int(scaled[:, 0].max()), int(scaled[:, 1].max()))
        advance = int(mul_fix(int(face.advances[glyph]), self.scale))
        entry = (fitted, outline.end_points, outline.on_curve, advance, box)
        self._glyphs[glyph] = entry
        return entry

    def _layout(self, text: str):
        """(glyph, pen x in 26.6) for each character and the pen's end:
        advances only, no kerning and no shaping."""
        pen = 0
        placed = []
        for character in text:
            glyph = self.face.glyph_index(character)
            placed.append((glyph, pen))
            pen += self._glyph(glyph)[3]
        return placed, pen

    def _bounds(self, text: str):
        """Pillow's ``bounding_box_and_anchors`` for the anchor "la":
        (width, height, x offset, y offset) in pixels."""
        placed, _ = self._layout(text)
        numerator, denominator, bias = self._fit
        x_min = y_min = x_max = y_max = 0
        for glyph, x in placed:
            px = _pixel(x)
            _, _, _, advance, box = self._glyph(glyph)
            x_max = max(x_max, _pixel(x + advance))
            if box is None:
                continue
            left, top, right, bottom = box
            x_min = min(x_min, (left >> 6) + px)
            x_max = max(x_max, ((right + 63) >> 6) + px)
            y_max = max(y_max, ((-top * numerator) // denominator + bias) >> 6)
            y_min = min(y_min, ((-bottom * numerator) // denominator + 64 - bias) >> 6)
        ascender = _pixel(self.ascender_26_6) if placed else 0
        return x_max - x_min, y_max - y_min, x_min, ascender - y_max

    def getsize(self, text: str):
        """((width, height), (offset_x, offset_y)) as PIL's
        ``font.font.getsize``."""
        width, height, x_offset, y_offset = self._bounds(text)
        return (width, height), (x_offset, y_offset)

    def getbbox(self, text: str) -> typing.Tuple[int, int, int, int]:
        """(left, top, right, bottom) as PIL's ``getbbox``."""
        (width, height), (left, top) = self.getsize(text)
        return left, top, left + width, top + height

    def _ink(self, text: str):
        """The ink of ``text`` drawn with the pen at the origin: (coverage
        (H, W), (left, top)), its top-left pixel relative to the origin on
        the baseline, y down."""
        cached = self._masks.get(text)
        if cached is not None:
            self.hits += 1
            return cached
        self.misses += 1
        pieces = []
        for glyph, x in self._layout(text)[0]:
            points, ends, on_curve, _, box = self._glyph(glyph)
            if box is not None:
                origin = np.array([_pixel(x) * 64, 0])
                pieces.append(raster.render_outline(points + origin, ends, on_curve))
        if not pieces:
            result = (np.zeros((0, 0), dtype=np.uint8), (0, 0))
        elif len(pieces) == 1:
            result = pieces[0]
        else:
            left = min(l for _, (l, _) in pieces)
            top = min(t for _, (_, t) in pieces)
            right = max(l + c.shape[1] for c, (l, _) in pieces)
            bottom = max(t + c.shape[0] for c, (_, t) in pieces)
            mask = np.zeros((bottom - top, right - left), dtype=np.uint8)
            for coverage, (l, t) in pieces:
                h, w = coverage.shape
                region = mask[t - top : t - top + h, l - left : l - left + w]
                np.maximum(region, coverage, out=region)
            result = (mask, (left, top))
        self._masks[text] = result
        return result

    def getmask2(self, text: str, start=(0.0, 0.0)):
        """(uint8 coverage (H, W), (offset_x, offset_y)): ``text`` drawn at
        ``(x, y)`` puts the mask's top-left pixel at ``(int(x), int(y))``
        plus the offset, as PIL's ``getmask2(text, "L", start=...)`` with
        ``start`` the position's fractions (which move the pen by whole
        pixels, as in Pillow). The mask spans the ink only."""
        coverage, (left, top) = self._ink(text)
        shift_x = _pixel(int(start[0] * 64))
        shift_y = -_pixel(-int(start[1] * 64))
        ascender = _pixel(self.ascender_26_6)
        return coverage, (left + shift_x, top + ascender + shift_y)


def _fit_rows(points, heights, end_points, fit, zones):
    """Heights (26.6, y up) of an outline's points moved as vertical hinting
    moves them. A horizontal edge is a point with a neighbour on its
    contour at the same height in font units (flat segments, and the
    horizontal tangents of curve extremes); the ink lies below it when the
    contour runs right there, above it when the contour runs left. An edge
    within half a pixel of an alignment zone of its side lands on the
    zone's fitted reference height, or on its overshoot if nearer to that;
    any other edge lands on a whole pixel, rounded as the boxes' tops and
    bottoms are. A stem, an edge with ink above it and the next edge up
    with ink below, keeps its width rounded to whole pixels, at least one:
    its free edge moves with the other, or both sit about its centre. The
    other points follow linearly between the edges around them, or with
    the nearest edge beyond."""
    numerator, denominator, bias = fit
    points = np.asarray(points)
    levels = (heights * numerator) // denominator
    anchors = {}
    begin = 0
    for end in end_points:
        ring = points[begin : end + 1]
        y, x = ring[:, 1], ring[:, 0]
        same_next = y == np.roll(y, -1)
        same_prev = y == np.roll(y, 1)
        run = np.where(same_next, np.roll(x, -1) - x, x - np.roll(x, 1))
        for i in np.flatnonzero(same_next | same_prev):
            level = int(levels[begin + i])
            if level in anchors or run[i] == 0:
                continue
            top = run[i] > 0
            target = None
            for ref, shoot, ref_fit, shoot_fit, zone_top in zones:
                if zone_top != top:
                    continue
                low, high = min(ref, shoot) - 32, max(ref, shoot) + 32
                if low <= level <= high:
                    target = ref_fit if abs(level - ref) <= abs(level - shoot) else shoot_fit
                    break
            zoned = target is not None
            if target is None:
                lift = bias if top else 64 - bias
                target = ((level + lift) >> 6) << 6
            anchors[level] = [target, top, zoned]
        begin = end + 1
    if not anchors:
        return levels
    keys = sorted(anchors)
    for low, high in zip(keys[:-1], keys[1:]):
        (low_at, low_top, low_zoned), (high_at, high_top, high_zoned) = anchors[low], anchors[high]
        if low_top or not high_top:
            continue
        width = max(64, ((high - low + 32) >> 6) << 6)
        if high_zoned and not low_zoned:
            anchors[low][0] = high_at - width
        elif low_zoned and not high_zoned:
            anchors[high][0] = low_at + width
        elif not (low_zoned or high_zoned):
            bottom = (((low + high - width) // 2 + 32) >> 6) << 6
            anchors[low][0], anchors[high][0] = bottom, bottom + width
    targets = np.array([anchors[k][0] for k in keys], dtype=np.float64)
    keys = np.array(keys, dtype=np.float64)
    moved = np.interp(levels, keys, targets)
    below, above = levels < keys[0], levels > keys[-1]
    moved[below] = levels[below] + (targets[0] - keys[0])
    moved[above] = levels[above] + (targets[-1] - keys[-1])
    return np.round(moved).astype(np.int64)


def _fit_columns(points, xs, end_points):
    """x (26.6) of an outline's points moved as FreeType's auto-hinter
    moves vertical stems at small sizes: a stem, an edge with ink to its
    right and the next edge with ink to its left (edges found as in
    :func:`_fit_rows`, with x for y), keeps its width rounded to whole
    pixels, at least one. The leftmost stem sits on the pixel columns
    nearest its centre; every other stem keeps its distance from the
    leftmost one, rounded to whole pixels. The other points follow
    linearly between the stems' edges, or with the nearest beyond."""
    points = np.asarray(points)
    kinds = {}
    begin = 0
    for end in end_points:
        ring = points[begin : end + 1]
        x, y = ring[:, 0], ring[:, 1]
        same_next = x == np.roll(x, -1)
        same_prev = x == np.roll(x, 1)
        run = np.where(same_next, np.roll(y, -1) - y, y - np.roll(y, 1))
        for i in np.flatnonzero(same_next | same_prev):
            level = int(xs[begin + i])
            if level not in kinds and run[i] != 0:
                kinds[level] = run[i] > 0  # ink to the right
        begin = end + 1
    keys = sorted(kinds)
    stems = [(low, high) for low, high in zip(keys[:-1], keys[1:])
             if kinds[low] and not kinds[high]]
    if not stems:
        return xs
    anchors = {}
    first_low, first_high = stems[0]
    for low, high in stems:
        width = max(64, ((high - low + 32) >> 6) << 6)
        if low == first_low:
            if width <= 64:
                centre = low + (high - low) // 2
                near = ((centre + 32) >> 6) << 6
                left = near - 64 if abs(centre - (near - 32)) <= abs(centre - (near + 32)) else near
            else:
                left = ((low + 32) >> 6) << 6
            origin = left
        else:
            left = origin + (((low - first_low + 32) >> 6) << 6)
        anchors[low], anchors[high] = left, left + width
    keys = np.array(sorted(anchors), dtype=np.float64)
    targets = np.array([anchors[k] for k in sorted(anchors)], dtype=np.float64)
    moved = np.interp(xs, keys, targets)
    below, above = xs < keys[0], xs > keys[-1]
    moved[below] = xs[below] + (targets[0] - keys[0])
    moved[above] = xs[above] + (targets[-1] - keys[-1])
    return np.round(moved).astype(np.int64)


def truetype(font=None, size: float = 10) -> FreeTypeFont:
    """``PIL.ImageFont.truetype(font, size)``'s counterpart: a path, a file
    object, bytes or a :class:`Face`."""
    return FreeTypeFont(font, size)


@functools.lru_cache(maxsize=1)
def _default_face() -> Face:
    return Face(default_font_bytes())


def load_default(size: typing.Optional[float] = None) -> FreeTypeFont:
    """The Aileron face of ``PIL.ImageFont.load_default``, at 10 pixels
    unless ``size`` is given."""
    return FreeTypeFont(_default_face(), 10 if size is None else size)
