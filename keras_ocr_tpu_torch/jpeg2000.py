"""JPEG 2000 (ITU-T T.800 Part 1) for ``tools.read``: JP2 / JPX files and
raw codestreams (``.j2k``, ``.j2c``, ``.jpc``), decoded pixel for pixel as
``PIL.Image.open(f).convert("RGB")`` gives them. PIL decodes JPEG 2000
with OpenJPEG 2.5, tile by tile, and unpacks each tile itself; this module
does the same three things:

* PIL's own header pass (``Jpeg2KImagePlugin``) picks the size and the mode
  (L, I;16, LA, RGB, RGBA, CMYK, P, PA) from the JP2 header boxes or the
  SIZ marker, and a palette from ``pclr``;
* OpenJPEG's decode: the JP2 boxes it checks, the main and tile-part
  headers (SIZ, COD, COC, QCD, QCC, RGN, POC, PPM, PPT, TLM, PLM, PLT,
  CRG, COM), tier-2 (the five progression orders and POC changes,
  precincts, tag trees, layers, SOP / EPH, codeword segments), tier-1 and
  the reconstruction of :mod:`.jpeg2000_t1`, each tile's samples clamped
  to its components' precision; its ``strict`` mode fails a tile-part or a
  code-block segment that runs past the data;
* PIL's tile unpackers (``Jpeg2KDecode.c``): the shift of each component
  to 8 or 16 bits, the signed offset, subsampled components replicated,
  sYCC through PIL's YCbCr tables, then ``convert("RGB")``.

What PIL reads and this module does not raises ``NotImplementedError``:
HTJ2K (Part 15: a ``CAP`` marker, Rsiz bit 14, an HT code-block style) and
Part-2 codestreams (Rsiz bit 15; MCT, MCC, MCO, NLT, CBD, ADS, DFS, ATK).
What PIL fails on raises ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from . import jpeg2000_t1 as t1
from .codecs import cmyk_to_rgb

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"

# OpenJPEG's OPJ_COLOR_SPACE values, and what a JP2 colr box's EnumCS maps to.
UNKNOWN, UNSPECIFIED, SRGB, GRAY, SYCC, EYCC, CMYK = -1, 0, 1, 2, 3, 4, 5
ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}

LRCP, RLCP, RPCL, PCRL, CPRL = range(5)
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3  # PIL.Image.MAX_IMAGE_PIXELS
SOP, EPH = 2, 4

# Part 15 and Part 2 markers, refused by name.
REFUSED_MARKERS = {0xFF50: "HTJ2K (a CAP marker)", 0xFF59: "HTJ2K (a CPF marker)",
                   0xFF74: "Part-2 MCT marker", 0xFF75: "Part-2 MCC marker",
                   0xFF77: "Part-2 MCO marker", 0xFF76: "Part-2 NLT marker",
                   0xFF78: "Part-2 CBD marker", 0xFF73: "Part-2 ADS marker",
                   0xFF72: "Part-2 DFS marker", 0xFF79: "Part-2 ATK marker"}
# The markers OpenJPEG has a handler for, by where it takes them: the main
# header (after SIZ), a tile-part header, or both. SOP it knows and takes
# nowhere. Any other marker it steps over two bytes at a time until it
# meets one it knows (opj_j2k_read_unk).
MAIN_ONLY = {0xFF55, 0xFF57, 0xFF60, 0xFF63}  # TLM, PLM, PPM, CRG
TILE_ONLY = {0xFF58, 0xFF61, 0xFF93}  # PLT, PPT, SOD
BOTH = {0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F, 0xFF64, 0xFF90}
KNOWN = MAIN_ONLY | TILE_ONLY | BOTH | {0xFF51, 0xFF91} | set(REFUSED_MARKERS)


def is_jpeg2000(blob: bytes) -> bool:
    """PIL's ``Jpeg2KImagePlugin._accept``: a raw codestream or a JP2
    signature box."""
    return blob[:4] == J2K_SIGNATURE or blob[:12] == JP2_SIGNATURE


def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def _ceildivpow2(a: int, b: int) -> int:
    return -((-a) >> b)


# ---------------------------------------------------------------------------
# PIL's header pass (Jpeg2KImagePlugin)
# ---------------------------------------------------------------------------


class _BoxReader:
    """PIL's ``BoxReader``: boxes read from ``data[start:end]`` (``end``
    None: no known length), each failure a ``ValueError``."""

    def __init__(self, data: bytes, start: int, end, name: str):
        self.data, self.pos, self.end, self.name = data, start, end, name
        self.remaining = -1

    def _can_read(self, count: int) -> bool:
        if self.end is not None and self.pos + count > self.end:
            return False
        return count <= self.remaining if self.remaining >= 0 else True

    def read(self, fmt: str):
        size = struct.calcsize(fmt)
        if not self._can_read(size):
            raise ValueError(f"{self.name}: not enough data in a JP2 header box")
        if self.pos + size > len(self.data):
            raise ValueError(f"{self.name}: the JP2 header ends early")
        values = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += size
        if self.remaining > 0:
            self.remaining -= size
        return values

    def sub_boxes(self) -> "_BoxReader":
        size = self.remaining
        if not self._can_read(size) or self.pos + size > len(self.data):
            raise ValueError(f"{self.name}: the JP2 header box ends early")
        reader = _BoxReader(self.data[self.pos:self.pos + size], 0, size, self.name)
        self.pos += size
        return reader

    def has_next(self) -> bool:
        return self.end is None or self.pos + self.remaining < self.end

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.pos += self.remaining
        self.remaining = -1
        length, kind = self.read(">I4s")
        header = 8
        if length == 1:
            length, = self.read(">Q")
            header = 16
        if length < header or not self._can_read(length - header):
            raise ValueError(f"{self.name}: invalid JP2 box length")
        self.remaining = length - header
        return kind


def _pil_palette(entries: list, columns: int):
    """PIL's palette from ``pclr`` entries: each colour added with
    ``ImagePalette.getcolor``, which skips colours it already holds; the
    palette's bytes and its bytes per entry (4 for RGBA, else 3)."""
    mode_len = 4 if columns == 4 else 3
    palette = bytearray()
    colors = {}
    for color in entries:
        color = tuple(color)
        if color in colors:
            continue
        index = len(palette) // mode_len
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        colors[color] = index
        palette += bytes(color)
    return bytes(palette), mode_len


def _pil_jp2_header(blob: bytes, name: str):
    """``_parse_jp2_header``: PIL's (width, height), mode and palette."""
    reader = _BoxReader(blob, 12, None, name)
    header = None
    while reader.has_next():
        if reader.next_type() == b"jp2h":
            header = reader.sub_boxes()
            break
    if header is None:
        raise ValueError(f"{name}: no JP2 header box")
    size = mode = nc = None
    palette = None
    while header.has_next():
        kind = header.next_type()
        if kind == b"ihdr":
            height, width, nc, bpc = header.read(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            else:
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc)
        elif kind == b"colr" and nc == 4:
            meth, _, _, enumcs = header.read(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif kind == b"pclr" and mode in ("L", "LA"):
            entries, columns = header.read(">HB")
            depths = header.read(">" + "B" * columns)
            if max(depths, default=0) <= 8:
                palette = _pil_palette([header.read(">" + "B" * columns)
                                        for _ in range(entries)], columns)
                mode = "P" if mode == "L" else "PA"
        elif kind == b"res ":
            res = header.sub_boxes()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.read(">HHHHBB")
                    break
    if size is None or mode is None:
        raise ValueError(f"{name}: malformed JP2 header")
    return size, mode, palette


def _pil_codestream_header(blob: bytes, name: str):
    """``_parse_codestream`` and ``_parse_comment``: PIL's size and mode
    from the SIZ marker, and its walk over the main header's markers."""
    if len(blob) < 6:
        raise ValueError(f"{name}: the SIZ marker is cut short")
    lsiz = struct.unpack_from(">H", blob, 4)[0]
    siz = blob[4:4 + lsiz]
    if len(siz) < 38:
        raise ValueError(f"{name}: the SIZ marker is cut short")
    _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        if len(siz) < 39:
            raise ValueError(f"{name}: the SIZ marker is cut short")
        mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise ValueError(f"{name}: unable to determine J2K image mode ({csiz} components)")
    pos = 4 + len(siz)
    while True:
        marker = blob[pos:pos + 2]
        pos += 2
        if not marker:
            break
        if len(marker) < 2:
            raise ValueError(f"{name}: a marker is cut short")
        if marker[1] in (0x90, 0xD9):
            break
        if pos + 2 > len(blob):
            raise ValueError(f"{name}: a marker segment is cut short")
        length = struct.unpack_from(">H", blob, pos)[0]
        pos += 2
        if marker[1] == 0x64:
            break
        pos += length - 2
    return size, mode


# ---------------------------------------------------------------------------
# OpenJPEG's JP2 box checks (opj_jp2_read_header)
# ---------------------------------------------------------------------------


def _jp2_sub_boxes(body: bytes, name: str) -> dict:
    """``opj_jp2_read_jp2h``: the colour specification, the image header
    and the palette / component boxes it checks."""
    info = {"enumcs": 0, "ihdr": None}
    pos, end = 0, len(body)
    seen_colr = seen_pclr = seen_cmap = seen_cdef = False
    while end - pos > 0:
        if end - pos < 8:
            raise ValueError(f"{name}: a JP2 header sub-box is cut short")
        length, kind = struct.unpack_from(">I4s", body, pos)
        header = 8
        if length == 1:
            if end - pos < 16:
                raise ValueError(f"{name}: a JP2 XL sub-box is cut short")
            high, length = struct.unpack_from(">II", body, pos + 8)
            header = 16
            if high or length == 0:
                raise ValueError(f"{name}: a JP2 sub-box of undefined or huge size")
        elif length == 0:
            raise ValueError(f"{name}: a JP2 sub-box of undefined size")
        if length < header or length > end - pos:
            raise ValueError(f"{name}: a JP2 header sub-box length is inconsistent")
        data = body[pos + header:pos + length]
        if kind == b"ihdr":
            if len(data) != 14:
                raise ValueError(f"{name}: bad JP2 image header box")
            height, width, nc = struct.unpack_from(">IIH", data)
            if not width or not height or not 1 <= nc <= 16384:
                raise ValueError(f"{name}: bad JP2 image header box")
            if info["ihdr"] is None:
                info["ihdr"] = (width, height, nc, data[10])
        elif kind == b"colr":
            if len(data) < 3:
                raise ValueError(f"{name}: bad JP2 colour box")
            if not seen_colr:
                if data[0] == 1:
                    if len(data) < 7:
                        raise ValueError(f"{name}: bad JP2 colour box")
                    info["enumcs"] = struct.unpack_from(">I", data, 3)[0]
                    seen_colr = True
                elif data[0] == 2:
                    seen_colr = True
        elif kind == b"pclr":
            if seen_pclr or len(data) < 3:
                raise ValueError(f"{name}: bad JP2 palette box")
            entries, columns = struct.unpack_from(">HB", data)
            if not 1 <= entries <= 1024 or not columns or len(data) < 3 + columns:
                raise ValueError(f"{name}: bad JP2 palette box")
            width = sum(min(((b & 0x7F) + 8) >> 3, 4) for b in data[3:3 + columns])
            if len(data) < 3 + columns + entries * width:
                raise ValueError(f"{name}: bad JP2 palette box")
            seen_pclr = True
        elif kind == b"cmap":
            if not seen_pclr or seen_cmap:
                raise ValueError(f"{name}: a JP2 component mapping box without its palette")
            seen_cmap = True
        elif kind == b"cdef":
            if seen_cdef or len(data) < 2:
                raise ValueError(f"{name}: bad JP2 channel definition box")
            count = struct.unpack_from(">H", data)[0]
            if not count or len(data) < 2 + 6 * count:
                raise ValueError(f"{name}: bad JP2 channel definition box")
            seen_cdef = True
        elif kind == b"bpcc":
            if info["ihdr"] is not None and len(data) != info["ihdr"][2]:
                raise ValueError(f"{name}: bad JP2 bits per component box")
        pos += length
    if info["ihdr"] is None:
        raise ValueError(f"{name}: no JP2 image header box")
    return info


def _jp2_codestream(blob: bytes, name: str):
    """``opj_jp2_read_header_procedure``: the offset of the codestream in
    the ``jp2c`` box and OpenJPEG's colour space for the image."""
    pos = 0
    state = set()
    info = None
    while True:
        if len(blob) - pos < 8:
            break
        length, kind = struct.unpack_from(">I4s", blob, pos)
        header = 8
        if length == 0:
            length = len(blob) - pos
        elif length == 1:
            if len(blob) - pos < 16:
                break
            high, length = struct.unpack_from(">II", blob, pos + 8)
            header = 16
            if high:
                raise ValueError(f"{name}: a JP2 box of more than 2**32 bytes")
            if length == 0:
                raise ValueError(f"{name}: a JP2 box of undefined size")
        if kind == b"jp2c":
            if "header" not in state:
                raise ValueError(f"{name}: the codestream box comes before the JP2 header")
            colour = ENUMCS.get(info["enumcs"], UNKNOWN)
            return pos + header, colour, info
        if length < header:
            raise ValueError(f"{name}: invalid JP2 box size")
        body = blob[pos + header:pos + length]
        if kind in (b"jP  ", b"ftyp", b"jp2h"):
            if len(body) < length - header:
                raise ValueError(f"{name}: a JP2 box runs past the end of the file")
            if kind == b"jP  ":
                if state or body != b"\r\n\x87\n":
                    raise ValueError(f"{name}: bad JP2 signature box")
                state.add("signature")
            elif kind == b"ftyp":
                if state != {"signature"} or len(body) < 8 or (len(body) - 8) % 4:
                    raise ValueError(f"{name}: bad JP2 file type box")
                state.add("file_type")
            else:
                if "file_type" not in state:
                    raise ValueError(f"{name}: the JP2 header box comes before the file type box")
                info = _jp2_sub_boxes(body, name)
                state.add("header")
        else:
            if "signature" not in state or "file_type" not in state:
                raise ValueError(f"{name}: a JP2 file must start with its signature and "
                                 f"file type boxes")
            if pos + length > len(blob):
                raise ValueError(f"{name}: a JP2 box runs past the end of the file")
        pos += length
    if "header" not in state:
        raise ValueError(f"{name}: no JP2 header box")
    raise ValueError(f"{name}: no codestream box")


# ---------------------------------------------------------------------------
# The codestream's headers (opj_j2k_read_*)
# ---------------------------------------------------------------------------


class _Coding:
    """A component's coding style (COD / COC)."""
    __slots__ = ("levels", "cbw", "cbh", "style", "reversible", "precincts")

    def copy(self):
        out = _Coding()
        for slot in self.__slots__:
            setattr(out, slot, getattr(self, slot))
        return out


class _Quant:
    """A component's quantisation (QCD / QCC): style, guard bits and one
    (exponent, mantissa) per band."""
    __slots__ = ("style", "guard", "steps")

    def copy(self):
        out = _Quant()
        out.style, out.guard, out.steps = self.style, self.guard, list(self.steps)
        return out


class _TileParams:
    """What OpenJPEG keeps per tile (its ``opj_tcp_t``): copied from the
    main header's at the tile's first tile-part."""

    def __init__(self, ncomp: int):
        self.csty = 0
        self.order = LRCP
        self.layers = 1
        self.mct = 0
        self.coding = [None] * ncomp
        self.quant = [None] * ncomp
        self.roi = [0] * ncomp
        self.pocs = []
        self.ppt = {}
        self.parts = []
        self.nparts = 0
        self.seen = False

    def copy(self):
        out = _TileParams(len(self.coding))
        out.csty, out.order, out.layers, out.mct = self.csty, self.order, self.layers, self.mct
        out.coding = [c.copy() if c is not None else None for c in self.coding]
        out.quant = [q.copy() if q is not None else None for q in self.quant]
        out.roi = list(self.roi)
        out.pocs = list(self.pocs)
        return out


class _Component:
    __slots__ = ("precision", "signed", "dx", "dy")


class _Image:
    """The SIZ marker."""

    def __init__(self, body: bytes, name: str):
        if len(body) < 36:
            raise ValueError(f"{name}: bad SIZ marker size")
        (self.rsiz, self.x1, self.y1, self.x0, self.y0, self.tdx, self.tdy, self.tx0, self.ty0,
         ncomp) = struct.unpack_from(">HIIIIIIIIH", body)
        count, rest = divmod(len(body) - 36, 3)
        if count > 16384 or rest or count != ncomp or not ncomp:
            raise ValueError(f"{name}: bad SIZ marker ({ncomp} components)")
        if self.rsiz & 0x4000:
            raise NotImplementedError(f"{name}: HTJ2K (Part 15) codestreams are not supported "
                                      f"(Rsiz {self.rsiz:#06x})")
        if self.rsiz & 0x8000:
            raise NotImplementedError(f"{name}: Part-2 (JPX extension) codestreams are not "
                                      f"supported (Rsiz {self.rsiz:#06x})")
        if self.x0 >= self.x1 or self.y0 >= self.y1:
            raise ValueError(f"{name}: negative or zero image size in SIZ")
        if not self.tdx or not self.tdy:
            raise ValueError(f"{name}: invalid tile size in SIZ")
        if (self.tx0 > self.x0 or self.ty0 > self.y0 or self.tx0 + self.tdx <= self.x0
                or self.ty0 + self.tdy <= self.y0):
            raise ValueError(f"{name}: illegal tile offset in SIZ")
        self.components = []
        for k in range(ncomp):
            ssiz, dx, dy = body[36 + 3 * k:39 + 3 * k]
            comp = _Component()
            comp.precision, comp.signed, comp.dx, comp.dy = (ssiz & 0x7F) + 1, ssiz >> 7, dx, dy
            if not 1 <= dx <= 255 or not 1 <= dy <= 255:
                raise ValueError(f"{name}: component {k} has subsampling {dx} x {dy}")
            if comp.precision > 31:
                raise ValueError(f"{name}: component {k} has {comp.precision} bits")
            self.components.append(comp)
        self.tw = _ceildiv(self.x1 - self.tx0, self.tdx)
        self.th = _ceildiv(self.y1 - self.ty0, self.tdy)
        if not self.tw or not self.th or self.tw * self.th > 65535:
            raise ValueError(f"{name}: invalid number of tiles {self.tw} x {self.th}")

    def tile_bounds(self, index: int):
        p, q = index % self.tw, index // self.tw
        return (max(self.tx0 + p * self.tdx, self.x0), max(self.ty0 + q * self.tdy, self.y0),
                min(self.tx0 + (p + 1) * self.tdx, self.x1),
                min(self.ty0 + (q + 1) * self.tdy, self.y1))


def _component_index(body: bytes, pos: int, ncomp: int):
    if ncomp <= 256:
        return body[pos], pos + 1
    return struct.unpack_from(">H", body, pos)[0], pos + 2


def _read_spcod(body: bytes, pos: int, with_precincts: bool, name: str) -> _Coding:
    """SPcod / SPcoc (``opj_j2k_read_SPCod_SPCoc``)."""
    if len(body) < pos + 5:
        raise ValueError(f"{name}: bad COD / COC marker")
    coding = _Coding()
    levels, cbw, cbh, style, transform = body[pos:pos + 5]
    coding.levels, coding.cbw, coding.cbh = levels, cbw + 2, cbh + 2
    coding.style, coding.reversible = style, transform == 1
    if levels + 1 > 33:
        raise ValueError(f"{name}: {levels} decomposition levels")
    if coding.cbw > 10 or coding.cbh > 10 or coding.cbw + coding.cbh > 12:
        raise ValueError(f"{name}: invalid code-block size 2**{coding.cbw} x 2**{coding.cbh}")
    if style & 0xC0:
        raise NotImplementedError(f"{name}: HTJ2K (Part 15) code-blocks are not supported "
                                  f"(code-block style {style:#04x})")
    if transform > 1:
        raise ValueError(f"{name}: invalid wavelet transformation {transform}")
    pos += 5
    if with_precincts:
        if len(body) < pos + levels + 1:
            raise ValueError(f"{name}: bad COD / COC precinct sizes")
        coding.precincts = []
        for r, value in enumerate(body[pos:pos + levels + 1]):
            if r and (not value & 0xF or not value >> 4):
                raise ValueError(f"{name}: invalid precinct size")
            coding.precincts.append((value & 0xF, value >> 4))
    else:
        coding.precincts = [(15, 15)] * (levels + 1)
    return coding


def _read_sqcd(body: bytes, pos: int, name: str) -> _Quant:
    """SQcd / SQcc (``opj_j2k_read_SQcd_SQcc``)."""
    if len(body) < pos + 1:
        raise ValueError(f"{name}: bad QCD / QCC marker")
    quant = _Quant()
    quant.style, quant.guard = body[pos] & 0x1F, body[pos] >> 5
    rest = body[pos + 1:]
    if quant.style == 0:
        quant.steps = [(b >> 3, 0) for b in rest[:97]]
    else:
        count = 1 if quant.style == 1 else len(rest) // 2
        if len(rest) < 2 * count:
            raise ValueError(f"{name}: bad QCD / QCC marker")
        quant.steps = [(v >> 11, v & 0x7FF) for v in
                       struct.unpack_from(f">{min(count, 97)}H", rest)]
        if quant.style == 1:
            expn, mant = quant.steps[0]
            quant.steps = [(expn, mant)] + [(max(expn - (b - 1) // 3, 0), mant)
                                            for b in range(1, 97)]
    return quant


class _Codestream:
    """The main header, then every tile-part in codestream order."""

    def __init__(self, blob: bytes, name: str, jp2_size=None):
        self.name = name
        self.blob = blob
        if blob[:2] != b"\xff\x4f":
            raise ValueError(f"{name}: no SOC marker")
        if blob[2:4] != b"\xff\x51":
            raise ValueError(f"{name}: the SIZ marker must follow SOC")
        pos = 4
        body, pos = self._segment(pos)
        self.image = _Image(body, name)
        if jp2_size is not None and jp2_size != (self.image.x1 - self.image.x0,
                                                 self.image.y1 - self.image.y0):
            raise ValueError(f"{name}: the JP2 image header's size {jp2_size} is not SIZ's")
        ncomp = len(self.image.components)
        self.default = _TileParams(ncomp)
        self.ppm = {}
        have_cod = have_qcd = False
        while True:
            marker, pos = self._marker(pos, main=True)
            if marker == 0xFF90:
                break
            body, pos = self._segment(pos)
            if marker == 0xFF52:
                self._cod(self.default, body)
                have_cod = True
            elif marker == 0xFF5C:
                self._qcd(self.default, body)
                have_qcd = True
            elif marker == 0xFF60:
                self.ppm.setdefault(body[0] if body else 0, body)
                if len(body) < 2:
                    raise ValueError(f"{name}: bad PPM marker")
            else:
                self._common(self.default, marker, body)
        if not have_cod:
            raise ValueError(f"{name}: no COD marker in the main header")
        if not have_qcd:
            raise ValueError(f"{name}: no QCD marker in the main header")
        self.tiles = {}
        self.order = []
        self._tile_parts(pos)

    def _marker(self, pos: int, main: bool):
        """The marker at ``pos`` and the position after it, as OpenJPEG
        reads a main (``main``) or tile-part header: an unknown marker
        skipped by a scan for the next known one, a known one out of its
        place an error."""
        blob, name = self.blob, self.name
        if pos + 2 > len(blob):
            raise ValueError(f"{name}: the codestream ends in a header")
        marker = struct.unpack_from(">H", blob, pos)[0]
        if marker < 0xFF00:
            raise ValueError(f"{name}: a marker was expected at byte {pos}")
        pos += 2
        while marker not in KNOWN:
            if pos + 2 > len(blob):
                raise ValueError(f"{name}: unknown marker {marker:#06x}, then the codestream "
                                 f"ends")
            word = struct.unpack_from(">H", blob, pos)[0]
            pos += 2
            if word >= 0xFF00 and word in KNOWN:
                marker = word
        if marker in REFUSED_MARKERS:
            raise NotImplementedError(f"{name}: {REFUSED_MARKERS[marker]} is not supported")
        if marker not in BOTH and marker not in (MAIN_ONLY if main else TILE_ONLY):
            raise ValueError(f"{name}: marker {marker:#06x} out of its place")
        return marker, pos

    def _segment(self, pos: int):
        if pos + 2 > len(self.blob):
            raise ValueError(f"{self.name}: a marker segment is cut short")
        length = struct.unpack_from(">H", self.blob, pos)[0]
        if length < 2 or pos + length > len(self.blob):
            raise ValueError(f"{self.name}: a marker segment is cut short")
        return self.blob[pos + 2:pos + length], pos + length

    def _cod(self, tcp: _TileParams, body: bytes):
        if len(body) < 5:
            raise ValueError(f"{self.name}: bad COD marker")
        csty, order, layers, mct = struct.unpack_from(">BBHB", body)
        if csty & ~7:
            raise ValueError(f"{self.name}: unknown Scod value {csty}")
        if order > CPRL:
            raise ValueError(f"{self.name}: unknown progression order {order}")
        if not layers:
            raise ValueError(f"{self.name}: no quality layers")
        if mct > 1:
            raise ValueError(f"{self.name}: invalid multiple component transformation {mct}")
        tcp.csty, tcp.order, tcp.layers, tcp.mct = csty, order, layers, mct
        coding = _read_spcod(body, 5, bool(csty & 1), self.name)
        tcp.coding = [coding.copy() for _ in tcp.coding]

    def _qcd(self, tcp: _TileParams, body: bytes):
        quant = _read_sqcd(body, 0, self.name)
        tcp.quant = [quant.copy() for _ in tcp.quant]

    def _common(self, tcp: _TileParams, marker: int, body: bytes):
        """COC, QCC, RGN, POC and CRG; TLM, PLM, PLT and COM are skipped."""
        ncomp = len(self.image.components)
        if marker == 0xFF53:
            if len(body) < (2 if ncomp <= 256 else 3):
                raise ValueError(f"{self.name}: bad COC marker")
            comp, pos = _component_index(body, 0, ncomp)
            if comp >= ncomp:
                raise ValueError(f"{self.name}: COC of component {comp}")
            tcp.coding[comp] = _read_spcod(body, pos + 1, bool(body[pos] & 1), self.name)
        elif marker == 0xFF5D:
            if len(body) < (2 if ncomp <= 256 else 3):
                raise ValueError(f"{self.name}: bad QCC marker")
            comp, pos = _component_index(body, 0, ncomp)
            if comp >= ncomp:
                raise ValueError(f"{self.name}: QCC of component {comp}")
            tcp.quant[comp] = _read_sqcd(body, pos, self.name)
        elif marker == 0xFF5E:
            if len(body) != (3 if ncomp <= 256 else 4):
                raise ValueError(f"{self.name}: bad RGN marker")
            comp, pos = _component_index(body, 0, ncomp)
            if comp >= ncomp:
                raise ValueError(f"{self.name}: RGN of component {comp}")
            tcp.roi[comp] = body[pos + 1]
        elif marker == 0xFF5F:
            room = 1 if ncomp <= 256 else 2
            chunk = 5 + 2 * room
            count, rest = divmod(len(body), chunk)
            if not count or rest or len(tcp.pocs) + count >= 32:
                raise ValueError(f"{self.name}: bad POC marker")
            fmt = ">BBHBBB" if room == 1 else ">BHHBHB"
            for k in range(count):
                res0, comp0, layer1, res1, comp1, order = struct.unpack_from(fmt, body,
                                                                             k * chunk)
                tcp.pocs.append((res0, comp0, layer1, res1, min(comp1, ncomp), order))
        elif marker == 0xFF63 and len(body) != 4 * ncomp:
            raise ValueError(f"{self.name}: bad CRG marker")

    def _tile_parts(self, pos: int):
        """Every tile-part: its header markers into the tile's parameters,
        its data onto the tile's; a tile whose TNsot parts are all read is
        queued for decoding then, the rest at the end of the codestream."""
        blob, name = self.blob, self.name
        ntiles = self.image.tw * self.image.th
        marker = 0xFF90
        while True:
            if marker != 0xFF90:
                raise ValueError(f"{name}: expected SOT, found marker {marker:#06x}")
            body, after = self._segment(pos)
            if len(body) != 8:
                raise ValueError(f"{name}: bad SOT marker")
            start = pos - 2
            index, psot, part, nparts = struct.unpack_from(">HIBB", body)
            if index >= ntiles:
                raise ValueError(f"{name}: tile {index} of {ntiles}")
            if psot and psot < 14 and psot != 12:
                raise ValueError(f"{name}: Psot {psot}")
            tcp = self.tiles.get(index)
            if tcp is None:
                tcp = self.default.copy()
                self.tiles[index] = tcp
            if part != len(tcp.parts):
                raise ValueError(f"{name}: tile-part {part} of tile {index}, expected "
                                 f"{len(tcp.parts)}")
            if tcp.nparts and part >= tcp.nparts:
                raise ValueError(f"{name}: tile-part {part} of a tile of {tcp.nparts}")
            if nparts:
                tcp.nparts = nparts
            pos = after
            while True:
                marker, pos = self._marker(pos, main=False)
                if marker == 0xFF93:
                    break
                body, pos = self._segment(pos)
                if psot and start + psot < pos:
                    raise ValueError(f"{name}: a tile-part header outruns its Psot")
                if marker == 0xFF52:
                    self._cod(tcp, body)
                elif marker == 0xFF5C:
                    self._qcd(tcp, body)
                elif marker == 0xFF61:
                    if len(body) < 2:
                        raise ValueError(f"{name}: bad PPT marker")
                    if self.ppm:
                        raise ValueError(f"{name}: PPT after PPM")
                    tcp.ppt.setdefault(body[0], body[1:])
                else:
                    self._common(tcp, marker, body)
            if psot:
                end = start + psot
                if end > len(blob):
                    raise ValueError(f"{name}: tile-part length inconsistent with the "
                                     f"stream length")
            else:
                end = len(blob) - 2
            tcp.parts.append(blob[pos:max(end, pos)])
            pos = end
            if tcp.nparts and len(tcp.parts) == tcp.nparts and index not in self.order:
                self.order.append(index)
            if not psot:
                break
            if pos + 2 > len(blob):
                raise ValueError(f"{name}: the codestream ends without EOC")
            if blob[pos:pos + 2] == b"\xff\xd9":
                break
            marker, pos = self._marker(pos, main=False)
        for index in sorted(self.tiles):
            if index not in self.order and self.tiles[index].parts:
                self.order.append(index)

    def packed_headers(self) -> bytes:
        """The packet headers of every PPM marker, their Nppm fields
        dropped (``opj_j2k_merge_ppm``)."""
        data = b"".join(self.ppm[k][1:] for k in sorted(self.ppm))
        out, pos = [], 0
        while pos < len(data):
            if len(data) - pos < 4:
                raise ValueError(f"{self.name}: not enough bytes to read Nppm")
            count = struct.unpack_from(">I", data, pos)[0]
            out.append(data[pos + 4:pos + 4 + count])
            pos += 4 + count
        return b"".join(out)


# ---------------------------------------------------------------------------
# Tier-2: the tile's structure and its packets
# ---------------------------------------------------------------------------


class _Bits:
    """``opj_bio``: packet-header bits, MSB first, a 0 bit stuffed after
    each 0xFF byte; zeros past the end."""
    __slots__ = ("data", "pos", "end", "buf", "ct")

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end, self.buf, self.ct = data, pos, end, 0, 0

    def _byte_in(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.pos < self.end:
            self.buf |= self.data[self.pos]
            self.pos += 1

    def bit(self) -> int:
        if self.ct == 0:
            self._byte_in()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, count: int) -> int:
        value = 0
        for _ in range(count):
            value = (value << 1) | self.bit()
        return value

    def align(self):
        if self.buf & 0xFF == 0xFF:
            self._byte_in()
        self.ct = 0


class _TagTree:
    """``opj_tgt``: a tag tree over ``width`` x ``height`` leaves."""

    def __init__(self, width: int, height: int):
        sizes = [(width, height)]
        while sizes[-1][0] * sizes[-1][1] > 1:
            w, h = sizes[-1]
            sizes.append(((w + 1) // 2, (h + 1) // 2))
        offsets = [0]
        for w, h in sizes:
            offsets.append(offsets[-1] + w * h)
        self.parent = []
        for level, (w, h) in enumerate(sizes):
            for j in range(h):
                for i in range(w):
                    if level + 1 < len(sizes):
                        self.parent.append(offsets[level + 1] + (j // 2) * sizes[level + 1][0]
                                           + i // 2)
                    else:
                        self.parent.append(-1)
        self.value = [999] * len(self.parent)
        self.low = [0] * len(self.parent)

    def decode(self, bits: _Bits, leaf: int, threshold: int) -> bool:
        path = []
        node = leaf
        while self.parent[node] >= 0:
            path.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bits.bit():
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not path:
                break
            node = path.pop()
        return self.value[node] < threshold


class _Block:
    """A code-block: its place in its band and what tier-2 gathered."""
    __slots__ = ("x0", "y0", "x1", "y1", "numbps", "lblock", "segments", "filled")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.numbps = 0
        self.lblock = 3
        self.segments = []  # [max passes, passes, chunks]
        self.filled = 0  # segments that received data


class _Band:
    __slots__ = ("orient", "x0", "y0", "x1", "y1", "numbps", "stepsize", "precincts")


class _Resolution:
    __slots__ = ("x0", "y0", "x1", "y1", "pdx", "pdy", "pw", "ph", "bands")


def _segment_max_passes(style: int, previous) -> int:
    """``opj_t2_init_seg``: how many passes a codeword segment holds."""
    if style & t1.TERMALL:
        return 1
    if style & t1.BYPASS:
        if previous is None:
            return 10
        return 2 if previous in (1, 10) else 1
    return 109


class _TileComponent:
    """A tile-component's resolutions, bands, precincts and code-blocks
    (``opj_tcd_init_tile``)."""

    def __init__(self, image: _Image, comp: int, bounds, coding: _Coding, quant: _Quant):
        component = image.components[comp]
        tx0, ty0, tx1, ty1 = bounds
        self.x0, self.y0 = _ceildiv(tx0, component.dx), _ceildiv(ty0, component.dy)
        self.x1, self.y1 = _ceildiv(tx1, component.dx), _ceildiv(ty1, component.dy)
        self.coding = coding
        nres = coding.levels + 1
        self.resolutions = []
        for r in range(nres):
            level = nres - 1 - r
            res = _Resolution()
            res.x0, res.y0 = _ceildivpow2(self.x0, level), _ceildivpow2(self.y0, level)
            res.x1, res.y1 = _ceildivpow2(self.x1, level), _ceildivpow2(self.y1, level)
            res.pdx, res.pdy = coding.precincts[r]
            px0 = (res.x0 >> res.pdx) << res.pdx
            py0 = (res.y0 >> res.pdy) << res.pdy
            px1 = _ceildivpow2(res.x1, res.pdx) << res.pdx
            py1 = _ceildivpow2(res.y1, res.pdy) << res.pdy
            res.pw = 0 if res.x0 == res.x1 else (px1 - px0) >> res.pdx
            res.ph = 0 if res.y0 == res.y1 else (py1 - py0) >> res.pdy
            if r == 0:
                cbgx0, cbgy0, cbgw, cbgh = px0, py0, res.pdx, res.pdy
            else:
                cbgx0, cbgy0 = _ceildivpow2(px0, 1), _ceildivpow2(py0, 1)
                cbgw, cbgh = res.pdx - 1, res.pdy - 1
            cbw, cbh = min(coding.cbw, cbgw), min(coding.cbh, cbgh)
            res.bands = []
            for orient in ((0,) if r == 0 else (1, 2, 3)):
                band = _Band()
                band.orient = orient
                if r == 0:
                    band.x0, band.y0 = _ceildivpow2(self.x0, level), _ceildivpow2(self.y0, level)
                    band.x1, band.y1 = _ceildivpow2(self.x1, level), _ceildivpow2(self.y1, level)
                    index = 0
                else:
                    xb, yb = orient & 1, orient >> 1
                    band.x0 = _ceildivpow2(self.x0 - (xb << level), level + 1)
                    band.y0 = _ceildivpow2(self.y0 - (yb << level), level + 1)
                    band.x1 = _ceildivpow2(self.x1 - (xb << level), level + 1)
                    band.y1 = _ceildivpow2(self.y1 - (yb << level), level + 1)
                    index = 3 * (r - 1) + orient
                expn, mant = quant.steps[index] if index < len(quant.steps) else (0, 0)
                # Only the 9/7 path reads the step, and OpenJPEG's decoder
                # gives its bands no gain there (2 / K in the wavelet instead).
                band.stepsize = float(np.float32((1.0 + mant / 2048.0)
                                                 * 2.0 ** (component.precision - expn)))
                band.numbps = expn + quant.guard - 1
                band.precincts = []
                for p in range(res.pw * res.ph):
                    gx0 = cbgx0 + (p % res.pw) * (1 << cbgw)
                    gy0 = cbgy0 + (p // res.pw) * (1 << cbgh)
                    x0, y0 = max(gx0, band.x0), max(gy0, band.y0)
                    x1 = min(gx0 + (1 << cbgw), band.x1)
                    y1 = min(gy0 + (1 << cbgh), band.y1)
                    bx0, by0 = (x0 >> cbw) << cbw, (y0 >> cbh) << cbh
                    cw = max(0, (_ceildivpow2(x1, cbw) << cbw) - bx0) >> cbw
                    ch = max(0, (_ceildivpow2(y1, cbh) << cbh) - by0) >> cbh
                    blocks = []
                    for k in range(cw * ch):
                        cx0 = bx0 + (k % cw) * (1 << cbw)
                        cy0 = by0 + (k // cw) * (1 << cbh)
                        blocks.append(_Block(max(cx0, x0), max(cy0, y0),
                                             min(cx0 + (1 << cbw), x1), min(cy0 + (1 << cbh), y1)))
                    band.precincts.append((blocks, _TagTree(cw, ch), _TagTree(cw, ch)))
                res.bands.append(band)
            self.resolutions.append(res)


def _progression(image: _Image, tcp: _TileParams, comps: list, bounds) -> list:
    """The tile's packets as (layer, resolution, component, precinct) in
    codestream order (``opj_pi_next_*``), each packet once."""
    tx0, ty0, tx1, ty1 = bounds
    ncomp = len(comps)
    max_res = max(len(c.resolutions) for c in comps)
    if tcp.pocs:
        runs = [(res0, comp0, min(layer1, tcp.layers), res1, comp1, order)
                for res0, comp0, layer1, res1, comp1, order in tcp.pocs]
    else:
        runs = [(0, 0, tcp.layers, max_res, ncomp, tcp.order)]
    seen = set()
    out = []

    def emit(layer, r, c, p):
        key = (layer, r, c, p)
        if key not in seen:
            seen.add(key)
            out.append(key)

    def positions(c, r):
        """Where the position orders meet each precinct of component ``c``
        at resolution ``r``: {(y, x): precinct} on the reference grid
        (T.800 B.12.1.3-5, as OpenJPEG tests it)."""
        comp = comps[c]
        if r >= len(comp.resolutions):
            return None
        res = comp.resolutions[r]
        dx, dy = image.components[c].dx, image.components[c].dy
        level = len(comp.resolutions) - 1 - r
        rpx, rpy = res.pdx + level, res.pdy + level
        trx0, try0 = _ceildiv(tx0, dx << level), _ceildiv(ty0, dy << level)
        trx1, try1 = _ceildiv(tx1, dx << level), _ceildiv(ty1, dy << level)
        if not res.pw or not res.ph or trx0 == trx1 or try0 == try1:
            return None
        return (dx, dy, level, rpx, rpy, trx0, try0, res)

    def hit(info, x, y):
        dx, dy, level, rpx, rpy, trx0, try0, res = info
        if not (y % (dy << rpy) == 0 or (y == ty0 and (try0 << level) % (1 << rpy))):
            return None
        if not (x % (dx << rpx) == 0 or (x == tx0 and (trx0 << level) % (1 << rpx))):
            return None
        prci = (_ceildiv(x, dx << level) >> res.pdx) - (trx0 >> res.pdx)
        prcj = (_ceildiv(y, dy << level) >> res.pdy) - (try0 >> res.pdy)
        return prci + prcj * res.pw

    def steps(pairs):
        ddx = ddy = 0
        for c, r in pairs:
            comp = comps[c]
            res = comp.resolutions[r]
            level = len(comp.resolutions) - 1 - r
            sx = image.components[c].dx << (res.pdx + level)
            sy = image.components[c].dy << (res.pdy + level)
            ddx = sx if not ddx else min(ddx, sx)
            ddy = sy if not ddy else min(ddy, sy)
        return ddx, ddy

    def walk(start, stop, step):
        value = start
        while value < stop:
            yield value
            value += step - value % step

    for res0, comp0, layer1, res1, comp1, order in runs:
        if order in (LRCP, RLCP):
            outer = ((layer, r) for layer in range(layer1) for r in range(res0, res1)) \
                if order == LRCP else ((layer, r) for r in range(res0, res1)
                                       for layer in range(layer1))
            for layer, r in outer:
                for c in range(comp0, comp1):
                    if r >= len(comps[c].resolutions):
                        continue
                    res = comps[c].resolutions[r]
                    for p in range(res.pw * res.ph):
                        emit(layer, r, c, p)
            continue
        if order == CPRL:
            for c in range(comp0, comp1):
                ddx, ddy = steps([(c, r) for r in range(len(comps[c].resolutions))])
                if not ddx or not ddy:
                    continue
                infos = [(r, positions(c, r)) for r in
                         range(res0, min(res1, len(comps[c].resolutions)))]
                for y in walk(ty0, ty1, ddy):
                    for x in walk(tx0, tx1, ddx):
                        for r, info in infos:
                            if info is not None:
                                p = hit(info, x, y)
                                if p is not None:
                                    for layer in range(layer1):
                                        emit(layer, r, c, p)
            continue
        ddx, ddy = steps([(c, r) for c in range(ncomp)
                          for r in range(len(comps[c].resolutions))])
        if not ddx or not ddy:
            continue
        infos = {(c, r): positions(c, r) for c in range(comp0, comp1)
                 for r in range(res0, res1)}
        if order == RPCL:
            for r in range(res0, res1):
                for y in walk(ty0, ty1, ddy):
                    for x in walk(tx0, tx1, ddx):
                        for c in range(comp0, comp1):
                            info = infos[(c, r)]
                            if info is not None:
                                p = hit(info, x, y)
                                if p is not None:
                                    for layer in range(layer1):
                                        emit(layer, r, c, p)
        else:  # PCRL
            for y in walk(ty0, ty1, ddy):
                for x in walk(tx0, tx1, ddx):
                    for c in range(comp0, comp1):
                        for r in range(res0, min(res1, len(comps[c].resolutions))):
                            info = infos[(c, r)]
                            if info is not None:
                                p = hit(info, x, y)
                                if p is not None:
                                    for layer in range(layer1):
                                        emit(layer, r, c, p)
    return out


def _num_passes(bits: _Bits) -> int:
    if not bits.bit():
        return 1
    if not bits.bit():
        return 2
    n = bits.bits(2)
    if n != 3:
        return 3 + n
    n = bits.bits(5)
    if n != 31:
        return 6 + n
    return 37 + bits.bits(7)


class _Packets:
    """Tier-2 over one tile's data (``opj_t2_decode_packets``), its packet
    headers from the data, a PPT buffer or the PPM buffer."""

    def __init__(self, data: bytes, csty: int, headers, name: str):
        self.data, self.pos, self.csty, self.name = data, 0, csty, name
        self.headers = headers  # [bytes, position] or None

    def read(self, comp: _TileComponent, r: int, p: int, layer: int):
        data, name = self.data, self.name
        if self.csty & SOP and len(data) - self.pos >= 6 and data[self.pos:self.pos + 2] \
                == b"\xff\x91":
            self.pos += 6
        if self.headers is not None:
            source, start = self.headers
        else:
            source, start = data, self.pos
        bits = _Bits(source, start, len(source))
        included = []
        if bits.bit():
            style = comp.coding.style
            for band in comp.resolutions[r].bands:
                if band.x1 == band.x0 or band.y1 == band.y0:
                    continue
                blocks, inclusion, msb = band.precincts[p]
                for k, block in enumerate(blocks):
                    if not block.filled:
                        if not inclusion.decode(bits, k, layer + 1):
                            continue
                        zeros = 0
                        while not msb.decode(bits, k, zeros):
                            zeros += 1
                        block.numbps = band.numbps + 1 - zeros
                        block.lblock = 3
                    elif not bits.bit():
                        continue
                    passes = _num_passes(bits)
                    while bits.bit():
                        block.lblock += 1
                    segments = block.segments
                    if not block.filled:
                        index = 0
                        if not segments:
                            segments.append([_segment_max_passes(style, None), 0, []])
                    else:
                        index = block.filled - 1
                        if segments[index][1] == segments[index][0]:
                            index += 1
                            if len(segments) <= index:
                                segments.append([_segment_max_passes(style, segments[index - 1][0]),
                                                 0, []])
                    new = []
                    while True:
                        take = min(segments[index][0] - segments[index][1], passes)
                        width = block.lblock + (take.bit_length() - 1)
                        if width > 32:
                            raise ValueError(f"{name}: invalid length width {width}")
                        new.append((index, take, bits.bits(width)))
                        passes -= take
                        if passes <= 0:
                            break
                        index += 1
                        if len(segments) <= index:
                            segments.append([_segment_max_passes(style, segments[index - 1][0]),
                                             0, []])
                    included.append((block, new))
        bits.align()
        end = bits.pos
        if self.csty & EPH:
            if source[end:end + 2] != b"\xff\x92":
                raise ValueError(f"{name}: a packet header does not end with EPH")
            end += 2
        if self.headers is not None:
            self.headers[1] = end
        else:
            self.pos = end
        for block, new in included:
            for index, take, length in new:
                if self.pos + length > len(data):
                    raise ValueError(f"{name}: a code-block segment runs past the tile data")
                block.segments[index][2].append(data[self.pos:self.pos + length])
                block.segments[index][1] += take
                self.pos += length
                block.filled = max(block.filled, index + 1)


# ---------------------------------------------------------------------------
# One tile: tier-2, tier-1, wavelets, colour transform, level shift
# ---------------------------------------------------------------------------


def _decode_tile(stream: _Codestream, index: int, ppm) -> tuple:
    """``opj_tcd_decode_tile`` of tile ``index``: its bounds on the
    reference grid and one int64 plane per component, clamped to the
    component's range."""
    image, name = stream.image, stream.name
    tcp = stream.tiles[index]
    bounds = image.tile_bounds(index)
    for c in range(len(image.components)):
        if tcp.coding[c] is None or tcp.quant[c] is None:
            raise ValueError(f"{name}: component {c} has no coding style or quantisation")
    comps = [_TileComponent(image, c, bounds, tcp.coding[c], tcp.quant[c])
             for c in range(len(image.components))]
    data = b"".join(tcp.parts)
    if ppm is not None:
        headers = ppm
    elif tcp.ppt:
        headers = [b"".join(tcp.ppt[k] for k in sorted(tcp.ppt)), 0]
    else:
        headers = None
    packets = _Packets(data, tcp.csty, headers, name)
    for layer, r, c, p in _progression(image, tcp, comps, bounds):
        packets.read(comps[c], r, p, layer)

    planes = []
    for c, comp in enumerate(comps):
        coding = comp.coding
        roi = tcp.roi[c]
        bands = []
        for res in comp.resolutions:
            arrays = []
            for band in res.bands:
                dtype = np.int32 if coding.reversible else np.float32
                out = np.zeros((band.y1 - band.y0, band.x1 - band.x0), dtype=dtype)
                for blocks, _, _ in band.precincts:
                    for block in blocks:
                        width, height = block.x1 - block.x0, block.y1 - block.y0
                        if width <= 0 or height <= 0:
                            continue
                        segments = [(b"".join(chunks), passes)
                                    for _, passes, chunks in block.segments[:block.filled]]
                        values = t1.decode_codeblock(segments, width, height, band.orient,
                                                     block.numbps, roi, coding.style, name)
                        out[block.y0 - band.y0:block.y1 - band.y0,
                            block.x0 - band.x0:block.x1 - band.x0] = t1.reconstruct(
                                values, roi, coding.reversible, band.stepsize)
                arrays.append(out)
            bands.append(arrays)
        plane = bands[0][0]
        if not coding.reversible:
            plane = plane.astype(np.float32)
        for r in range(1, len(comp.resolutions)):
            res = comp.resolutions[r]
            hl, lh, hh = bands[r]
            plane = t1.inverse_level(plane, hl, lh, hh, res.x0, res.y0, coding.reversible)
        planes.append(plane.astype(np.int64) if coding.reversible else plane)

    if tcp.mct and len(comps) >= 3:
        if any(planes[k].shape != planes[0].shape for k in (1, 2)) or \
                len({len(comps[k].resolutions) for k in range(3)}) != 1:
            raise ValueError(f"{name}: tiles don't all have the same dimension for the "
                             f"component transform")
        transform = t1.inverse_rct if comps[0].coding.reversible else t1.inverse_ict
        planes[:3] = transform(*planes[:3])
    out = []
    for c, plane in enumerate(planes):
        component = image.components[c]
        out.append(t1.level_shift(plane, comps[c].coding.reversible, component.precision,
                                  bool(component.signed)))
    return bounds, out


# ---------------------------------------------------------------------------
# PIL's tile unpackers (Jpeg2KDecode.c) and convert("RGB")
# ---------------------------------------------------------------------------


def _word_size(precision: int) -> int:
    size = (precision + 7) >> 3
    return 4 if size == 3 else size


def _ycbcr_tables():
    """PIL's ``ConvertYCbCr.c`` tables (SCALE 6): ``(int)(f * 64 * (i -
    128) + 0.5)`` truncated toward zero."""
    i = np.arange(256, dtype=np.float64) - 128
    def table(f):
        return np.trunc(f * 64 * i + 0.5).astype(np.int64)
    return table(1.40200), table(-0.34414), table(-0.71414), table(1.77200)


R_CR, G_CB, G_CR, B_CB = _ycbcr_tables()


def ycbcr_to_rgb(ycbcr: np.ndarray) -> np.ndarray:
    """PIL's ``ImagingConvertYCbCr2RGB`` of (..., 3) uint8."""
    y, cb, cr = (ycbcr[..., k].astype(np.int64) for k in range(3))
    rgb = np.stack([y + (R_CR[cr] >> 6), y + ((G_CB[cb] + G_CR[cr]) >> 6), y + (B_CB[cb] >> 6)],
                   axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


# (colour space, components, PIL mode) -> (unpacker, takes subsampled components)
UNPACKERS = {
    (GRAY, 1, "L"): ("gray_l", False), (SRGB, 1, "P"): ("gray_l", False),
    (SRGB, 2, "PA"): ("graya_la", False), (GRAY, 1, "I;16"): ("gray_i", False),
    (GRAY, 2, "LA"): ("graya_la", False),
    (GRAY, 1, "RGB"): ("gray_rgb", False), (GRAY, 2, "RGB"): ("gray_rgb", False),
    (SRGB, 3, "RGB"): ("srgb_rgb", True), (SYCC, 3, "RGB"): ("sycc_rgb", True),
    (SRGB, 4, "RGB"): ("srgb_rgb", True), (SYCC, 4, "RGB"): ("sycc_rgb", True),
    (GRAY, 1, "RGBA"): ("graya_la", False), (GRAY, 2, "RGBA"): ("graya_la", False),
    (SRGB, 3, "RGBA"): ("srgba_rgba", True), (SYCC, 3, "RGBA"): ("sycca_rgba", True),
    (SRGB, 4, "RGBA"): ("srgba_rgba", True), (SYCC, 4, "RGBA"): ("sycca_rgba", True),
    (CMYK, 4, "CMYK"): ("srgba_rgba", True),
}


class _TileData:
    """OpenJPEG's tile buffer (``opj_tcd_update_tile_data``): each
    component's samples as little-endian words of 1, 2 or 4 bytes, one
    component after another; read back as PIL's unpackers index it."""

    def __init__(self, image: _Image, planes: list):
        chunks = []
        for component, plane in zip(image.components, planes):
            size = _word_size(component.precision)
            dtype = {1: "<u1", 2: "<u2", 4: "<u4"}[size]
            chunks.append((plane & ((1 << (8 * size)) - 1)).astype(dtype).tobytes())
        self.buffer = np.frombuffer(b"".join(chunks) + b"\x00" * 8, dtype=np.uint8)

    def words(self, start: int, size: int, index: np.ndarray) -> np.ndarray:
        position = start + size * index
        position = np.clip(position, 0, len(self.buffer) - size)
        word = np.zeros(position.shape, dtype=np.uint64)
        for k in range(size):
            word |= self.buffer[position + k].astype(np.uint64) << np.uint64(8 * k)
        return word


def _shifted(word: np.ndarray, component: _Component, bits: int) -> np.ndarray:
    """``j2ku_shift(offset + word, shift)`` toward ``bits``-bit samples, as
    PIL's unpackers compute it in unsigned ints."""
    shift = bits - component.precision
    offset = (1 << (component.precision - 1)) if component.signed else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    value = (word + np.uint64(offset)) & np.uint64(0xFFFFFFFF)
    value = value >> np.uint64(-shift) if shift < 0 else (value << np.uint64(shift)) \
        & np.uint64(0xFFFFFFFF)
    return value


def _unpack(kind: str, image: _Image, bounds, planes: list, canvas: np.ndarray):
    """One tile into PIL's image ``canvas`` (H, W, bands), as the
    ``j2ku_*`` unpacker ``kind`` does."""
    tx0, ty0, tx1, ty1 = bounds
    x0, y0 = tx0 - image.x0, ty0 - image.y0
    w, h = tx1 - tx0, ty1 - ty0
    data = _TileData(image, planes)
    comps = image.components
    sizes = [_word_size(c.precision) for c in comps]
    ys, xs = np.mgrid[0:h, 0:w]
    plain = ys * w + xs
    region = canvas[y0:y0 + h, x0:x0 + w]
    if kind in ("gray_l", "gray_i", "gray_rgb"):
        bits, mask = (16, 0xFFFF) if kind == "gray_i" else (8, 0xFF)
        value = _shifted(data.words(0, sizes[0], plain), comps[0], bits) & np.uint64(mask)
        if kind == "gray_rgb":
            region[..., :3] = value[..., None]
            region[..., 3] = 0xFF
        else:
            region[..., 0] = value
        return
    if kind == "graya_la":
        value = _shifted(data.words(0, sizes[0], plain), comps[0], 8) & np.uint64(0xFF)
        alpha = _shifted(data.words(sizes[0] * w * h, sizes[1], plain), comps[1], 8) \
            & np.uint64(0xFF)
        region[..., 0] = region[..., 1] = region[..., 2] = value
        region[..., 3] = alpha
        return
    count = 3 if kind in ("srgb_rgb", "sycc_rgb") else 4
    start = 0
    for n in range(count):
        dx, dy = comps[n].dx, comps[n].dy
        index = (ys // dy) * (w // dx) + xs // dx
        value = _shifted(data.words(start, sizes[n], index), comps[n], 8) & np.uint64(0xFF)
        region[..., n] = value
        start += sizes[n] * (w // dx) * (h // dy)
    if count == 3:
        region[..., 3] = 0xFF
    if kind in ("sycc_rgb", "sycca_rgba"):
        region[..., :3] = ycbcr_to_rgb(region[..., :3])


def _to_rgb(canvas: np.ndarray, mode: str, palette) -> np.ndarray:
    """PIL's ``convert("RGB")`` of the decoded image."""
    if mode in ("L", "I;16", "LA"):
        grey = np.minimum(canvas[..., 0], 255).astype(np.uint8)  # I;16 clips at 255
        return np.repeat(grey[..., None], 3, axis=-1)
    if mode in ("P", "PA"):
        table = np.zeros((256, 3), dtype=np.uint8)  # entries past PIL's palette are black
        if palette is not None:
            entries, columns = palette
            entries = np.frombuffer(entries, dtype=np.uint8)
            count = min(len(entries) // columns, 256)
            table[:count] = entries[:count * columns].reshape(count, columns)[:, :3]
        return table[canvas[..., 0]]
    if mode == "CMYK":
        return cmyk_to_rgb(canvas.astype(np.uint8))
    return np.ascontiguousarray(canvas[..., :3].astype(np.uint8))


def decode_jpeg2000(blob: bytes, name: str = "image") -> np.ndarray:
    """A JP2 / JPX file or a raw JPEG 2000 codestream as (H, W, 3) uint8,
    ``PIL.Image.open(f).convert("RGB")`` pixel for pixel."""
    blob = bytes(blob)
    if blob[:4] == J2K_SIGNATURE:
        (width, height), mode = _pil_codestream_header(blob, name)
        palette = jp2_size = None
        offset, colour = 0, UNSPECIFIED
    elif blob[:12] == JP2_SIGNATURE:
        (width, height), mode, palette = _pil_jp2_header(blob, name)
        offset, colour, info = _jp2_codestream(blob, name)
        jp2_size = info["ihdr"][:2]
    else:
        raise ValueError(f"{name} is not a JPEG 2000 file")
    if width <= 0 or height <= 0:
        raise ValueError(f"{name}: JPEG 2000 image of size {width} x {height}")
    if width * height > 2 * MAX_IMAGE_PIXELS:
        raise ValueError(f"{name}: {width} x {height} pixels is more than PIL opens (its "
                         f"decompression bomb check)")
    stream = _Codestream(blob[offset:], name, jp2_size)
    image = stream.image
    ncomp = len(image.components)
    if not 1 <= ncomp <= 4:
        raise ValueError(f"{name}: PIL cannot decode {ncomp} components")
    if colour in (UNSPECIFIED, UNKNOWN):
        # PIL takes 3 or 4 components as sRGB, or as sYCC when a component
        # after the first is subsampled.
        chroma = any(c.dx != 1 or c.dy != 1 for c in image.components[1:])
        colour = GRAY if ncomp <= 2 else SYCC if chroma else SRGB
    subsampled = any(c.dx != 1 or c.dy != 1 for c in image.components)
    unpacker = UNPACKERS.get((colour, ncomp, mode))
    if unpacker is None or (subsampled and not unpacker[1]):
        raise ValueError(f"{name}: PIL has no unpacker for {ncomp} components in colour "
                         f"space {colour} as mode {mode}")
    bands = 1 if mode in ("L", "P", "I;16") else 4
    dtype = np.uint16 if mode == "I;16" else np.uint8
    canvas = np.zeros((height, width, bands), dtype=dtype)
    ppm = [stream.packed_headers(), 0] if stream.ppm else None
    for index in stream.order:
        bounds, planes = _decode_tile(stream, index, ppm)
        tx0, ty0, tx1, ty1 = bounds
        if (tx0 >= tx1 or ty0 >= ty1 or tx1 - image.x0 > width or ty1 - image.y0 > height):
            raise ValueError(f"{name}: a tile lies outside PIL's image")
        _unpack(unpacker[0], image, bounds, planes, canvas)
    return _to_rgb(canvas, mode, palette)
