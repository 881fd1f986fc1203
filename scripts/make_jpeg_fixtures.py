"""Write the JPEG fixtures of the kinds PIL cannot write (arithmetic-coded
sequential and progressive frames, lossless frames, sampling factors up to
4) that ``tests/test_torch_jpeg_modes.py`` and ``chip_smoke.py`` read, with
the sha256 of PIL's decode of each.

    python scripts/make_jpeg_fixtures.py [--out tests/fixtures/jpeg]

The encoders here are written from ITU-T T.81 and libjpeg's encoder
(``jcarith.c``, ``jclhuff.c``), not from the port's decoder:

* :class:`QMEncoder`, the arithmetic coder of T.81 Annex D (the ``Qe``
  table with its ``Switch_MPS``, carry propagation, byte stuffing and the
  final flush), under :func:`arith_jpeg`: sequential (SOF9) and
  progressive (SOF10) scans with the statistical models of Annex F.1.4.4
  and G.1.3, ``DAC`` conditioning and restart intervals;
* :func:`lossless_jpeg`: SOF3 with predictors 1-7, the point transform
  and restart intervals of whole MCU rows (Annex H);
* :func:`huffman_jpeg`: baseline Huffman coding of the same coefficients
  at any sampling factors (the port's ``tools._entropy_code``).

Each file is checked against an oracle that does not depend on the port
before ``hashes.json`` is written: PIL's decode of a lossless file equals
its source samples, and PIL's decode of an arithmetic-coded file equals
PIL's decode of its Huffman twin (the same quantised coefficients in the
same frame layout). The 12 golden scenes are arithmetic-coded from the
coefficients of PIL's own baseline JPEG of each, so that PIL's decode of
that file defines their pixels. ``hashes.json`` holds, for each file, the
shape and the sha256 of ``np.array(PIL.Image.open(f).convert("RGB"))``.
The script needs PIL; the files it writes, and its encoders, do not.
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

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from keras_ocr_tpu_torch import tools  # noqa: E402
from make_image_fixtures import scene  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "..", "tests", "fixtures", "golden_offline")

# ---------------------------------------------------------------------------
# The QM coder (T.81 Annex D)
# ---------------------------------------------------------------------------

# Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS) by index;
# entry 113 is libjpeg's fixed estimate of one half, which never adapts.
QE_TABLE = (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
)
FIXED = 113


class QMEncoder:
    """The QM coder as ``jcarith.c`` runs it (T.81 D.1): a statistics bin
    is an int, its state index in the low 7 bits and the MPS in bit 7;
    the interval's MPS part lies below its LPS part. Output bytes are
    held back while a carry may still reach them; an 0xFF byte is
    followed by a stuffed zero."""

    def __init__(self):
        self.c, self.a, self.ct = 0, 0x10000, 11
        self.sc = self.zc = 0
        self.buffer = -1
        self.out = bytearray()

    def _emit_pending(self, byte):
        self.out += b"\x00" * self.zc
        self.zc = 0
        self.out.append(byte)
        if byte == 0xFF:
            self.out.append(0)

    def _settle(self, temp):
        """A finished byte ``temp`` of C (D.1.6's Byte_out)."""
        if temp > 0xFF:
            if self.buffer >= 0:
                self._emit_pending(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._emit_pending(self.buffer)
            if self.sc:
                self.out += b"\x00" * self.zc
                self.zc = 0
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
            self.buffer = temp & 0xFF

    def encode(self, stats, index, bit):
        sv = stats[index]
        qe, lps, mps, switch = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if bit != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[index] = (sv & 0x80) ^ (lps | switch << 7)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[index] = (sv & 0x80) ^ mps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._settle(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def flush(self) -> bytes:
        """T.81 D.1.8: C set to the value of the interval with the most
        trailing zeros, its bytes written, trailing zero bytes dropped."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._emit_pending(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._emit_pending(self.buffer)
            if self.sc:
                self.out += b"\x00" * self.zc
                self.zc = 0
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._emit_pending((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit_pending((self.c >> 11) & 0xFF)
        return bytes(self.out)


# ---------------------------------------------------------------------------
# Frames: components, sampling factors and quantised coefficients
# ---------------------------------------------------------------------------


def _ceil_div(a, b):
    return -(-a // b)


def segment(marker, body) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + bytes(body)


JFIF = segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe(transform) -> bytes:
    return segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform]))


def ycc(rgb) -> list:
    """``jccolor.c``'s RGB -> YCbCr (SCALEBITS 16) as three planes."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    half, offset = 1 << 15, 128 << 16
    return [(19595 * r + 38470 * g + 7471 * b + half) >> 16,
            (-11059 * r - 21709 * g + 32768 * b + offset + half - 1) >> 16,
            (32768 * r - 27439 * g - 5329 * b + offset + half - 1) >> 16]


def make_frame(planes, sampling, quality=75, ids=None, markers=JFIF) -> dict:
    """A frame of full-size uint8 ``planes`` at ``sampling`` [(h, v), ...]:
    each plane point-sampled to its component's size, extended by its
    edges to whole MCUs and quantised with the standard tables scaled to
    ``quality`` (table 0 for the first component, 1 for the rest). Any
    factors are accepted, fractional ratios too."""
    height, width = planes[0].shape
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcus_y, mcus_x = _ceil_div(height, 8 * vmax), _ceil_div(width, 8 * hmax)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    quant = [np.clip((np.array(basic, np.int64) * scale + 50) // 100, 1, 255)
             for basic in (tools._STD_LUMINANCE_QUANT, tools._STD_CHROMINANCE_QUANT)]
    components = []
    for index, (plane, (h, v)) in enumerate(zip(planes, sampling)):
        comp_h, comp_w = _ceil_div(height * v, vmax), _ceil_div(width * h, hmax)
        rows = np.minimum(np.arange(comp_h) * vmax // v, height - 1)
        cols = np.minimum(np.arange(comp_w) * hmax // h, width - 1)
        small = np.asarray(plane, np.int64)[rows][:, cols]
        full = np.pad(small, ((0, mcus_y * v * 8 - comp_h), (0, mcus_x * h * 8 - comp_w)),
                      "edge")
        table = min(index, 1)
        components.append({"id": (ids or range(1, len(planes) + 1))[index], "h": h, "v": v,
                           "tq": table, "coefs": tools._quantised_blocks(full, quant[table])})
    return {"width": width, "height": height, "components": components, "quant": quant,
            "markers": markers}


def frame_of_jpeg(blob) -> dict:
    """The frame of a sequential JPEG (SOF0, or SOF9 for its Huffman twin),
    its coefficients decoded by the port's decoder: a file coded from it
    is checked against this one by PIL's decodes, so a fault there shows
    as a mismatch."""
    decoded, _, _ = tools._jpeg_frame(blob, "jpeg")
    quant, pos = {}, 2
    markers = b""
    while blob[pos + 1] not in (0xC0, 0xC9):
        (length,) = struct.unpack(">H", blob[pos + 2 : pos + 4])
        if blob[pos + 1] == 0xDB:
            body = blob[pos + 4 : pos + 2 + length]
            natural = np.zeros(64, np.int64)
            natural[tools._NATURAL[:64]] = np.frombuffer(body[1:65], np.uint8)
            quant[body[0] & 15] = natural
        elif 0xE0 <= blob[pos + 1] <= 0xEF:
            markers += blob[pos : pos + 2 + length]
        pos += 2 + length
    components = []
    for index, c in enumerate(decoded["components"]):
        rows, cols = c["blocks"]
        natural = np.array(c["coefs"], np.int64).reshape(rows, cols, 64)
        components.append({"id": c["id"], "h": c["h"], "v": c["v"], "tq": c["quant"],
                           "coefs": natural[..., tools._NATURAL[:64]]})
    return {"width": decoded["width"], "height": decoded["height"], "components": components,
            "quant": [quant[k] for k in sorted(quant)], "markers": markers}


def scan_mcus(frame, members) -> list:
    """The MCUs of a scan of the components ``members`` in stream order,
    each a list of (component index, row, col) of its blocks:
    MCU-interleaved for several components, the component's own grid of
    real blocks for one."""
    hmax, vmax = (max(c[k] for c in frame["components"]) for k in ("h", "v"))
    if len(members) == 1:
        c = frame["components"][members[0]]
        rows = _ceil_div(_ceil_div(frame["height"] * c["v"], vmax), 8)
        cols = _ceil_div(_ceil_div(frame["width"] * c["h"], hmax), 8)
        return [[(members[0], y, x)] for y in range(rows) for x in range(cols)]
    mcus_y, mcus_x = _ceil_div(frame["height"], 8 * vmax), _ceil_div(frame["width"], 8 * hmax)
    out = []
    for my in range(mcus_y):
        for mx in range(mcus_x):
            out.append([(ci, my * frame["components"][ci]["v"] + v,
                         mx * frame["components"][ci]["h"] + h)
                        for ci in members for v in range(frame["components"][ci]["v"])
                        for h in range(frame["components"][ci]["h"])])
    return out


def _header(frame, sof, tables=b"") -> list:
    out = [b"\xff\xd8", frame["markers"]]
    for table_id, table in enumerate(frame["quant"]):
        zigzag = np.asarray(table, np.int64).reshape(64)[tools._NATURAL[:64]]
        out.append(segment(0xDB, bytes([table_id]) + bytes(zigzag.tolist())))
    body = struct.pack(">BHHB", 8, frame["height"], frame["width"], len(frame["components"]))
    for c in frame["components"]:
        body += bytes([c["id"], c["h"] << 4 | c["v"], c["tq"]])
    out += [segment(sof, body), tables]
    return out


def _sos(frame, members, ss=0, se=63, ah=0, al=0) -> bytes:
    body = bytes([len(members)])
    for ci in members:
        table = min(ci, 1)
        body += bytes([frame["components"][ci]["id"], table << 4 | table])
    return segment(0xDA, body + bytes([ss, se, ah << 4 | al]))


# ---------------------------------------------------------------------------
# Huffman twins
# ---------------------------------------------------------------------------


def huffman_jpeg(frame, restart=0) -> bytes:
    """The frame as one sequential Huffman scan (interleaved, or the
    component's own grid for one component) with the standard tables and
    an optional restart interval of ``restart`` MCUs."""
    names = ("dc_luminance", "ac_luminance", "dc_chrominance", "ac_chrominance")
    codes = [tools._huffman_codes(*tools._STD_HUFFMAN[n]) for n in names]
    tables = b""
    for table_class, table_id, name in ((0, 0, names[0]), (1, 0, names[1]), (0, 1, names[2]),
                                        (1, 1, names[3])):
        counts, symbols = tools._STD_HUFFMAN[name]
        tables += segment(0xC4, bytes([table_class << 4 | table_id, *counts, *symbols]))
    out = _header(frame, 0xC0, tables)
    if restart:
        out.append(segment(0xDD, struct.pack(">H", restart)))
    members = list(range(len(frame["components"])))
    out.append(_sos(frame, members))
    mcus = scan_mcus(frame, members)
    per = restart or len(mcus)
    for i in range(0, len(mcus), per):
        if i:
            out.append(bytes([0xFF, 0xD0 + (i // per - 1) % 8]))
        blocks = [b for mcu in mcus[i : i + per] for b in mcu]
        stream = np.array([frame["components"][ci]["coefs"][y, x] for ci, y, x in blocks])
        for ci in members:
            mine = np.array([b[0] == ci for b in blocks])
            stream[mine, 0] = np.diff(stream[mine, 0], prepend=0)
        chroma = np.array([ci > 0 for ci, _, _ in blocks])
        out.append(tools._entropy_code(stream, chroma, codes))
    out.append(b"\xff\xd9")
    return b"".join(out)


# ---------------------------------------------------------------------------
# Arithmetic coding (T.81 F.1.4.4, G.1.3; jcarith.c)
# ---------------------------------------------------------------------------


def _magnitude(enc, stats, st, v, x1):
    """Figures F.8 and F.9: the magnitude category of ``v`` (already less
    one) from bin ``st`` on, its later decisions from X1 on (DC: bin 20;
    AC: ``x1``, after a second decision at ``st``), then its bits below
    the top one from X1 + 14 on. Returns the category's top bit."""
    m = 0
    if v:
        enc.encode(stats, st, 1)
        m = 1
        v2 = v
        more = True
        if x1 is None:
            st = 20
        else:
            v2 >>= 1
            more = v2 > 0
            if more:
                enc.encode(stats, st, 1)
                m <<= 1
                st = x1
        while more and (v2 := v2 >> 1):
            enc.encode(stats, st, 1)
            m <<= 1
            st += 1
    enc.encode(stats, st, 0)
    st += 14
    bit = m
    while bit := bit >> 1:
        enc.encode(stats, st, 1 if bit & v else 0)
    return m


def _encode_dc(enc, stats, context, ci, diff, lower, upper):
    """Figure F.4 with F.1.4.4.1's conditioning on the previous difference."""
    st = context[ci]
    if diff == 0:
        enc.encode(stats, st, 0)
        context[ci] = 0
        return
    enc.encode(stats, st, 1)
    if diff > 0:
        enc.encode(stats, st + 1, 0)
        st += 2
        category = 4
    else:
        diff = -diff
        enc.encode(stats, st + 1, 1)
        st += 3
        category = 8
    m = _magnitude(enc, stats, st, diff - 1, None)
    if m < (1 << lower) >> 1:
        category = 0
    elif m > (1 << upper) >> 1:
        category += 8
    context[ci] = category


def _point(value, al):
    """A coefficient's point transform: a division by 2**al toward zero."""
    return value >> al if value >= 0 else -((-value) >> al)


def _encode_ac(enc, stats, fixed, block, ss, se, al, kx):
    """Figure F.5 over the band ``ss``-``se`` (G.1.3.2 for a first
    progressive scan: values shifted by ``al`` toward zero)."""
    values = [_point(int(v), al) for v in block]
    end = se
    while end >= ss and values[end] == 0:
        end -= 1
    k = ss
    while k <= end:
        st = 3 * (k - 1)
        enc.encode(stats, st, 0)
        while values[k] == 0:
            enc.encode(stats, st + 1, 0)
            st += 3
            k += 1
        enc.encode(stats, st + 1, 1)
        v = values[k]
        enc.encode(fixed, 0, 1 if v < 0 else 0)
        _magnitude(enc, stats, st + 2, abs(v) - 1, 189 if k <= kx else 217)
        k += 1
    if k <= se:
        enc.encode(stats, 3 * (k - 1), 1)


def _encode_ac_refine(enc, stats, fixed, block, ss, se, ah, al):
    """Figure G.10: correction bits of coefficients already nonzero at
    ``ah``, and the newly nonzero ones at ``al``."""
    now = [abs(_point(int(v), al)) for v in block]
    before = [abs(_point(int(v), ah)) for v in block]
    end = se
    while end > 0 and now[end] == 0:
        end -= 1
    end_before = end
    while end_before > 0 and before[end_before] == 0:
        end_before -= 1
    k = ss
    while k <= end:
        st = 3 * (k - 1)
        if k > end_before:
            enc.encode(stats, st, 0)
        while True:
            if now[k]:
                if now[k] >> 1:
                    enc.encode(stats, st + 2, now[k] & 1)
                else:
                    enc.encode(stats, st + 1, 1)
                    enc.encode(fixed, 0, 1 if block[k] < 0 else 0)
                break
            enc.encode(stats, st + 1, 0)
            st += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(stats, 3 * (k - 1), 1)


DEFAULT_PROGRESSION = ((0, 0, 0, 1), (1, 5, 0, 2), (6, 63, 0, 2), (1, 63, 2, 1),
                       (0, 0, 1, 0), (1, 63, 1, 0))


def arith_jpeg(frame, restart=0, dac=None, progressive=False, scans=None) -> bytes:
    """The frame arithmetic-coded: one sequential scan (SOF9), or the
    progression ``scans`` of (Ss, Se, Ah, Al) (SOF10; AC bands per
    component). ``dac`` maps (class, table) to a ``DAC`` value: (L, U)
    for class 0 (DC), Kx for class 1 (AC); the defaults are (0, 1) and 5.
    ``restart`` is the restart interval in MCUs."""
    dac = dac or {}
    body = b""
    for (cls, table), value in sorted(dac.items()):
        body += bytes([cls << 4 | table, value[1] << 4 | value[0] if cls == 0 else value])
    out = _header(frame, 0xCA if progressive else 0xC9,
                  segment(0xCC, body) if body else b"")
    if restart:
        out.append(segment(0xDD, struct.pack(">H", restart)))
    count = len(frame["components"])
    if progressive:
        plan = []
        for ss, se, ah, al in scans or DEFAULT_PROGRESSION:
            if ss == 0:
                plan.append((list(range(count)), ss, se, ah, al))
            else:
                plan += [([ci], ss, se, ah, al) for ci in range(count)]
    else:
        plan = [(list(range(count)), 0, 63, 0, 0)]
    for members, ss, se, ah, al in plan:
        out.append(_sos(frame, members, ss, se, ah, al))
        out.append(_arith_scan(frame, members, ss, se, ah, al, restart, dac, progressive))
    out.append(b"\xff\xd9")
    return b"".join(out)


def _arith_scan(frame, members, ss, se, ah, al, restart, dac, progressive) -> bytes:
    mcus = scan_mcus(frame, members)
    per = restart or len(mcus)
    pieces = []
    for start in range(0, len(mcus), per):
        if start:
            pieces.append(bytes([0xFF, 0xD0 + (start // per - 1) % 8]))
        enc = QMEncoder()
        dc_stats = {min(ci, 1): [0] * 64 for ci in members}
        ac_stats = {min(ci, 1): [0] * 256 for ci in members}
        fixed = [FIXED]
        last, context = {}, {}
        for mcu in mcus[start : start + per]:
            for ci, y, x in mcu:
                table = min(ci, 1)
                block = frame["components"][ci]["coefs"][y, x]
                if ss == 0 and ah == 0:
                    value = int(block[0]) >> al
                    lower, upper = dac.get((0, table), (0, 1))
                    _encode_dc(enc, dc_stats[table], context.setdefault(ci, [0]), 0,
                               value - last.get(ci, 0), lower, upper)
                    last[ci] = value
                elif ss == 0:
                    enc.encode(fixed, 0, (int(block[0]) >> al) & 1)
                if not progressive or ss > 0:
                    kx = dac.get((1, table), 5)
                    if ah == 0:
                        _encode_ac(enc, ac_stats[table], fixed, block, max(ss, 1), se, al, kx)
                    else:
                        _encode_ac_refine(enc, ac_stats[table], fixed, block, ss, se, ah, al)
        pieces.append(enc.flush())
    return b"".join(pieces)


# ---------------------------------------------------------------------------
# Lossless (T.81 Annex H; jclossls.c, jclhuff.c)
# ---------------------------------------------------------------------------


def predictions(x, predictor, first_rows, initial):
    """Annex H's predictions of an int64 sample array: ``initial`` at the
    start of each row listed in ``first_rows`` (the scan's first and each
    restart interval's), Ra along those rows, Rb down the first column,
    the selected predictor elsewhere."""
    ra = np.zeros_like(x)
    rb = np.zeros_like(x)
    rc = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb[1:] = x[:-1]
    rc[1:, 1:] = x[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor].copy()
    pred[:, 0] = rb[:, 0]
    for row in first_rows:
        pred[row, 1:] = ra[row, 1:]
        pred[row, 0] = initial
    return pred


LOSSLESS_TABLE = ((0, 0, 0, 0, 17) + (0,) * 11, tuple(range(17)))


def lossless_jpeg(planes, sampling=None, predictor=1, pt=0, restart_rows=0, markers=b"",
                  ids=None, precision=8) -> bytes:
    """Uint8 full-size ``planes`` as a lossless Huffman JPEG: each plane
    point-sampled to its component's size, shifted right by ``pt``, the
    prediction differences of every sample of the scan's MCUs (a
    component's samples past its size repeat its edge) Huffman-coded with
    one table of 5-bit codes; one interleaved scan (the component's own
    grid for one), restart intervals of ``restart_rows`` MCU rows."""
    sampling = sampling or [(1, 1)] * len(planes)
    height, width = planes[0].shape
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    interleaved = len(planes) > 1
    mcus_y, mcus_x = _ceil_div(height, vmax), _ceil_div(width, hmax)
    units = []
    for plane, (h, v) in zip(planes, sampling):
        comp_h, comp_w = _ceil_div(height * v, vmax), _ceil_div(width * h, hmax)
        rows = np.minimum(np.arange(comp_h) * vmax // v, height - 1)
        cols = np.minimum(np.arange(comp_w) * hmax // h, width - 1)
        small = np.asarray(plane, np.int64)[rows][:, cols] >> pt
        grid_h, grid_w = (mcus_y * v, mcus_x * h) if interleaved else (comp_h, comp_w)
        x = np.pad(small, ((0, grid_h - comp_h), (0, grid_w - comp_w)), "edge")
        step = restart_rows * (v if interleaved else 1)
        first = range(0, grid_h, step) if restart_rows else [0]
        diff = x - predictions(x, predictor, first, 1 << (precision - pt - 1))
        if interleaved:  # (MCU row, MCU, the component's v x h samples)
            diff = diff.reshape(mcus_y, v, mcus_x, h).transpose(0, 2, 1, 3)
            diff = diff.reshape(mcus_y, mcus_x, v * h)
        units.append(diff)
    if interleaved:
        values = np.concatenate(units, axis=-1)
        row_units = mcus_x * values.shape[-1]
    else:
        values = units[0]
        row_units = values.shape[1]
    values = ((values.reshape(-1) + 32767) & 0xFFFF) - 32767  # modulo 2**16
    code, length = tools._huffman_codes(*LOSSLESS_TABLE)
    size = np.zeros(len(values), np.int64)
    magnitude = np.abs(values)
    while np.any(magnitude >> size):
        size += (magnitude >> size) > 0
    extra = np.where(values < 0, values + (1 << size) - 1, values) & ((1 << size) - 1)
    nextra = np.where(size == 16, 0, size)
    words = (code[size] << nextra) | np.where(size == 16, 0, extra)
    lengths = length[size] + nextra
    table = segment(0xC4, bytes([0x00, *LOSSLESS_TABLE[0], *LOSSLESS_TABLE[1]]))
    ids = ids or range(1, len(planes) + 1)
    body = struct.pack(">BHHB", precision, height, width, len(planes))
    for index, (h, v) in enumerate(sampling):
        body += bytes([ids[index], h << 4 | v, 0])
    out = [b"\xff\xd8", markers, segment(0xC3, body), table]
    if restart_rows:
        restart = restart_rows * (mcus_x if interleaved else row_units)
        out.append(segment(0xDD, struct.pack(">H", restart)))
    sos = bytes([len(planes)]) + b"".join(bytes([ids[i], 0x00]) for i in range(len(planes)))
    out.append(segment(0xDA, sos + bytes([predictor, 0, pt])))
    per = restart_rows * row_units if restart_rows else len(values)
    for i, at in enumerate(range(0, len(values), per)):
        if i:
            out.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
        out.append(pack_bits(words[at : at + per], lengths[at : at + per]))
    out.append(b"\xff\xd9")
    return b"".join(out)


def pack_bits(words, lengths) -> bytes:
    """Codes of ``lengths`` bits, MSB first, the last byte filled with ones,
    0xFF bytes stuffed."""
    total = int(lengths.sum())
    event = np.repeat(np.arange(len(words)), lengths)
    offset = np.arange(total) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    stream = ((words[event] >> (lengths[event] - 1 - offset)) & 1).astype(np.uint8)
    stream = np.concatenate([stream, np.ones(-total % 8, np.uint8)])
    return np.packbits(stream).tobytes().replace(b"\xff", b"\xff\x00")


# ---------------------------------------------------------------------------
# The fixtures and their oracles
# ---------------------------------------------------------------------------


def box_replicated(planes, sampling) -> np.ndarray:
    """What a lossless frame of ``planes`` at ``sampling`` holds once each
    component is replicated back to full size: (H, W, components)."""
    height, width = planes[0].shape
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    out = []
    for plane, (h, v) in zip(planes, sampling):
        rows = np.minimum(np.arange(_ceil_div(height * v, vmax)) * vmax // v, height - 1)
        cols = np.minimum(np.arange(_ceil_div(width * h, hmax)) * hmax // h, width - 1)
        small = np.asarray(plane)[rows][:, cols]
        out.append(np.repeat(np.repeat(small, vmax // v, 0), hmax // h, 1)[:height, :width])
    return np.stack(out, -1).astype(np.uint8)


def golden_baseline(index) -> bytes:
    """PIL's baseline JPEG (quality 75, 4:2:0) of golden scene ``index``."""
    from PIL import Image

    out = io.BytesIO()
    Image.open(os.path.join(GOLDEN, f"scene_{index:02d}.png")).convert("RGB").save(out, "JPEG")
    return out.getvalue()


def fixtures() -> dict:
    """name -> (file bytes, oracle): ("twin", Huffman bytes) for an
    arithmetic-coded or newly sampled file, ("samples", (H, W, C) array of
    what PIL's ``Image.open`` must hold) for a lossless one."""
    from PIL import Image

    rgb = scene(48, 64)
    planes = [rgb[..., k] for k in range(3)]
    grey = planes[1]
    cmyk = np.asarray(Image.fromarray(rgb).convert("CMYK"))
    cmyk_planes = [cmyk[..., k] for k in range(4)]
    dac = {(0, 0): (2, 4), (1, 0): 12, (0, 1): (0, 3), (1, 1): 1}
    out = {}
    for index in range(12):
        baseline = golden_baseline(index)
        frame = frame_of_jpeg(baseline)
        # The Huffman twin is rebuilt from these coefficients byte for byte
        # (chip_smoke.py times it beside the arithmetic-coded file).
        assert huffman_jpeg(frame) == baseline, index
        out[f"scene_{index:02d}_arith.jpg"] = (arith_jpeg(frame), ("twin", baseline))
        if index == 3:
            out["scene_03_arith_progressive.jpg"] = (
                arith_jpeg(frame, progressive=True, restart=40), ("twin", baseline))
    for name, frame, kwargs in (
            ("grey_arith_dac_restart.jpg", make_frame([grey], [(1, 1)]),
             {"dac": dac, "restart": 7}),
            ("ycc411_arith_dac.jpg", make_frame(ycc(rgb), [(4, 1), (1, 1), (1, 1)]),
             {"dac": dac}),
            ("ycc420_arith_progressive_restart.jpg",
             make_frame(ycc(rgb), [(2, 2), (1, 1), (1, 1)]), {"progressive": True,
                                                              "restart": 3}),
            ("ycc444_arith_progressive_dac.jpg", make_frame(ycc(rgb), [(1, 1)] * 3),
             {"progressive": True, "dac": dac}),
            ("cmyk_arith.jpg", make_frame(cmyk_planes, [(1, 1)] * 4, markers=adobe(0)), {}),
            ("ycck_arith_progressive.jpg",
             make_frame(ycc(rgb) + [grey], [(2, 2), (1, 1), (1, 1), (2, 2)],
                        markers=adobe(2)), {"progressive": True})):
        out[name] = (arith_jpeg(frame, **kwargs), ("twin", huffman_jpeg(frame)))
    for name, sampling in (("ycc411.jpg", [(4, 1), (1, 1), (1, 1)]),
                           ("ycc42.jpg", [(4, 2), (1, 1), (1, 1)]),
                           ("ycc41_21.jpg", [(4, 1), (2, 1), (2, 1)]),
                           ("ycc14_12.jpg", [(1, 4), (1, 2), (1, 2)]),
                           ("ycc31.jpg", [(3, 1), (1, 1), (1, 1)]),
                           ("ycc14.jpg", [(1, 4), (1, 1), (1, 1)])):
        frame = make_frame(ycc(rgb), sampling)
        out[name] = (huffman_jpeg(frame, restart=5), ("twin", arith_jpeg(frame)))
    for predictor in range(1, 8):
        pt = 2 if predictor in (3, 6) else 0
        source = (grey >> pt) << pt
        out[f"lossless_grey_p{predictor}.jpg"] = (
            lossless_jpeg([source], predictor=predictor, pt=pt,
                          restart_rows=5 if predictor % 2 else 0, markers=JFIF),
            ("samples", source[..., None]))
    out["lossless_rgb_p4_restart.jpg"] = (
        lossless_jpeg(planes, predictor=4, restart_rows=4), ("samples", rgb))
    out["lossless_rgb_p7_adobe0.jpg"] = (
        lossless_jpeg(planes, predictor=7, markers=adobe(0)), ("samples", rgb))
    out["lossless_cmyk_p5.jpg"] = (lossless_jpeg(cmyk_planes, predictor=5),
                                   ("samples", 255 - cmyk))
    sampling = [(2, 2), (1, 1), (1, 1)]
    out["lossless_420_p6.jpg"] = (
        lossless_jpeg(planes, sampling=sampling, predictor=6, restart_rows=3),
        ("samples", box_replicated(planes, sampling)))
    return out


def fixture_files() -> dict:
    """The fixtures: name -> file bytes."""
    return {name: blob for name, (blob, _) in fixtures().items()}


def check_oracle(name, blob, oracle) -> None:
    """Assert a fixture's oracle with PIL: its decode equals its Huffman
    twin's, or its samples are the source's."""
    from PIL import Image

    kind, reference = oracle
    image = Image.open(io.BytesIO(blob))
    if kind == "twin":
        twin = np.array(Image.open(io.BytesIO(reference)).convert("RGB"))
        assert np.array_equal(np.array(image.convert("RGB")), twin), name
    else:
        held = np.array(image)
        held = held.reshape(held.shape[:2] + (-1,))
        assert np.array_equal(held, reference), name


def pil_hash(blob: bytes) -> dict:
    from PIL import Image

    pixels = np.array(Image.open(io.BytesIO(blob)).convert("RGB"))
    return {"shape": list(pixels.shape),
            "decoded_sha256": hashlib.sha256(pixels.tobytes()).hexdigest()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(HERE, "..", "tests", "fixtures", "jpeg"))
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    made = fixtures()
    for name, (blob, oracle) in made.items():
        check_oracle(name, blob, oracle)
    hashes = {}
    for name, (blob, _) in made.items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(blob)
        hashes[name] = pil_hash(blob)
        print(name, len(blob), "bytes", hashes[name]["shape"], hashes[name]["decoded_sha256"])
    with open(os.path.join(args.out, "hashes.json"), "w") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
