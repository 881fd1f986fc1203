"""AVIF for ``tools.read``: the HEIF container, the AV1 item through
:mod:`.av1`, and libavif's YUV -> RGB, as PIL 12.1.0 decodes a file with
libavif 1.3.0, dav1d 1.5.1 and libyuv.

The container follows libavif's parse: ``ftyp`` (a brand of ``avif`` or
``avis``), ``meta`` (``hdlr`` ``pict``, ``pitm``, ``iloc`` versions 0-2
with construction methods 0 and 1 (``idat``), ``iinf`` / ``infe`` versions
2-3, ``iref``, ``iprp`` / ``ipco`` / ``ipma``), ``mdat``, and for an
``avis`` file the first sample of its colour track (``moov``). Of the item
properties, ``av1C``, ``colr`` (``nclx``; an ICC profile is kept aside as
PIL keeps it), ``pixi`` and ``auxC`` count; ``ispe``, ``irot``, ``imir``,
``clap`` and ``pasp`` change no pixel of PIL's decode (PIL turns ``irot``
and ``imir`` into an EXIF orientation and leaves the pixels as coded). An
alpha item is decoded only where the colour is premultiplied by it
(``prem``): libavif then divides it out with libyuv's ``ARGBUnattenuate``;
otherwise ``convert("RGB")`` drops it.

YUV -> RGB is libyuv's fixed point where libavif hands the conversion to
libyuv (8-bit, BT.601 / BT.709 / BT.2020 matrices, either range, 4:2:0 and
4:2:2 upsampled by libyuv's bilinear filter), and libavif's own float
conversion otherwise (4:0:0, the identity matrix).

What this cannot read raises ``NotImplementedError`` naming it: ``grid``
items, other matrices, and what :mod:`.av1` refuses (loop restoration,
quantiser matrices, delta q / lf among them). What libavif fails on raises
``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from . import av1

BRANDS = (b"avif", b"avis", b"mif1", b"msf1")
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")

# libyuv's YuvConstants: (UB, UG, VG, VR, YG, YB) of each matrix and range.
LIBYUV_CONSTANTS = {
    "I601": (128, 25, 52, 102, 18997, -1160),
    "JPEG": (113, 22, 46, 90, 16320, 32),
    "H709": (128, 14, 34, 115, 18997, -1160),
    "F709": (119, 12, 30, 101, 16320, 32),
    "2020": (128, 12, 42, 107, 19003, -1160),
    "V2020": (120, 11, 37, 94, 16320, 32),
}
# matrix_coefficients -> (limited range constants, full range constants)
LIBYUV_MATRICES = {1: ("H709", "F709"), 2: ("I601", "JPEG"), 5: ("I601", "JPEG"),
                   6: ("I601", "JPEG"), 9: ("2020", "V2020")}


def is_avif(blob: bytes) -> bool:
    """PIL's ``AvifImagePlugin._accept``."""
    return blob[4:8] == b"ftyp" and blob[8:12] in BRANDS


def _boxes(blob: bytes, start: int, end: int):
    """(type, body start, body end) of each box in blob[start:end]."""
    pos = start
    while pos < end:
        if end - pos < 8:
            raise ValueError("AVIF box header runs past its parent")
        size, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        header = 8
        if size == 1:
            if end - pos < 16:
                raise ValueError("AVIF box header runs past its parent")
            size = struct.unpack(">Q", blob[pos + 8:pos + 16])[0]
            header = 16
        elif size == 0:
            size = end - pos
        if kind == b"uuid":
            header += 16
        if size < header or pos + size > end:
            raise ValueError(f"AVIF box {kind!r} runs past its parent")
        yield kind, pos + header, pos + size
        pos += size


def _full(blob: bytes, start: int):
    """A FullBox's version, flags and body start."""
    if start + 4 > len(blob):
        raise ValueError("AVIF full box is cut short")
    return blob[start], int.from_bytes(blob[start + 1:start + 4], "big"), start + 4


class _Reader:
    def __init__(self, blob: bytes, pos: int, end: int):
        self.blob, self.pos, self.end = blob, pos, end

    def uint(self, size: int) -> int:
        if self.pos + size > self.end:
            raise ValueError("AVIF box body is cut short")
        value = int.from_bytes(self.blob[self.pos:self.pos + size], "big")
        self.pos += size
        return value

    def bytes(self, size: int) -> bytes:
        if self.pos + size > self.end:
            raise ValueError("AVIF box body is cut short")
        value = self.blob[self.pos:self.pos + size]
        self.pos += size
        return value


class _Meta:
    """The item-based part of the file."""

    def __init__(self, blob: bytes, start: int, end: int):
        version, _, body = _full(blob, start)
        if version:
            raise ValueError("AVIF meta box of an unknown version")
        self.blob = blob
        self.primary = None
        self.locations = {}
        self.types = {}
        self.refs = []
        self.properties = []
        self.associations = {}
        self.idat = b""
        handler = None
        for kind, s, e in _boxes(blob, body, end):
            if kind == b"hdlr":
                handler = blob[s + 8:s + 12]
            elif kind == b"pitm":
                version, _, p = _full(blob, s)
                self.primary = _Reader(blob, p, e).uint(2 if version == 0 else 4)
            elif kind == b"iloc":
                self._iloc(blob, s, e)
            elif kind == b"iinf":
                self._iinf(blob, s, e)
            elif kind == b"iref":
                self._iref(blob, s, e)
            elif kind == b"iprp":
                self._iprp(blob, s, e)
            elif kind == b"idat":
                self.idat = blob[s:e]
        if handler != b"pict":
            raise ValueError("AVIF meta box has no pict handler")
        if self.primary is None:
            raise ValueError("AVIF file has no primary item")

    def _iloc(self, blob, s, e) -> None:
        version, _, p = _full(blob, s)
        if version > 2:
            raise ValueError(f"AVIF iloc version {version}")
        r = _Reader(blob, p, e)
        sizes = r.uint(2)
        offset_size, length_size = sizes >> 12, (sizes >> 8) & 0xF
        base_size, index_size = (sizes >> 4) & 0xF, sizes & 0xF
        for size in (offset_size, length_size, base_size):
            if size not in (0, 4, 8):
                raise ValueError("AVIF iloc field size other than 0, 4 or 8")
        count = r.uint(2 if version < 2 else 4)
        for _ in range(count):
            item = r.uint(2 if version < 2 else 4)
            method = r.uint(2) & 0xF if version in (1, 2) else 0
            r.uint(2)  # data_reference_index
            base = r.uint(base_size)
            extents = []
            for _ in range(r.uint(2)):
                if version in (1, 2) and index_size:
                    r.uint(index_size)
                extents.append((base + r.uint(offset_size), r.uint(length_size)))
            if method not in (0, 1):
                raise NotImplementedError(f"AVIF iloc construction method {method}")
            self.locations[item] = (method, extents)

    def _iinf(self, blob, s, e) -> None:
        version, _, p = _full(blob, s)
        count_size = 2 if version == 0 else 4
        for kind, bs, be in _boxes(blob, p + count_size, e):
            if kind != b"infe":
                continue
            version, _, q = _full(blob, bs)
            if version < 2:
                continue
            r = _Reader(blob, q, be)
            item = r.uint(2 if version == 2 else 4)
            r.uint(2)  # item_protection_index
            self.types[item] = r.bytes(4)

    def _iref(self, blob, s, e) -> None:
        version, _, p = _full(blob, s)
        size = 2 if version == 0 else 4
        for kind, bs, be in _boxes(blob, p, e):
            r = _Reader(blob, bs, be)
            source = r.uint(size)
            for _ in range(r.uint(2)):
                self.refs.append((kind, source, r.uint(size)))

    def _iprp(self, blob, s, e) -> None:
        for kind, bs, be in _boxes(blob, s, e):
            if kind == b"ipco":
                self.properties = [(k, ps, pe) for k, ps, pe in _boxes(blob, bs, be)]
            elif kind == b"ipma":
                version, flags, p = _full(blob, bs)
                r = _Reader(blob, p, be)
                for _ in range(r.uint(4)):
                    item = r.uint(2 if version < 1 else 4)
                    indices = []
                    for _ in range(r.uint(1)):
                        value = r.uint(2 if flags & 1 else 1)
                        indices.append(value & (0x7FFF if flags & 1 else 0x7F))
                    self.associations[item] = indices

    def item_properties(self, item: int) -> dict:
        out = {}
        for index in self.associations.get(item, []):
            if index == 0:
                continue
            if index > len(self.properties):
                raise ValueError("AVIF ipma names a property that ipco does not hold")
            kind, s, e = self.properties[index - 1]
            if kind == b"colr" and self.blob[s:s + 4] == b"nclx":
                kind = b"nclx"  # beside an ICC profile's colr box
            out.setdefault(kind, (s, e))
        return out

    def item_data(self, blob: bytes, item: int) -> bytes:
        if item not in self.locations:
            raise ValueError(f"AVIF item {item} has no location")
        method, extents = self.locations[item]
        source = blob if method == 0 else self.idat
        parts = []
        for offset, length in extents:
            if length == 0:
                length = len(source) - offset
            if offset + length > len(source):
                raise ValueError("AVIF item data runs past the end of the file")
            parts.append(source[offset:offset + length])
        return b"".join(parts)


def _track(blob: bytes, start: int, end: int) -> dict:
    """A ``trak`` box's ID, handler, references (type -> IDs) and sample
    tables."""
    track = {"id": None, "handler": None, "refs": {}, "boxes": {}}

    def walk(a, b):
        for kind, s, e in _boxes(blob, a, b):
            if kind in (b"mdia", b"minf", b"stbl"):
                walk(s, e)
            elif kind == b"tkhd":
                version, _, p = _full(blob, s)
                track["id"] = _Reader(blob, p + (16 if version == 1 else 8), e).uint(4)
            elif kind == b"hdlr":
                track["handler"] = blob[s + 8:s + 12]
            elif kind == b"tref":
                for ref, rs, re_ in _boxes(blob, s, e):
                    track["refs"][ref] = [int.from_bytes(blob[k:k + 4], "big")
                                          for k in range(rs, re_ - 3, 4)]
            elif kind in (b"stsd", b"stco", b"co64", b"stsz"):
                track["boxes"][kind] = (s, e)

    walk(start, end)
    return track


def _first_sample(blob: bytes, track: dict):
    """The first sample of a track, with its av01 sample entry's boxes:
    (data, {box type: (start, end)})."""
    boxes = track["boxes"]
    if b"stsd" not in boxes or b"stsz" not in boxes:
        raise ValueError("AVIF track has no sample description or sizes")
    ss, se = boxes[b"stsd"]
    entry = None
    for kind, es, ee in _boxes(blob, ss + 8, se):
        if kind != b"av01":
            raise ValueError(f"AVIF track sample entry {kind!r} is not av01")
        entry = {}
        for k, bs, be in _boxes(blob, es + 78, ee):
            if k == b"colr" and blob[bs:bs + 4] == b"nclx":
                k = b"nclx"
            entry.setdefault(k, (bs, be))
        break
    if entry is None:
        raise ValueError("AVIF track has no sample entry")
    zs, ze = boxes[b"stsz"]
    r = _Reader(blob, zs + 4, ze)
    size = r.uint(4)
    if r.uint(4) < 1:
        raise ValueError("AVIF track has no samples")
    if size == 0:
        size = r.uint(4)
    kind = b"stco" if b"stco" in boxes else b"co64"
    if kind not in boxes:
        raise ValueError("AVIF track has no chunk offsets")
    cs, ce = boxes[kind]
    r = _Reader(blob, cs + 4, ce)
    if r.uint(4) < 1:
        raise ValueError("AVIF track has no chunks")
    offset = r.uint(4 if kind == b"stco" else 8)
    if offset + size > len(blob):
        raise ValueError("AVIF sample runs past the end of the file")
    return blob[offset:offset + size], entry


def _sequence(blob: bytes, start: int, end: int):
    """An ``avis`` file's first frame: the colour track's first sample, its
    sample entry's boxes, and the first sample of its alpha track where the
    colour is premultiplied by it."""
    tracks = [_track(blob, s, e) for kind, s, e in _boxes(blob, start, end) if kind == b"trak"]
    colour = next((t for t in tracks if t["handler"] == b"pict" and b"auxl" not in t["refs"]),
                  None)
    if colour is None:
        raise ValueError("AVIF sequence has no colour track")
    data, entry = _first_sample(blob, colour)
    alpha = None
    if b"prem" in colour["refs"]:
        for track in tracks:
            if colour["id"] in track["refs"].get(b"auxl", ()):
                alpha = _first_sample(blob, track)[0]
                break
    return data, entry, alpha


def _nclx(blob: bytes, props: dict):
    """(matrix_coefficients, full range) of the item's ``colr`` nclx box,
    or None where it has none."""
    span = props.get(b"nclx")
    if span is None:
        return None
    s, e = span
    if e - s < 11:
        raise ValueError("AVIF colr nclx box is cut short")
    _, _, matrix = struct.unpack(">HHH", blob[s + 4:s + 10])
    return matrix, blob[s + 10] >> 7


def _parse(blob: bytes):
    """The colour image's AV1 data and its properties."""
    boxes = list(_boxes(blob, 0, len(blob)))
    if not boxes or boxes[0][0] != b"ftyp":
        raise ValueError("AVIF file does not start with an ftyp box")
    _, s, e = boxes[0]
    brands = [blob[s:s + 4]] + [blob[i:i + 4] for i in range(s + 8, e - 3, 4)]
    if b"avif" not in brands and b"avis" not in brands:
        raise ValueError("AVIF ftyp box names neither avif nor avis")
    meta = next(((s, e) for k, s, e in boxes if k == b"meta"), None)
    moov = next(((s, e) for k, s, e in boxes if k == b"moov"), None)
    if moov is not None and (blob[s:s + 4] == b"avis" or meta is None):
        return _sequence(blob, *moov)
    if meta is None:
        raise ValueError("AVIF file has no meta box")
    meta = _Meta(blob, *meta)
    item = meta.primary
    kind = meta.types.get(item)
    if kind == b"grid":
        raise NotImplementedError("AVIF grid items")
    if kind != b"av01":
        raise ValueError(f"AVIF primary item is of type {kind!r}, not av01")
    props = meta.item_properties(item)
    if b"av1C" not in props:
        raise ValueError("AVIF primary item has no av1C property")
    # The alpha item counts only where the colour is premultiplied by it:
    # libavif then divides it out, and convert("RGB") keeps the quotient.
    alpha = None
    if any(ref == b"prem" and source == item for ref, source, _ in meta.refs):
        for ref, source, target in meta.refs:
            if ref == b"auxl" and target == item and _is_alpha(blob, meta, source):
                alpha = meta.item_data(blob, source)
                break
    return meta.item_data(blob, item), props, alpha


def _is_alpha(blob: bytes, meta: "_Meta", item: int) -> bool:
    span = meta.item_properties(item).get(b"auxC")
    if span is None or meta.types.get(item) != b"av01":
        return False
    s, e = span
    return blob[s + 4:e].rstrip(b"\0") in ALPHA_URNS


def _libyuv(y, u, v, name: str):
    """libyuv's YuvPixel on full-size planes."""
    ub, ug, vg, vr, yg, yb = LIBYUV_CONSTANTS[name]
    y1 = ((y.astype(np.int64) * 0x0101 * yg) >> 16) + yb
    ui = u.astype(np.int64) - 128
    vi = v.astype(np.int64) - 128
    b = (y1 + ui * ub) >> 6
    g = (y1 - (ui * ug + vi * vg)) >> 6
    r = (y1 + vi * vr) >> 6
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _up2_rows(plane: np.ndarray, width: int) -> np.ndarray:
    """libyuv's ScaleRowUp2_Linear_Any on each row: ``width`` samples from
    ``(width + 1) // 2``, weights 3:1, the ends copied."""
    src = plane.astype(np.int32)
    out = np.empty((src.shape[0], width), np.int32)
    out[:, 0] = src[:, 0]
    work = (width - 1) & ~1
    if work > 0:
        n = work // 2
        a, b = src[:, :n], src[:, 1:n + 1]
        out[:, 1:work + 1:2] = (3 * a + b + 2) >> 2
        out[:, 2:work + 2:2] = (a + 3 * b + 2) >> 2
    out[:, width - 1] = src[:, (width - 1) // 2]
    return out


def _up2_bilinear(plane: np.ndarray, width: int, height: int) -> np.ndarray:
    """libyuv's I420 bilinear upsampling (I420ToARGBMatrixBilinear): the
    first row, and the last of an even height, linear along the row; the
    rows between from pairs of chroma rows, weights 9:3:3:1 with the ends
    of each row 3:1 down the column."""
    src = plane.astype(np.int32)
    out = np.empty((height, width), np.int32)
    out[0] = _up2_rows(src[:1], width)[0]
    work = (width - 1) & ~1
    n = work // 2
    for k in range((height - 1) // 2):
        s, t = src[k], src[k + 1]
        da, db = out[2 * k + 1], out[2 * k + 2]
        da[0] = (3 * s[0] + t[0] + 2) >> 2
        db[0] = (s[0] + 3 * t[0] + 2) >> 2
        if work > 0:
            s0, s1, t0, t1 = s[:n], s[1:n + 1], t[:n], t[1:n + 1]
            da[1:work + 1:2] = (9 * s0 + 3 * s1 + 3 * t0 + t1 + 8) >> 4
            da[2:work + 2:2] = (3 * s0 + 9 * s1 + t0 + 3 * t1 + 8) >> 4
            db[1:work + 1:2] = (3 * s0 + s1 + 9 * t0 + 3 * t1 + 8) >> 4
            db[2:work + 2:2] = (s0 + 3 * s1 + 3 * t0 + 9 * t1 + 8) >> 4
        last = (width - 1) // 2
        da[width - 1] = (3 * s[last] + t[last] + 2) >> 2
        db[width - 1] = (s[last] + 3 * t[last] + 2) >> 2
    if height % 2 == 0:
        out[height - 1] = _up2_rows(src[height // 2 - 1:height // 2], width)[0]
    return out


def yuv_to_rgb(planes, subx: int, suby: int, matrix: int, full_range: int) -> np.ndarray:
    """libavif 1.3.0's avifImageYUVToRGB to 8-bit RGB, as PIL calls it."""
    y = planes[0]
    height, width = y.shape
    if len(planes) == 1:
        # libavif's own YUV400 path: the float unorm of Y, each channel.
        f32 = np.float32
        if full_range:
            unorm = np.arange(256, dtype=f32) / f32(255)
        else:
            unorm = (np.arange(256, dtype=f32) - f32(16)) / f32(219)
        grey = (f32(0.5) + np.clip(unorm, f32(0), f32(1)) * f32(255)).astype(np.uint8)[y]
        return np.repeat(grey[:, :, None], 3, axis=2)
    u, v = planes[1], planes[2]
    if matrix == 0:
        if subx or suby:
            raise ValueError("AVIF identity matrix with subsampled chroma")
        if not full_range:
            raise NotImplementedError("AVIF identity matrix at limited range")
        return np.stack([v, y, u], axis=-1)
    if matrix not in LIBYUV_MATRICES:
        raise NotImplementedError(f"AVIF nclx matrix_coefficients {matrix}")
    name = LIBYUV_MATRICES[matrix][1 if full_range else 0]
    if subx and suby:
        u = _up2_bilinear(u, width, height)
        v = _up2_bilinear(v, width, height)
    elif subx:
        u = _up2_rows(u, width)
        v = _up2_rows(v, width)
    return _libyuv(y, u, v, name)


def decode_avif(blob: bytes, name: str = "buffer") -> np.ndarray:
    """(H, W, 3) uint8 RGB of an AVIF file's primary image (an ``avis``
    file's first frame), as PIL's ``Image.open(f).convert("RGB")``."""
    try:
        data, props, alpha_data = _parse(blob)
    except struct.error as exc:
        raise ValueError(f"{name}: AVIF container is cut short") from exc
    planes, seq = av1.decode(data)
    colour = _nclx(blob, props)
    if colour is None:
        matrix, full_range = seq.matrix_coefficients, seq.color_range
    else:
        matrix, full_range = colour
    rgb = yuv_to_rgb(planes, seq.subx, seq.suby, matrix, full_range)
    if alpha_data is not None:
        alpha = av1.decode(alpha_data)[0][0]
        if alpha.shape != rgb.shape[:2]:
            raise ValueError(f"{name}: AVIF alpha item's size differs from the image's")
        rgb = unpremultiply(rgb, alpha)
    return rgb


# libyuv's fixed_invtbl8: 1/a in 8.8 fixed point (0 for a = 0, 0x100 for 255).
_UNATTENUATE = np.array([0, 0xFFFF] + [0x10000 // a for a in range(2, 255)] + [0x100],
                        np.int64)


def unpremultiply(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """libyuv's ARGBUnattenuate, which libavif runs on premultiplied
    8-bit RGBA: each channel doubled to 16 bits times 1/alpha, >> 16."""
    scale = _UNATTENUATE[alpha][:, :, None]
    return np.minimum((rgb.astype(np.int64) * 257 * scale) >> 16, 255).astype(np.uint8)
