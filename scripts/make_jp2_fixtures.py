"""Write the JPEG 2000 fixtures that ``tests/test_torch_jpeg2000.py`` and
``chip_smoke.py`` read, with the sha256 of PIL's decodes as their hashes.

    python scripts/make_jp2_fixtures.py [--out tests/fixtures/jp2]

Three kinds of file, each decoded by PIL (OpenJPEG 2.5) as it is written:

* PIL's writer: the modes L, LA, RGB, RGBA and I;16; 5/3 and 9/7, with and
  without the colour transform; several quality layers; 1-7 resolutions;
  the five progression orders; tiles with a tile offset and an image
  offset; precincts; code-blocks from 4x4 to 64x64 and non-square; signed
  samples; PLT markers; raw codestreams;
* the ``libopenjp2`` that Pillow bundles (``pillow.libs/libopenjp2-*.so``)
  through ``ctypes``, for what PIL's writer does not pass: the six
  code-block styles (``opj_cparameters_t.mode``), SOP / EPH (``csty``),
  POC, tile-parts (``tp_on`` / ``tp_flag``), ROI (``roi_compno`` /
  ``roi_shift``), subsampled components and 12-bit samples; each file's
  markers are read back to check that it carries what was set;
* rewrites here of written files for what neither can make: packet
  headers moved into PPM or PPT (EPH marks where each ends), derived
  quantisation, a last tile-part of Psot 0, XL and zero box lengths, and
  JP2 headers with ``pclr`` / ``cmap``, ``cdef``, sYCC and CMYK colour.

Also the 12 golden scenes of ``tests/fixtures/golden_offline`` as lossy
9/7 JP2 (compression ratio ``GOLDEN_RATE``), scene 3 as lossless 5/3, and
a 640x480 photo (``tests/fixtures/test_image.jpg``) as lossy 9/7 JP2.
``hashes.json`` beside them holds each file's shape and the sha256 of
``np.array(PIL.Image.open(f).convert("RGB"))``. The script needs PIL; the
files it writes do not. ``mq_encode`` is T.800 Annex C's encoder, for the
tests of the MQ decoder.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import hashlib
import io
import json
import os
import struct
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "..", "tests", "fixtures", "golden_offline")
PHOTO = os.path.join(HERE, "..", "tests", "fixtures", "test_image.jpg")
GOLDEN_RATE = 16  # compression ratio of the lossy golden scenes

# ---------------------------------------------------------------------------
# The MQ coder (T.800 Annex C), for the decoder's tests
# ---------------------------------------------------------------------------


def mq_encode(decisions, contexts, initial=None) -> bytes:
    """The MQ codeword of ``decisions`` (0 / 1), each coded in the context
    of the same index of ``contexts``; ``initial`` maps a context to its
    first state index (0 otherwise), its MPS 0. Encoder of T.800 C.2 with
    OpenJPEG's byte-out and flush."""
    from keras_ocr_tpu_torch.jpeg2000_t1 import MQ_TABLE

    state = {}
    mps = {}
    out = bytearray([0])
    a, c, ct = 0x8000, 0, 12

    def byte_out():
        nonlocal c, ct
        if out[-1] == 0xFF:
            out.append((c >> 20) & 0xFF)
            c &= 0xFFFFF
            ct = 7
        elif not c & 0x8000000:
            out.append((c >> 19) & 0xFF)
            c &= 0x7FFFF
            ct = 8
        else:
            out[-1] += 1
            if out[-1] == 0xFF:
                c &= 0x7FFFFFF
                out.append((c >> 20) & 0xFF)
                c &= 0xFFFFF
                ct = 7
            else:
                out.append((c >> 19) & 0xFF)
                c &= 0x7FFFF
                ct = 8

    def renorm():
        nonlocal a, c, ct
        while True:
            a = (a << 1) & 0xFFFF
            c = (c << 1) & 0xFFFFFFFF
            ct -= 1
            if ct == 0:
                byte_out()
            if a & 0x8000:
                break

    for d, cx in zip(decisions, contexts):
        index = state.setdefault(cx, (initial or {}).get(cx, 0))
        m = mps.setdefault(cx, 0)
        qe, n_mps, n_lps, switch = MQ_TABLE[index]
        if d == m:
            a -= qe
            if not a & 0x8000:
                if a < qe:
                    a = qe
                else:
                    c += qe
                state[cx] = n_mps
                renorm()
            else:
                c += qe
        else:
            a -= qe
            if a < qe:
                c += qe
            else:
                a = qe
            if switch:
                mps[cx] = 1 - m
            state[cx] = n_lps
            renorm()
    temp = c + a
    c |= 0xFFFF
    if c >= temp:
        c -= 0x8000
    c = (c << ct) & 0xFFFFFFFF
    byte_out()
    c = (c << ct) & 0xFFFFFFFF
    byte_out()
    if out[-1] == 0xFF:
        out.pop()
    return bytes(out[1:])


# ---------------------------------------------------------------------------
# Pixels
# ---------------------------------------------------------------------------


def scene(height: int, width: int, seed: int = 0) -> np.ndarray:
    """A small RGB test scene: gradients, a few sharp edges, texture."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    r = 128 + 100 * np.sin(x / 6.0 + seed) * np.cos(y / 9.0)
    g = 40 + 3 * x + 2 * y
    b = np.where((x // 8 + y // 8) % 2 == 0, 200, 60) + rng.normal(0, 12, (height, width))
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def golden_scene(index: int) -> np.ndarray:
    from PIL import Image

    with Image.open(os.path.join(GOLDEN, f"scene_{index:02d}.png")) as im:
        return np.asarray(im.convert("RGB"))


def photo() -> np.ndarray:
    from PIL import Image

    with Image.open(PHOTO) as im:
        return np.asarray(im.convert("RGB"))


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------


def pil_jp2(pixels: np.ndarray, **options) -> bytes:
    """``PIL.Image.save(format="JPEG2000")`` of ``pixels`` (uint8 grey,
    LA, RGB or RGBA, or uint16 grey as I;16)."""
    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(pixels).save(out, format="JPEG2000", **options)
    return out.getvalue()


_U32, _I32, _INT = ctypes.c_uint32, ctypes.c_int32, ctypes.c_int


class _Poc(ctypes.Structure):
    _fields_ = ([(n, _U32) for n in ("resno0", "compno0", "layno1", "resno1", "compno1",
                                     "layno0", "precno0", "precno1")]
                + [("prg1", _INT), ("prg", _INT), ("progorder", ctypes.c_char * 5),
                   ("tile", _U32)]
                + [(n, _I32) for n in ("tx0", "tx1", "ty0", "ty1")]
                + [(n, _U32) for n in ("layS", "resS", "compS", "prcS", "layE", "resE", "compE",
                                       "prcE", "txS", "txE", "tyS", "tyE", "dx", "dy", "lay_t",
                                       "res_t", "comp_t", "prc_t", "tx0_t", "ty0_t")])


class _Parameters(ctypes.Structure):
    """``opj_cparameters_t`` of OpenJPEG 2.5's ``openjpeg.h``."""
    _fields_ = [
        ("tile_size_on", _INT), ("cp_tx0", _INT), ("cp_ty0", _INT), ("cp_tdx", _INT),
        ("cp_tdy", _INT), ("cp_disto_alloc", _INT), ("cp_fixed_alloc", _INT),
        ("cp_fixed_quality", _INT), ("cp_matrice", ctypes.c_void_p),
        ("cp_comment", ctypes.c_char_p), ("csty", _INT), ("prog_order", _INT),
        ("POC", _Poc * 32), ("numpocs", _U32), ("tcp_numlayers", _INT),
        ("tcp_rates", ctypes.c_float * 100), ("tcp_distoratio", ctypes.c_float * 100),
        ("numresolution", _INT), ("cblockw_init", _INT), ("cblockh_init", _INT), ("mode", _INT),
        ("irreversible", _INT), ("roi_compno", _INT), ("roi_shift", _INT), ("res_spec", _INT),
        ("prcw_init", _INT * 33), ("prch_init", _INT * 33), ("infile", ctypes.c_char * 4096),
        ("outfile", ctypes.c_char * 4096), ("index_on", _INT), ("index", ctypes.c_char * 4096),
        ("image_offset_x0", _INT), ("image_offset_y0", _INT), ("subsampling_dx", _INT),
        ("subsampling_dy", _INT), ("decod_format", _INT), ("cod_format", _INT),
        ("jpwl_epc_on", _INT), ("jpwl_hprot_MH", _INT), ("jpwl_hprot_TPH_tileno", _INT * 16),
        ("jpwl_hprot_TPH", _INT * 16), ("jpwl_pprot_tileno", _INT * 16),
        ("jpwl_pprot_packno", _INT * 16), ("jpwl_pprot", _INT * 16), ("jpwl_sens_size", _INT),
        ("jpwl_sens_addr", _INT), ("jpwl_sens_range", _INT), ("jpwl_sens_MH", _INT),
        ("jpwl_sens_TPH_tileno", _INT * 16), ("jpwl_sens_TPH", _INT * 16), ("cp_cinema", _INT),
        ("max_comp_size", _INT), ("cp_rsiz", _INT), ("tp_on", ctypes.c_char),
        ("tp_flag", ctypes.c_char), ("tcp_mct", ctypes.c_char), ("jpip_on", _INT),
        ("mct_data", ctypes.c_void_p), ("max_cs_size", _INT), ("rsiz", ctypes.c_uint16)]


class _ComponentParameters(ctypes.Structure):
    _fields_ = [(n, _U32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class _ImageComponent(ctypes.Structure):
    _fields_ = ([(n, _U32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
                                     "resno_decoded", "factor")]
                + [("data", ctypes.POINTER(_I32)), ("alpha", ctypes.c_uint16)])


class _Image(ctypes.Structure):
    _fields_ = [("x0", _U32), ("y0", _U32), ("x1", _U32), ("y1", _U32), ("numcomps", _U32),
                ("color_space", _INT), ("comps", ctypes.POINTER(_ImageComponent)),
                ("icc_profile_buf", ctypes.c_void_p), ("icc_profile_len", _U32)]


_LIB = None


def libopenjp2():
    """Pillow's bundled OpenJPEG, its encoder entry points typed; the
    parameter layout checked against ``opj_set_default_encoder_parameters``."""
    global _LIB
    if _LIB is None:
        import PIL

        libs = os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs")
        lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libopenjp2-*.so*"))[0])
        image_p, params_p = ctypes.POINTER(_Image), ctypes.POINTER(_Parameters)
        lib.opj_set_default_encoder_parameters.argtypes = [params_p]
        lib.opj_image_create.restype = image_p
        lib.opj_image_create.argtypes = [_U32, ctypes.POINTER(_ComponentParameters), _INT]
        lib.opj_image_destroy.argtypes = [image_p]
        lib.opj_create_compress.restype = ctypes.c_void_p
        lib.opj_create_compress.argtypes = [_INT]
        lib.opj_setup_encoder.argtypes = [ctypes.c_void_p, params_p, image_p]
        lib.opj_stream_create_default_file_stream.restype = ctypes.c_void_p
        lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, _INT]
        lib.opj_start_compress.argtypes = [ctypes.c_void_p, image_p, ctypes.c_void_p]
        lib.opj_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.opj_end_compress.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.opj_stream_destroy.argtypes = [ctypes.c_void_p]
        lib.opj_destroy_codec.argtypes = [ctypes.c_void_p]
        check = _Parameters()
        lib.opj_set_default_encoder_parameters(ctypes.byref(check))
        if (check.numresolution, check.cblockw_init, check.roi_compno, check.subsampling_dx,
                check.decod_format, check.cod_format) != (6, 64, -1, 1, -1, -1):
            raise RuntimeError("libopenjp2's opj_cparameters_t is not laid out as expected")
        _LIB = lib
    return _LIB


ORDERS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}


def opj_encode(planes, precision: int = 8, signed: bool = False, sampling=None,
               jp2: bool = False, rates=(0,), irreversible: bool = False, mct: int = 0,
               resolutions: int = 6, codeblock=(64, 64), precincts=None, order: str = "LRCP",
               mode: int = 0, csty: int = 0, pocs=(), tile_parts: str = "", roi=None,
               tile=None) -> bytes:
    """A codestream (or a JP2 file) of ``planes`` (one (h, w) int array per
    component, already subsampled by ``sampling``'s (dx, dy)) written by
    ``opj_encode`` with these ``opj_cparameters_t`` fields."""
    lib = libopenjp2()
    sampling = sampling or [(1, 1)] * len(planes)
    height, width = next(p.shape for p, s in zip(planes, sampling) if s == (1, 1))
    params = (_ComponentParameters * len(planes))()
    for k, (plane, (dx, dy)) in enumerate(zip(planes, sampling)):
        params[k].dx, params[k].dy = dx, dy
        params[k].w, params[k].h = plane.shape[1], plane.shape[0]
        params[k].prec, params[k].sgnd = precision, int(signed)
    colour = 1 if len(planes) >= 3 else 2  # OPJ_CLRSPC_SRGB / OPJ_CLRSPC_GRAY
    image = lib.opj_image_create(len(planes), params, colour)
    codec = stream = None
    path = None
    try:
        image.contents.x0, image.contents.y0 = 0, 0
        image.contents.x1, image.contents.y1 = width, height
        for k, plane in enumerate(planes):
            data = np.ascontiguousarray(plane, dtype=np.int32)
            ctypes.memmove(image.contents.comps[k].data, data.ctypes.data, data.nbytes)
        p = _Parameters()
        lib.opj_set_default_encoder_parameters(ctypes.byref(p))
        p.tcp_numlayers = len(rates)
        for k, rate in enumerate(rates):
            p.tcp_rates[k] = rate
        p.cp_disto_alloc = 1
        p.irreversible = int(irreversible)
        p.tcp_mct = bytes([mct])
        p.numresolution = resolutions
        p.cblockw_init, p.cblockh_init = codeblock
        p.prog_order = ORDERS[order]
        p.mode = mode
        p.csty = csty
        if precincts:
            p.csty |= 1
            p.res_spec = len(precincts)
            for k, (pw, ph) in enumerate(precincts):
                p.prcw_init[k], p.prch_init[k] = pw, ph
        if tile:
            p.tile_size_on = 1
            p.cp_tdx, p.cp_tdy = tile
        for k, (res0, comp0, layer1, res1, comp1, poc_order) in enumerate(pocs):
            poc = p.POC[k]
            poc.tile, poc.resno0, poc.compno0, poc.layno1 = 1, res0, comp0, layer1
            poc.resno1, poc.compno1, poc.prg1 = res1, comp1, ORDERS[poc_order]
        p.numpocs = len(pocs)
        if tile_parts:
            p.tp_on, p.tp_flag = b"\x01", tile_parts.encode()
        if roi:
            p.roi_compno, p.roi_shift = roi
        codec = lib.opj_create_compress(2 if jp2 else 0)  # OPJ_CODEC_JP2 / OPJ_CODEC_J2K
        if not lib.opj_setup_encoder(codec, ctypes.byref(p), image):
            raise RuntimeError("opj_setup_encoder refused the parameters")
        handle, path = tempfile.mkstemp(suffix=".jp2" if jp2 else ".j2k")
        os.close(handle)
        stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        if not (lib.opj_start_compress(codec, image, stream) and lib.opj_encode(codec, stream)
                and lib.opj_end_compress(codec, stream)):
            raise RuntimeError("opj_encode failed")
        lib.opj_stream_destroy(stream)
        stream = None
        with open(path, "rb") as f:
            return f.read()
    finally:
        if stream:
            lib.opj_stream_destroy(stream)
        if codec:
            lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)
        if path:
            os.remove(path)


# ---------------------------------------------------------------------------
# Reading and rewriting codestreams and JP2 boxes
# ---------------------------------------------------------------------------


def codestream_of(blob: bytes) -> bytes:
    """The codestream of a JP2 file (or the blob itself)."""
    if blob[:4] == b"\xff\x4f\xff\x51":
        return blob
    pos = 0
    while pos < len(blob):
        length, kind = struct.unpack_from(">I4s", blob, pos)
        header = 8
        if length == 1:
            length, header = struct.unpack_from(">Q", blob, pos + 8)[0], 16
        if kind == b"jp2c":
            return blob[pos + header:pos + length] if length else blob[pos + header:]
        pos += length
    raise ValueError("no jp2c box")


def markers(codestream: bytes):
    """[(marker, offset, body)] of the main header and every tile-part
    header, and each tile-part's data as (0xFF93, offset, data)."""
    out = []
    pos = 2
    out.append((0xFF4F, 0, b""))
    tile_end = None
    while pos < len(codestream):
        marker = struct.unpack_from(">H", codestream, pos)[0]
        if marker == 0xFFD9:
            out.append((marker, pos, b""))
            break
        if marker == 0xFF93:
            out.append((marker, pos, codestream[pos + 2:tile_end]))
            pos = tile_end
            continue
        length = struct.unpack_from(">H", codestream, pos + 2)[0]
        body = codestream[pos + 4:pos + 2 + length]
        if marker == 0xFF90:
            psot = struct.unpack_from(">I", body, 2)[0]
            tile_end = pos + psot if psot else len(codestream) - 2
        out.append((marker, pos, body))
        pos += 2 + length
    return out


def segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def rebuild(parts) -> bytes:
    """A codestream from [(marker, body)], SOT's Psot recomputed for each
    tile-part (SOT up to the end of its data)."""
    out = bytearray()
    sot_at = None
    for marker, body in parts:
        if marker == 0xFF4F:
            out += b"\xff\x4f"
        elif marker == 0xFFD9:
            out += b"\xff\xd9"
        elif marker == 0xFF93:
            out += b"\xff\x93" + body
            struct.pack_into(">I", out, sot_at + 6, len(out) - sot_at)
        else:
            if marker == 0xFF90:
                sot_at = len(out)
            out += segment(marker, body)
    return bytes(out)


def split_packets(data: bytes):
    """A tile-part's data written with SOP and EPH: [(header, body)], each
    header with its EPH, without its SOP."""
    starts = []
    pos = data.find(b"\xff\x91")
    while pos >= 0:
        starts.append(pos)
        pos = data.find(b"\xff\x91", pos + 6)
    packets = []
    for k, start in enumerate(starts):
        end = starts[k + 1] if k + 1 < len(starts) else len(data)
        eph = data.index(b"\xff\x92", start + 6) + 2
        packets.append((data[start + 6:eph], data[eph:end]))
    return packets


def packed_headers(codestream: bytes, where: str) -> bytes:
    """``codestream`` (written with SOP and EPH) with its packet headers
    moved into one PPM marker of the main header (``where="ppm"``) or a
    PPT marker in each tile-part header (``"ppt"``), its SOP markers
    dropped."""
    parts = []
    ppm = bytearray()
    pending = None
    for marker, _, body in markers(codestream):
        if marker == 0xFF52:
            body = bytes([body[0] & ~2]) + body[1:]
        if marker == 0xFF90 and where == "ppm" and pending is None:
            pending = len(parts)
        if marker == 0xFF93:
            packets = split_packets(body)
            headers = b"".join(h for h, _ in packets)
            if where == "ppm":
                ppm += struct.pack(">I", len(headers)) + headers
            else:
                parts.append((0xFF61, b"\x00" + headers))
            body = b"".join(b for _, b in packets)
        parts.append((marker, body))
    if where == "ppm":
        parts.insert(pending, (0xFF60, b"\x00" + bytes(ppm)))
    return rebuild(parts)


def derived_quantisation(codestream: bytes) -> bytes:
    """``codestream`` with its QCD rewritten to scalar derived
    quantisation: one (exponent, mantissa), that of the LL band."""
    parts = []
    for marker, _, body in markers(codestream):
        if marker == 0xFF5C:
            body = bytes([(body[0] & 0xE0) | 1]) + body[1:3]
        parts.append((marker, body))
    return rebuild(parts)


def last_part_to_end(codestream: bytes) -> bytes:
    """``codestream`` with its last tile-part's Psot set to 0."""
    out = bytearray(codestream)
    last = max(offset for marker, offset, _ in markers(codestream) if marker == 0xFF90)
    struct.pack_into(">I", out, last + 6, 0)
    return bytes(out)


def with_main_marker(codestream: bytes, marker: int, body: bytes) -> bytes:
    """``codestream`` with a marker segment added after SIZ."""
    siz_end = 4 + struct.unpack_from(">H", codestream, 4)[0]
    return codestream[:siz_end] + segment(marker, body) + codestream[siz_end:]


def box(kind: bytes, payload: bytes, length: str = "plain") -> bytes:
    if length == "xl":
        return struct.pack(">I4sQ", 1, kind, len(payload) + 16) + payload
    if length == "zero":
        return struct.pack(">I4s", 0, kind) + payload
    return struct.pack(">I4s", len(payload) + 8, kind) + payload


def jp2_file(codestream: bytes, enumcs: int = None, extra: bytes = b"", colr: bytes = None,
             jp2c: str = "plain", ihdr=None) -> bytes:
    """A JP2 file around ``codestream``: signature, ``ftyp``, ``jp2h``
    (``ihdr`` from SIZ unless given, a ``colr`` of ``enumcs`` or the
    payload ``colr``, then ``extra`` sub-boxes) and ``jp2c``."""
    xsiz, ysiz, xosiz, yosiz = struct.unpack_from(">IIII", codestream, 8)
    csiz = struct.unpack_from(">H", codestream, 40)[0]
    depths = {codestream[42 + 3 * k] for k in range(csiz)}
    bpc = depths.pop() if len(depths) == 1 else 255
    if ihdr is None:
        ihdr = (ysiz - yosiz, xsiz - xosiz, csiz, bpc)
    header = box(b"ihdr", struct.pack(">IIHBBBB", *ihdr, 7, 0, 0))
    if colr is None:
        if enumcs is None:
            enumcs = 17 if csiz <= 2 else 16
        colr = struct.pack(">BBBI", 1, 0, 0, enumcs)
    header += box(b"colr", colr) + extra
    return (b"\x00\x00\x00\x0cjP  \r\n\x87\n" + box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ")
            + box(b"jp2h", header) + box(b"jp2c", codestream, jp2c))


def pclr_boxes(palette: np.ndarray, channels: int = 1) -> bytes:
    """``pclr`` of an (entries, columns) uint8 palette and ``cmap`` mapping
    component 0 through it (and component 1 directly when ``channels`` is
    2)."""
    entries, columns = palette.shape
    pclr = struct.pack(">HB", entries, columns) + bytes([7] * columns) + palette.tobytes()
    cmap = b"".join(struct.pack(">HBB", 0, 1, k) for k in range(columns))
    if channels == 2:
        cmap += struct.pack(">HBB", 1, 0, 0)
    return box(b"pclr", pclr) + box(b"cmap", cmap)


def cdef_box(entries) -> bytes:
    return box(b"cdef", struct.pack(">H", len(entries))
               + b"".join(struct.pack(">HHH", *e) for e in entries))


# ---------------------------------------------------------------------------
# The fixtures
# ---------------------------------------------------------------------------

STYLES = {"bypass": 1, "reset": 2, "termall": 4, "vsc": 8, "pterm": 16, "segsym": 32}


def small_fixtures() -> dict:
    """name -> bytes of every small fixture (64 x 64 px or less)."""
    rgb = scene(43, 57, seed=1)
    grey = rgb[..., 1]
    alpha = scene(43, 57, seed=2)[..., 0]
    square = scene(64, 64, seed=3)
    out = {}
    out["l_53.jp2"] = pil_jp2(grey)
    out["l_97.jp2"] = pil_jp2(grey, irreversible=True, quality_layers=[8])
    out["la_53.jp2"] = pil_jp2(np.dstack([grey, alpha]))
    out["rgb_53_rct.jp2"] = pil_jp2(rgb, mct=1)
    out["rgb_97_ict.jp2"] = pil_jp2(rgb, irreversible=True, mct=1, quality_layers=[12])
    out["rgb_97_mct0.jp2"] = pil_jp2(rgb, irreversible=True, quality_layers=[10])
    out["rgb_53_mct0.j2k"] = pil_jp2(rgb, no_jp2=True)
    out["rgba_53.jp2"] = pil_jp2(np.dstack([rgb, alpha]), mct=1)
    out["rgba_97.j2k"] = pil_jp2(np.dstack([rgb, alpha]), irreversible=True, mct=1,
                                 quality_layers=[9], no_jp2=True)
    out["i16_53.jp2"] = pil_jp2(grey.astype(np.uint16) * 3 + 7)
    out["i16_97.j2k"] = pil_jp2(grey.astype(np.uint16) * 150, irreversible=True,
                                quality_layers=[6], no_jp2=True)
    out["layers_97.jp2"] = pil_jp2(rgb, irreversible=True, mct=1, quality_layers=[40, 20, 8])
    out["layers_53.jp2"] = pil_jp2(rgb, mct=1, quality_layers=[30, 10, 0])
    for n in (1, 2, 7):
        out[f"res{n}.jp2"] = pil_jp2(square, mct=1, num_resolutions=n, irreversible=n == 7,
                                     quality_layers=[10] if n == 7 else None)
    for order in ORDERS:
        out[f"order_{order.lower()}.jp2"] = pil_jp2(
            rgb, mct=1, progression=order, precinct_size=(16, 16), codeblock_size=(8, 8),
            num_resolutions=4, quality_layers=[24, 8, 0])
    out["tiles_offsets.jp2"] = pil_jp2(rgb, mct=1, tile_size=(16, 20), tile_offset=(3, 5),
                                       offset=(7, 9), quality_layers=[12, 0])
    out["tiles_97.j2k"] = pil_jp2(rgb, irreversible=True, mct=1, tile_size=(32, 32),
                                  quality_layers=[14], no_jp2=True)
    out["precincts.jp2"] = pil_jp2(square, mct=1, precinct_size=(32, 32), codeblock_size=(16, 16),
                                   quality_layers=[20, 0])
    out["cb4x4.jp2"] = pil_jp2(rgb, mct=1, codeblock_size=(4, 4))
    out["cb64x64.j2k"] = pil_jp2(square, codeblock_size=(64, 64), no_jp2=True)
    out["cb32x4.jp2"] = pil_jp2(rgb, irreversible=True, mct=1, codeblock_size=(32, 4),
                                quality_layers=[10])
    out["cb4x64.jp2"] = pil_jp2(rgb, mct=1, codeblock_size=(4, 64))
    out["signed.jp2"] = pil_jp2(grey, signed=True)
    out["signed_rgb.j2k"] = pil_jp2(rgb, signed=True, irreversible=True, mct=1,
                                    quality_layers=[10], no_jp2=True)
    out["plt.jp2"] = pil_jp2(rgb, mct=1, plt=True, quality_layers=[20, 0])

    planes = [rgb[..., k].astype(np.int32) for k in range(3)]
    for style, bit in STYLES.items():
        out[f"style_{style}.j2k"] = opj_encode(planes, rates=(30, 10, 0), mode=bit,
                                               codeblock=(16, 16), mct=1)
    out["style_all.j2k"] = opj_encode(planes, rates=(20, 6, 0), mode=63, codeblock=(32, 8),
                                      mct=1)
    out["style_all_97.j2k"] = opj_encode(planes, rates=(20, 6), mode=63, irreversible=True,
                                         mct=1)
    out["sop_eph.j2k"] = opj_encode(planes, rates=(25, 8, 0), csty=6, mct=1,
                                    precincts=[(16, 16)] * 6, codeblock=(8, 8), order="RPCL")
    out["poc.j2k"] = opj_encode(planes, rates=(25, 8, 0), mct=1, codeblock=(8, 8),
                                pocs=[(0, 0, 3, 3, 3, "RLCP"), (0, 0, 3, 6, 3, "CPRL")])
    for flag in "RLC":
        out[f"tile_parts_{flag.lower()}.j2k"] = opj_encode(
            planes, rates=(25, 8, 0), mct=1, tile_parts=flag, tile=(32, 32), codeblock=(16, 16))
    out["roi.j2k"] = opj_encode(planes, rates=(30, 10), mct=1, roi=(0, 7), irreversible=True)
    out["roi_53.j2k"] = opj_encode([grey.astype(np.int32)], rates=(12, 0), roi=(0, 5))
    chroma = [rgb[::2, ::2, k].astype(np.int32) for k in (0, 2)]
    out["subsampled.j2k"] = opj_encode([planes[1], *chroma], sampling=[(1, 1), (2, 2), (2, 2)],
                                       rates=(12, 0))
    out["subsampled_97.jp2"] = opj_encode([planes[1], *chroma], sampling=[(1, 1), (2, 2), (2, 2)],
                                          rates=(10,), irreversible=True, jp2=True)
    twelve = [(p * 16 + p // 16).astype(np.int32) for p in planes]
    out["bits12_grey.j2k"] = opj_encode([twelve[1]], precision=12, rates=(0,))
    out["bits12_rgb.j2k"] = opj_encode(twelve, precision=12, rates=(15,), irreversible=True,
                                       mct=1)
    out["bits5_grey.j2k"] = opj_encode([planes[1] >> 3], precision=5, rates=(0,))
    out["bits9_grey.jp2"] = opj_encode([planes[1] * 2 + 1], precision=9, rates=(0,), jp2=True)
    out["bits12_signed.j2k"] = opj_encode([twelve[0] - 2048, twelve[1] - 2048, twelve[2] - 2048],
                                          precision=12, signed=True, rates=(0,))

    sop = opj_encode(planes, rates=(25, 8, 0), csty=6, mct=1, codeblock=(16, 16), tile=(32, 32))
    out["ppm.j2k"] = packed_headers(sop, "ppm")
    out["ppt.j2k"] = packed_headers(sop, "ppt")
    out["derived_quant.j2k"] = derived_quantisation(
        codestream_of(pil_jp2(rgb, irreversible=True, mct=1, quality_layers=[10])))
    out["psot_zero.j2k"] = last_part_to_end(opj_encode(planes, rates=(0,), mct=1, tile=(32, 32)))

    indices = (grey // 37).astype(np.int32)
    palette = np.array([[0, 0, 0], [200, 30, 30], [30, 200, 30], [30, 30, 200],
                        [200, 200, 30], [30, 200, 200], [200, 200, 200]], dtype=np.uint8)
    index_stream = opj_encode([indices], rates=(0,))
    out["pclr.jp2"] = jp2_file(index_stream, 16, pclr_boxes(palette))
    out["pclr_duplicates.jp2"] = jp2_file(
        index_stream, 16, pclr_boxes(palette[[0, 1, 1, 3, 0, 5, 6]]))
    out["pclr_pa.jp2"] = jp2_file(opj_encode([indices, alpha.astype(np.int32)], rates=(0,)), 16,
                                  pclr_boxes(palette, channels=2))
    rgb_stream = opj_encode(planes, rates=(0,), mct=1)
    out["cdef_bgr.jp2"] = jp2_file(rgb_stream, 16, cdef_box([(0, 0, 3), (1, 0, 2), (2, 0, 1)]))
    rgba_stream = opj_encode([*planes, alpha.astype(np.int32)], rates=(0,), mct=1)
    out["cdef_alpha_first.jp2"] = jp2_file(rgba_stream, 16, cdef_box(
        [(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)]))
    ycc = np.asarray(_pil_image(rgb).convert("YCbCr"))
    out["sycc.jp2"] = jp2_file(opj_encode([ycc[..., k].astype(np.int32) for k in range(3)],
                                          rates=(0,)), 18)
    out["sycc_subsampled.jp2"] = jp2_file(opj_encode(
        [ycc[..., 0].astype(np.int32), ycc[::2, ::2, 1].astype(np.int32),
         ycc[::2, ::2, 2].astype(np.int32)], sampling=[(1, 1), (2, 2), (2, 2)], rates=(0,)), 18)
    cmyk = np.asarray(_pil_image(rgb).convert("CMYK"))
    out["cmyk.jp2"] = jp2_file(opj_encode([cmyk[..., k].astype(np.int32) for k in range(4)],
                                          rates=(8,), irreversible=True), 12)
    out["grey_colr_jp2c_xl.jp2"] = jp2_file(codestream_of(out["l_53.jp2"]), 17, jp2c="xl")
    out["jp2c_length_zero.jp2"] = jp2_file(codestream_of(out["rgb_53_rct.jp2"]), 16, jp2c="zero")
    return out


def _pil_image(pixels):
    from PIL import Image

    return Image.fromarray(pixels)


def large_fixtures() -> dict:
    """The golden scenes (lossy 9/7 JP2, scene 3 also lossless 5/3) and
    the 640x480 photo as lossy 9/7 JP2."""
    out = {}
    for k in range(12):
        out[f"scene_{k:02d}.jp2"] = pil_jp2(golden_scene(k), irreversible=True, mct=1,
                                            quality_layers=[GOLDEN_RATE])
    out["scene_03_lossless.jp2"] = pil_jp2(golden_scene(3), mct=1)
    out["photo_640x480.jp2"] = pil_jp2(photo(), irreversible=True, mct=1, quality_layers=[20])
    return out


def check_markers(name: str, blob: bytes):
    """Each ``opj_encode`` fixture carries the markers and fields asked for."""
    stream = codestream_of(blob)
    found = markers(stream)
    kinds = [m for m, _, _ in found]
    cod = next(body for m, _, body in found if m == 0xFF52)
    if name.startswith("style_"):
        want = 63 if name.startswith("style_all") else STYLES[name[6:-4]]
        assert cod[8] == want, (name, cod[8])
    if name == "sop_eph.j2k":
        assert cod[0] & 6 == 6 and cod[1] == 2, (name, cod[:2])
    if name == "poc.j2k":
        assert 0xFF5F in kinds, name
    if name.startswith("tile_parts_"):
        parts = [struct.unpack_from(">HIBB", body) for m, _, body in found if m == 0xFF90]
        assert max(p[2] for p in parts) >= 1, (name, parts)
    if name.startswith("roi"):
        assert 0xFF5E in kinds, name
    if name.startswith("subsampled"):
        assert stream[43:45] == b"\x01\x01" and stream[46:48] == b"\x02\x02", name
    if name.startswith("bits12"):
        assert stream[42] & 0x7F == 11, name
    if name in ("ppm.j2k", "ppt.j2k"):
        assert (0xFF60 if name == "ppm.j2k" else 0xFF61) in kinds, name


def pil_decode(blob: bytes) -> np.ndarray:
    """The oracle: ``np.array(PIL.Image.open(f).convert("RGB"))``."""
    from PIL import Image

    with Image.open(io.BytesIO(blob)) as image:
        return np.array(image.convert("RGB"))


def pil_hash(blob: bytes) -> dict:
    rgb = pil_decode(blob)
    return {"shape": list(rgb.shape), "decoded_sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}


def fixtures() -> dict:
    made = small_fixtures()
    for name, blob in made.items():
        check_markers(name, blob)
    made.update(large_fixtures())
    return made


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(HERE, "..", "tests", "fixtures", "jp2"))
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    hashes = {}
    for name, blob in fixtures().items():
        hashes[name] = pil_hash(blob)
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(blob)
        print(name, len(blob), "bytes", hashes[name]["shape"], hashes[name]["decoded_sha256"])
    with open(os.path.join(args.out, "hashes.json"), "w") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
