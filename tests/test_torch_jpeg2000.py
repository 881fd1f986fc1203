"""Port parity: ``tools.read`` of JPEG 2000 files
(``keras_ocr_tpu_torch/jpeg2000.py``, ``jpeg2000_t1.py``).

JAX's ``tools.read`` is PIL's ``Image.open(f).convert("RGB")``, which
decodes JPEG 2000 with OpenJPEG; the port's decode must equal it bit for
bit:

* every small fixture of ``tests/fixtures/jp2`` (written by
  ``scripts/make_jp2_fixtures.py``: PIL's writer, OpenJPEG's encoder
  through ``ctypes`` and the script's rewrites), and golden scene 3 as
  lossy 9/7 and lossless 5/3 JP2, by path against JAX's ``read`` and
  against the sha256 of PIL's decode in ``hashes.json``;
* what PIL reads and the port does not (HTJ2K, Part-2) raises
  ``NotImplementedError`` naming the kind; what PIL refuses raises
  ``ValueError``;
* truncated streams (PIL fails each) and streams with a byte flipped
  (PIL returns garbage pixels or fails) end as PIL's do;
* the MQ decoder on ITU-T T.88 H.2's test sequence (the same coder) and on
  the script's encoder's codewords; the 5/3 inverse against a direct
  integer reference; the level shift's ``lrintf`` rounding; PIL's YCbCr
  tables.
"""

import hashlib
import io
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from keras_ocr_tpu import tools as jtools
from keras_ocr_tpu_torch import jpeg2000, jpeg2000_t1, tools

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_jp2_fixtures as mf  # noqa: E402

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
JP2 = os.path.join(HERE, "fixtures", "jp2")
with open(os.path.join(JP2, "hashes.json"), encoding="utf8") as _f:
    HASHES = json.load(_f)
LARGE = {f"scene_{k:02d}.jp2" for k in range(12)} | {"scene_03_lossless.jp2",
                                                      "photo_640x480.jp2"}
SMALL = sorted(set(HASHES) - LARGE)


def _read(name):
    with open(os.path.join(JP2, name), "rb") as f:
        return f.read()


def _same_as_pil(name):
    path = os.path.join(JP2, name)
    got, want = tools.read(path), jtools.read(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert list(got.shape) == HASHES[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == HASHES[name]["decoded_sha256"]


@pytest.mark.parametrize("name", SMALL)
def test_fixture_matches_pil(name):
    _same_as_pil(name)


@pytest.mark.parametrize("name", ["scene_03.jp2", "scene_03_lossless.jp2"])
def test_golden_scene_matches_pil(name):
    _same_as_pil(name)


def test_fixtures_are_the_scripts():
    """The script writes the committed small fixtures byte for byte, and
    PIL decodes each to its recorded hash."""
    made = mf.small_fixtures()
    assert sorted(made) == SMALL
    for name, blob in made.items():
        assert blob == _read(name), name
        assert mf.pil_hash(blob) == HASHES[name], name


def test_kinds_are_covered():
    """The fixtures carry every coding kind the decoder reads."""
    seen = {"order": set(), "style": 0, "csty": 0, "transform": set(), "mct": set(),
            "markers": set(), "qstyle": set(), "cblk": set(), "subsampled": False,
            "precision": set(), "signed": False, "layers": set(), "tiles": False,
            "offset": False, "enumcs": set(), "boxes": set()}
    for name in SMALL:
        blob = _read(name)
        stream = mf.codestream_of(blob)
        if blob[:4] != stream[:4]:
            pos = blob.index(b"jp2h") + 4
            seen["boxes"] |= {blob[pos + k:pos + k + 4] for k in range(0, 200)
                              if blob[pos + k:pos + k + 4] in (b"pclr", b"cmap", b"cdef")}
            colr = blob.find(b"colr")
            seen["enumcs"].add(struct.unpack_from(">I", blob, colr + 7)[0])
        xsiz, ysiz, xo, yo, tdx, tdy = struct.unpack_from(">IIIIII", stream, 8)
        seen["tiles"] |= tdx < xsiz - xo or tdy < ysiz - yo
        seen["offset"] |= xo > 0 or yo > 0
        csiz = struct.unpack_from(">H", stream, 40)[0]
        for k in range(csiz):
            ssiz, dx, dy = stream[42 + 3 * k:45 + 3 * k]
            seen["precision"].add((ssiz & 0x7F) + 1)
            seen["signed"] |= bool(ssiz & 0x80)
            seen["subsampled"] |= dx > 1 or dy > 1
        for marker, _, body in mf.markers(stream):
            seen["markers"].add(marker)
            if marker == 0xFF52:
                seen["csty"] |= body[0]
                seen["order"].add(body[1])
                seen["layers"].add(struct.unpack_from(">H", body, 2)[0])
                seen["mct"].add(body[4])
                seen["cblk"].add((body[6] + 2, body[7] + 2))
                seen["style"] |= body[8]
                seen["transform"].add(body[9])
            if marker == 0xFF5C:
                seen["qstyle"].add(body[0] & 0x1F)
            if marker == 0xFF5F:
                seen["order"] |= {body[6 + 7 * k] for k in range(len(body) // 7)}
    assert seen["order"] >= {0, 1, 2, 3, 4} and seen["style"] == 63 and seen["csty"] & 7 == 7
    assert seen["transform"] == {0, 1} and seen["mct"] == {0, 1} and seen["qstyle"] == {0, 1, 2}
    assert {0xFF5E, 0xFF5F, 0xFF60, 0xFF61, 0xFF58}.issubset(seen["markers"])
    assert {(2, 2), (6, 6), (5, 2), (2, 6)}.issubset(seen["cblk"])
    assert seen["subsampled"] and seen["signed"] and {8, 12, 16}.issubset(seen["precision"])
    assert max(seen["layers"]) >= 3 and seen["tiles"] and seen["offset"]
    assert {12, 16, 17, 18}.issubset(seen["enumcs"])
    assert seen["boxes"] == {b"pclr", b"cmap", b"cdef"}


# ---------------------------------------------------------------------------
# Refusals: what PIL reads and the port does not, and what both refuse
# ---------------------------------------------------------------------------


def _base():
    return mf.codestream_of(_read("rgb_53_rct.jp2"))


def _patched(stream, offset, value, fmt=">B"):
    out = bytearray(stream)
    struct.pack_into(fmt, out, offset, value)
    return bytes(out)


def _cod_offset(stream):
    return next(offset for marker, offset, _ in mf.markers(stream) if marker == 0xFF52)


def _refused():
    stream = _base()
    rsiz = struct.unpack_from(">H", stream, 6)[0]
    cod = _cod_offset(stream)
    cases = {
        "HTJ2K: Rsiz bit 14": (_patched(stream, 6, rsiz | 0x4000, ">H"), "HTJ2K"),
        "HTJ2K: CAP marker": (mf.with_main_marker(stream, 0xFF50, b"\x00\x02\x00\x00\x00\x00"),
                              "HTJ2K"),
        "HTJ2K: code-block style": (_patched(stream, cod + 12, stream[cod + 12] | 0x40),
                                    "HTJ2K"),
        "Part-2: Rsiz bit 15": (_patched(stream, 6, rsiz | 0x8000, ">H"), "Part-2"),
    }
    for marker, kind in ((0xFF74, "MCT"), (0xFF75, "MCC"), (0xFF77, "MCO"), (0xFF76, "NLT"),
                         (0xFF78, "CBD"), (0xFF73, "ADS")):
        cases[f"Part-2: {kind} marker"] = (mf.with_main_marker(stream, marker, b"\x00\x00"),
                                           f"Part-2 {kind}")
    return cases


REFUSED = _refused()


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_name_the_kind(case):
    blob, kind = REFUSED[case]
    with pytest.raises(NotImplementedError, match=kind):
        tools.read(io.BytesIO(blob))


def _pil_refuses():
    stream = _base()
    grey = mf.codestream_of(_read("l_53.jp2"))
    cod = _cod_offset(stream)
    five = mf.opj_encode([np.zeros((8, 8), np.int32)] * 5, rates=(0,), resolutions=2)
    rgb = mf.scene(16, 16, 1)
    la = mf.opj_encode([rgb[..., 0].astype(np.int32), rgb[::2, ::2, 1].astype(np.int32)],
                       sampling=[(1, 1), (2, 2)], rates=(0,), resolutions=2)
    sot = next(offset for marker, offset, _ in mf.markers(stream) if marker == 0xFF90)
    header = mf.jp2_file(stream, 16)
    jp2h = header.index(b"jp2h") - 4
    return {
        "five components": five,
        "sRGB colour of one component": mf.jp2_file(grey, 16),
        "grey colour of three components": mf.jp2_file(stream, 17),
        "e-sYCC colour": mf.jp2_file(stream, 24),
        "CMYK colour of three components": mf.jp2_file(stream, 12),
        "subsampled alpha": la,
        "no JP2 header box": header[:jp2h] + header[header.index(b"jp2c") - 4:],
        "image header size is not SIZ's": mf.jp2_file(stream, 16, ihdr=(43, 56, 3, 7)),
        "Psot below 14": _patched(stream, sot + 6, 13, ">I"),
        "tile index past the tiles": _patched(stream, sot + 4, 7, ">H"),
        "tile-part index out of order": _patched(stream, sot + 10, 1),
        "code-block size 2**11": _patched(stream, cod + 10, 9),
        "code-blocks past 4096 samples": _patched(stream, cod + 11, 5),
        "wavelet transformation 2": _patched(stream, cod + 13, 2),
        "no quality layers": _patched(stream, cod + 6, 0, ">H"),
        "progression order 5": _patched(stream, cod + 5, 5),
        "EPH announced but absent": _patched(stream, cod + 4, stream[cod + 4] | 4),
        "no COD marker": stream[:cod] + stream[cod + 4 + struct.unpack_from(">H", stream,
                                                                            cod + 2)[0]:],
        "decompression bomb": _patched(_patched(stream, 8, 30000, ">I"), 12, 30000, ">I"),
    }


PIL_REFUSES = _pil_refuses()


@pytest.mark.parametrize("case", sorted(PIL_REFUSES))
def test_pil_refusals_are_value_errors(case):
    blob = PIL_REFUSES[case]
    with pytest.raises(Exception):
        jtools.read(io.BytesIO(blob))
    with pytest.raises(ValueError):
        tools.read(io.BytesIO(blob))


# ---------------------------------------------------------------------------
# Broken streams: cut short, or one byte flipped
# ---------------------------------------------------------------------------

BROKEN_SOURCES = ["rgb_53_rct.jp2", "sop_eph.j2k", "psot_zero.j2k", "tiles_offsets.jp2",
                  "style_all.j2k", "ppt.j2k", "rgb_97_ict.jp2", "pclr.jp2"]


def _cuts():
    cases = []
    for name in BROKEN_SOURCES:
        size = len(_read(name))
        for fraction in (0.02, 0.3, 0.9):
            cases.append((name, int(size * fraction)))
        cases.append((name, size - 1))
    return cases


@pytest.mark.parametrize("name,cut", _cuts())
def test_truncated_streams_fail_as_pil(name, cut):
    """OpenJPEG's strict mode (PIL's) fails a stream cut anywhere, the end
    of codestream marker included."""
    blob = _read(name)[:cut]
    with pytest.raises(Exception):
        jtools.read(io.BytesIO(blob))
    with pytest.raises(ValueError):
        tools.read(io.BytesIO(blob))


def _flips():
    rng = np.random.default_rng(24)
    cases = []
    for name in BROKEN_SOURCES:
        blob = _read(name)
        data = blob.index(b"\xff\x93") + 2
        for _ in range(4):
            cases.append((name, int(rng.integers(data, len(blob) - 2)),
                          int(rng.integers(1, 256))))
        header = blob.index(b"\xff\x52")
        cases.append((name, int(rng.integers(header, data)), int(rng.integers(1, 256))))
    return cases


@pytest.mark.parametrize("name,offset,mask", _flips())
def test_flipped_bytes_end_as_pil(name, offset, mask):
    """A byte flipped in a header or in the coded data: the pixels PIL
    returns (OpenJPEG decodes the garbage), or ``ValueError`` where PIL
    fails."""
    blob = bytearray(_read(name))
    blob[offset] ^= mask
    blob = bytes(blob)
    try:
        want = jtools.read(io.BytesIO(blob))
    except Exception:
        with pytest.raises(ValueError):
            tools.read(io.BytesIO(blob))
        return
    np.testing.assert_array_equal(tools.read(io.BytesIO(blob)), want)


# ---------------------------------------------------------------------------
# Units: the MQ decoder, the 5/3 inverse, PIL's YCbCr tables
# ---------------------------------------------------------------------------

# ITU-T T.88 Annex H.2: the MQ coder's test sequence, 256 decisions in one
# context from state 0, and the codeword it gives (before JBIG2's 0xFFAC).
T88_INPUT = bytes.fromhex("00020051000000C00352872AAAAAAAAA82C02000FCD79EF6BF7FED904F46A3BF")
T88_CODE = bytes.fromhex("84C73BFCE1A1430402200000410DBB86F4317FFF88FF37471ADB6ADF")


def test_mq_decoder_on_the_t88_sequence():
    bits = [(byte >> (7 - k)) & 1 for byte in T88_INPUT for k in range(8)]
    assert mf.mq_encode(bits, [0] * len(bits)) == T88_CODE
    assert jpeg2000_t1.mq_decode(T88_CODE, [0] * len(bits)) == bits
    assert jpeg2000_t1.mq_decode(T88_CODE + b"\xff\xac", [0] * len(bits)) == bits


@pytest.mark.parametrize("seed", range(4))
def test_mq_decoder_round_trips_the_scripts_encoder(seed):
    """Random decisions in the 19 contexts of T.800 Annex D, from their
    initial states, skewed toward each context's own probability."""
    rng = np.random.default_rng(seed)
    count = int(rng.integers(500, 3000))
    contexts = [int(c) for c in rng.integers(0, 19, count)]
    skew = rng.random(19)
    decisions = [int(rng.random() < skew[c]) for c in contexts]
    initial = {0: 4, 17: 3, 18: 46}
    code = mf.mq_encode(decisions, contexts, initial)
    assert jpeg2000_t1.mq_decode(code, contexts, initial) == decisions


def _idwt53_reference(y, parity):
    """T.800 F.3.7 (1D_SR with the 5/3 lifting, F-5 / F-6), sample by
    sample on a symmetrically extended signal; one sample at an odd
    coordinate halved toward zero, as OpenJPEG does."""
    n = len(y)
    if n == 1:
        return [y[0] if parity == 0 else int(y[0] / 2)]

    def at(values, k):
        while not 0 <= k < n:
            k = -k if k < 0 else 2 * (n - 1) - k
        return values[k]

    x = list(y)
    for k in range(n):
        if (k + parity) % 2 == 0:
            x[k] = y[k] - (at(y, k - 1) + at(y, k + 1) + 2) // 4
    for k in range(n):
        if (k + parity) % 2 == 1:
            x[k] = y[k] + (at(x, k - 1) + at(x, k + 1)) // 2
    return x


@pytest.mark.parametrize("length", [1, 2, 3, 4, 7, 12])
def test_idwt53_matches_the_direct_reference(length):
    rng = np.random.default_rng(length)
    for parity in (0, 1):
        y = rng.integers(-300, 300, (5, length))
        got = jpeg2000_t1.idwt53_1d(y.astype(np.int64), parity)
        want = np.array([_idwt53_reference(list(row), parity) for row in y])
        np.testing.assert_array_equal(got, want)


def test_ycbcr_tables_are_pils():
    y, cb, cr = np.meshgrid([0, 77, 128, 200, 255], np.arange(256), np.arange(256),
                            indexing="ij")
    ycbcr = np.stack([y, cb, cr], axis=-1).astype(np.uint8).reshape(-1, 256, 3)
    want = np.asarray(Image.fromarray(ycbcr, "YCbCr").convert("RGB"))
    np.testing.assert_array_equal(jpeg2000.ycbcr_to_rgb(ycbcr), want)


def test_level_shift_rounds_as_lrintf():
    """9/7 samples are rounded half to even (``lrintf``), shifted by the DC
    offset and clamped (``opj_tcd_dc_level_shift_decode``); 5/3 ones only
    shifted and clamped."""
    plane = np.array([-128.5, -0.5, 0.5, 1.5, 2.5, 126.5, 127.49, 200.0], dtype=np.float32)
    np.testing.assert_array_equal(jpeg2000_t1.level_shift(plane, False, 8, False),
                                  [0, 128, 128, 130, 130, 254, 255, 255])
    np.testing.assert_array_equal(jpeg2000_t1.level_shift(plane, False, 8, True),
                                  [-128, 0, 0, 2, 2, 126, 127, 127])
    ints = np.array([-300, -1, 0, 5, 127, 128, 4000])
    np.testing.assert_array_equal(jpeg2000_t1.level_shift(ints, True, 12, False),
                                  [1748, 2047, 2048, 2053, 2175, 2176, 4095])
