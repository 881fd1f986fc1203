"""Port parity: ``tools.read`` of lossy AVIF files (``keras_ocr_tpu_torch/av1.py``,
``av1_transforms.py``, ``av1_filters.py``, ``av1_tables.py``).

JAX's ``tools.read`` is PIL's ``Image.open(f).convert("RGB")``: libavif over
dav1d, whose AV1 decoding is normative and bit-exact, then libyuv. The
port's decode must equal it bit for bit:

* every lossy fixture of ``tests/fixtures/avif`` (``lossy_*``, written by
  ``scripts/make_avif_fixtures.py`` with PIL's writer below
  ``quality=100``) and scene 3 at PIL's default quality, by path, as a file
  object and as bytes, against JAX's ``read`` and the sha256 of PIL's
  decode in ``hashes.json``;
* the fixtures reach every intra transform size and type aom writes, every
  coefficient q context, each deblocking filter length on luma and chroma,
  and CDEF with one and two strength sets;
* the inverse transforms against float64 DCT, ADST and identity matrices;
* what PIL reads and the port does not (loop restoration in use, quantiser
  matrices, delta q) raises ``NotImplementedError`` naming the kind; a
  lossy file cut short raises ``ValueError``, as PIL does;
* the tables this decoding added to ``av1_tables.py`` against those the
  table script finds in the installed libavif.
"""

import hashlib
import io
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from keras_ocr_tpu import tools as jtools
from keras_ocr_tpu_torch import av1, av1_tables, av1_transforms, avif, tools

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_av1_tables  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
AVIF = os.path.join(HERE, "fixtures", "avif")
with open(os.path.join(AVIF, "hashes.json"), encoding="utf8") as _f:
    HASHES = json.load(_f)
LOSSY = sorted(name for name, entry in HASHES.items()
               if entry.get("lossy") and not entry.get("refused") and not entry.get("chip"))
# Scene 3 at PIL's default quality at 4:2:0; the other golden scenes at 75
# and the 640x480 photo are read by chip_smoke.py.
DECODED = LOSSY + ["scene_03_q75.avif"]
REFUSED = sorted(name for name, entry in HASHES.items()
                 if entry.get("lossy") and entry.get("refused"))


def _read(name):
    with open(os.path.join(AVIF, name), "rb") as f:
        return f.read()


def _check(name, got):
    assert got.dtype == np.uint8 and list(got.shape) == HASHES[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == HASHES[name]["decoded_sha256"]


@pytest.mark.parametrize("name", DECODED)
def test_lossy_fixture_matches_pil(name):
    path = os.path.join(AVIF, name)
    got = tools.read(path)
    _check(name, got)
    np.testing.assert_array_equal(got, jtools.read(path))


@pytest.mark.parametrize("name", DECODED)
def test_lossy_file_object_and_bytes(name):
    blob = _read(name)
    _check(name, tools.read(io.BytesIO(blob)))
    _check(name, avif.decode_avif(blob))


TX_SIZES = [(w, h) for w in (4, 8, 16, 32, 64) for h in (4, 8, 16, 32, 64)
            if max(w, h) <= 4 * min(w, h)]
# DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, IDTX, V_DCT, H_DCT: the intra sets.
INTRA_TX_TYPES = (0, 1, 2, 3, 9, 10, 11)
# Never written by aom, with the reason.
NOT_REACHED = {
    # FLIPADST_DCT .. FLIPADST_ADST, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST
    # belong to the inter sets only (get_tx_set for an intra block gives
    # TX_SET_INTRA_1 or 2, or DCT only).
    **{f"tx_type {t}": "inter only" for t in (4, 5, 6, 7, 8, 12, 13, 14, 15)},
    # A frame with a lossless segment beside lossy ones: PIL's writer
    # turns on no segmentation for a still image (aom's deltaq-mode and
    # aq-mode leave it off).
    "lossless segment": "PIL's writer makes no segments",
    # aom codes no block of an intra frame as skip, so CDEF never meets an
    # all-skip 8x8 or a 64x64 without cdef_idx there:
    # test_cdef_matches_the_specification covers both.
    "cdef skipped 8x8": "aom skips no intra block",
}
TOOLS = ([f"tx {w}x{h}" for w, h in TX_SIZES] + [f"tx_type {t}" for t in INTRA_TX_TYPES]
         + [f"q_ctx {q}" for q in range(4)] + [f"tx_depth {d}" for d in range(3)]
         + ["deblock luma 4", "deblock luma 8", "deblock luma 14", "deblock chroma 4",
            "deblock chroma 6", "cdef strengths 1", "cdef strengths 2",
            "restoration enabled, used by no plane", "tiles 2x2", "superblock 128",
            "palette_y", "palette_uv", "uv_mode 13", "filter_intra 0", "golomb", "mono"])


def test_lossy_fixtures_reach_every_coding_tool():
    """The fixtures reach all 19 intra transform sizes (64-point ones
    included), every intra transform type, the four coefficient q
    contexts, tx_depth 0-2, the 4-, 8- and 14-tap luma and 4- and 6-tap
    chroma deblocking filters, CDEF with one and two strength sets, a
    sequence that enables loop restoration for a frame that uses none,
    tiles, 128x128 superblocks, palette, CFL, filter intra, Golomb-coded
    levels and 4:0:0. What aom
    never writes is in NOT_REACHED with the reason. Each fixture is lossy:
    its frame has a coefficient q context, which a coded-lossless frame
    does not."""
    seen = set()
    for name in DECODED:
        tools_of = set()
        av1.decode(avif._parse(_read(name))[0], tools_of)
        assert any(tool.startswith("q_ctx") for tool in tools_of), name
        seen |= tools_of
    missing = [tool for tool in TOOLS if tool not in seen]
    assert not missing, missing
    assert not [tool for tool in NOT_REACHED if tool in seen]
    # CDEF is on in the enable-cdef fixtures and off in PIL's default.
    for name, on in (("lossy_cdef_photo420_q50.avif", True), ("lossy_photo48_q50.avif", False)):
        seen = set()
        av1.decode(avif._parse(_read(name))[0], seen)
        assert any(tool.startswith("cdef") for tool in seen) == on, name


# ---------------------------------------------------------------------------
# The inverse transforms against float64 ones
# ---------------------------------------------------------------------------

def _float_matrix(kind, n):
    """The float64 inverse transform of 2^n points with the gains of the
    integer ones: out = M @ in."""
    size = 1 << n
    j = np.arange(size)[:, None]
    k = np.arange(size)[None, :]
    if kind == av1_transforms.DCT:
        m = np.cos(np.pi * (2 * j + 1) * k / (2 * size))
        m[:, 0] = np.cos(np.pi / 4)
        return m
    if kind == av1_transforms.ADST:
        if n == 2:
            return 2 * np.sqrt(2) / 3 * np.sin(np.pi * (j + 1) * (2 * k + 1) / 9)
        return np.sin(np.pi * (2 * j + 1) * (2 * k + 1) / (4 * size))
    return np.eye(size) * {2: np.sqrt(2), 3: 2.0, 4: 2 * np.sqrt(2)}[n]


# The largest difference allowed from the float64 transform on inputs in
# [-2000, 2000]: about half a unit for each rounded butterfly stage a value
# passes, grown by the stages after it.
TOLERANCE_1D = {2: 2, 3: 3, 4: 6, 5: 9, 6: 14}
TRANSFORMS_1D = ([(av1_transforms.DCT, n) for n in range(2, 7)]
                 + [(av1_transforms.ADST, n) for n in range(2, 5)]
                 + [(av1_transforms.IDENTITY, n) for n in range(2, 5)])


@pytest.mark.parametrize("kind, n", TRANSFORMS_1D)
def test_inverse_1d_matches_float(kind, n):
    rng = np.random.default_rng(n + 10 * kind)
    size = 1 << n
    x = rng.integers(-2000, 2001, (size, 64))
    x[:, :size] = np.eye(size, dtype=np.int64) * 2000  # each basis vector alone
    got = av1_transforms.inverse_1d(x.astype(np.int64), n, kind)
    want = _float_matrix(kind, n) @ x
    assert np.abs(got - want).max() <= TOLERANCE_1D[n]


def _float_2d(coef, w, h, tx_type):
    col_kind, row_kind = av1_transforms.TX_TYPE_KINDS[tx_type]
    full = np.zeros((h, w))
    full[:coef.shape[0], :coef.shape[1]] = coef
    if abs(np.log2(w) - np.log2(h)) == 1:
        full = full / np.sqrt(2)
    rows = full @ _float_matrix(row_kind, int(np.log2(w))).T
    rows = rows / 2 ** av1_transforms.TX_ROW_SHIFT[(w, h)]
    return _float_matrix(col_kind, int(np.log2(h))) @ rows / 16


@pytest.mark.parametrize("w, h", TX_SIZES)
def test_inverse_2d_matches_float(w, h):
    """Every transform size with each intra transform type it may take
    (DCT only at 32 and 64 points; the 1-D classes up to 16), within 2 of
    the float64 transform on coefficients in [-300, 300]."""
    rng = np.random.default_rng(w * 100 + h)
    types = [0] if max(w, h) >= 32 else [0, 1, 2, 3, 9] + ([10, 11] if min(w, h) < 16 else [])
    for tx_type in types:
        coef = rng.integers(-300, 301, (min(h, 32), min(w, 32))).astype(np.int64)
        got = av1_transforms.inverse_transform_2d(coef, w, h, tx_type)
        want = _float_2d(coef, w, h, tx_type)
        assert got.shape == (h, w)
        assert np.abs(got - want).max() <= 2, (tx_type, np.abs(got - want).max())


def test_adst4_is_the_specifications_steps():
    """The 4-point ADST against section 7.13.2.5 step by step, exactly,
    rounding ties included (the float64 check above cannot see them)."""
    rng = np.random.default_rng(4)
    x = rng.integers(-40000, 40001, (4, 200000)).astype(np.int64)
    s1, s2, s3, s4 = av1_tables.SINPI[1:]
    t0, t1, t2, t3 = x
    s0_, s1_ = s1 * t0, s2 * t0
    s2_, s3_ = s3 * t1, s4 * t2
    s4_, s5_, s6_ = s1 * t2, s2 * t3, s4 * t3
    b7 = t0 - t2 + t3
    s0_, s1_ = s0_ + s3_, s1_ - s4_
    s3_, s2_ = s2_, s3 * b7
    s0_, s1_ = s0_ + s5_, s1_ - s6_
    want = np.array([s0_ + s3_, s1_ + s3_, s2_, s0_ + s1_ - s3_])
    want = (want + 2048) >> 12
    np.testing.assert_array_equal(av1_transforms.inverse_1d(x, 2, av1_transforms.ADST), want)


def test_dequantise_masks_divides_and_clamps():
    quant = np.array([[3, -5], [4000, -4000]], np.int64)
    # 32x32: the product's magnitude over 2; 4000 * 1000 masked to 24 bits
    # is 4000000, clamped to 16 bits.
    got = av1_transforms.dequantise(quant, 100, 1000, 32, 32)
    assert got.tolist() == [[150, -2500], [32767, -32768]]
    # 8389 * 2000 = 2^24 + 784: the mask leaves 784, a 64x64 divides by 4.
    got = av1_transforms.dequantise(np.array([[-8389]], np.int64), 2000, 1, 64, 64)
    assert got[0, 0] == -196
    # 524313 * 16 = 2^23 + 400: bit 23 stays, so the clamp applies.
    assert av1_transforms.dequantise(np.array([[524313]], np.int64), 16, 1, 4, 4)[0, 0] == 32767


def _spec_uv_tx(bsize, subx, suby):
    """get_tx_size for chroma as section 5.11.37 writes it: the largest
    rectangular transform of the chroma block, a 64 side taken to 32 with
    16x64 and 64x16 becoming 16x32 and 32x16."""
    w, h = av1.BLOCK_DIMS[bsize]
    uw, uh = max(4, w >> subx), max(4, h >> suby)
    tw, th = min(uw, 64), min(uh, 64)
    if tw == 64 or th == 64:
        if tw == 16:
            return (16, 32)
        if th == 16:
            return (32, 16)
        return (32, 32)
    return (tw, th)


@pytest.mark.parametrize("subx, suby", [(1, 1), (1, 0), (0, 0)])
def test_chroma_transform_size_is_get_tx_size(subx, suby):
    for bsize, (w, h) in enumerate(av1.BLOCK_DIMS):
        if av1._residual_size(bsize, subx, suby) is None:
            continue
        assert av1._uv_tx(bsize, subx, suby) == _spec_uv_tx(bsize, subx, suby), (w, h)


# ---------------------------------------------------------------------------
# CDEF against a transcription of the specification
# ---------------------------------------------------------------------------

def _cdef_spec(frame, planes):
    """Section 7.15 as the specification writes it, pixel by pixel."""
    subx, suby = frame.seq.subx, frame.seq.suby
    out = [p.copy() for p in planes]
    dirs, div = av1_tables.CDEF_DIRECTIONS, av1_tables.CDEF_DIV_TABLE

    def constrain(diff, threshold, damping):
        if not threshold:
            return 0
        adjust = max(0, damping - (threshold.bit_length() - 1))
        value = min(abs(diff), max(0, threshold - (abs(diff) >> adjust)))
        return value if diff >= 0 else -value

    def direction(r, c):
        cost = [0] * 8
        partial = [[0] * 15 for _ in range(8)]
        for i in range(8):
            for j in range(8):
                x = int(planes[0][r * 4 + i, c * 4 + j]) - 128
                for d, k in enumerate((i + j, i + j // 2, i, 3 + i - j // 2, 7 + i - j,
                                       3 - i // 2 + j, j, i // 2 + j)):
                    partial[d][k] += x
        for i in range(8):
            cost[2] += partial[2][i] ** 2
            cost[6] += partial[6][i] ** 2
        cost[2] *= div[8]
        cost[6] *= div[8]
        for i in range(7):
            cost[0] += (partial[0][i] ** 2 + partial[0][14 - i] ** 2) * div[i + 1]
            cost[4] += (partial[4][i] ** 2 + partial[4][14 - i] ** 2) * div[i + 1]
        cost[0] += partial[0][7] ** 2 * div[8]
        cost[4] += partial[4][7] ** 2 * div[8]
        for i in (1, 3, 5, 7):
            for j in range(5):
                cost[i] += partial[i][3 + j] ** 2
            cost[i] *= div[8]
            for j in range(3):
                cost[i] += (partial[i][j] ** 2 + partial[i][10 - j] ** 2) * div[2 * j + 2]
        best, best_dir = 0, 0
        for d in range(8):
            if cost[d] > best:
                best, best_dir = cost[d], d
        return best_dir, (best - cost[(best_dir + 4) & 7]) >> 10

    def filter_block(plane, r, c, pri, sec, damping, d):
        sx, sy = (subx, suby) if plane else (0, 0)
        x0, y0 = (c * 4) >> sx, (r * 4) >> sy
        src = planes[plane]
        for i in range(8 >> sy):
            for j in range(8 >> sx):
                x = int(src[y0 + i, x0 + j])
                total, high, low = 0, x, x
                for k in range(2):
                    for sign in (-1, 1):
                        for off, strength in ((0, pri), (-2, sec), (2, sec)):
                            dd = (d + off) & 7
                            y = y0 + i + sign * dirs[dd][k][0]
                            xx = x0 + j + sign * dirs[dd][k][1]
                            if not (0 <= (y << sy) >> 2 < frame.mi_rows
                                    and 0 <= (xx << sx) >> 2 < frame.mi_cols):
                                continue
                            p = int(src[y, xx])
                            tap = (av1_tables.CDEF_PRI_TAPS[pri & 1][k] if off == 0
                                   else av1_tables.CDEF_SEC_TAPS[k])
                            total += tap * constrain(p - x, strength, damping)
                            high, low = max(high, p), min(low, p)
                out[plane][y0 + i, x0 + j] = min(high, max(low, x + ((8 + total - (total < 0))
                                                                     >> 4)))

    for r in range(0, frame.mi_rows, 2):
        for c in range(0, frame.mi_cols, 2):
            idx = frame.cdef_idx[r >> 4][c >> 4]
            sk = frame.skips
            if idx == -1 or (sk[r][c] and sk[r + 1][c] and sk[r][c + 1] and sk[r + 1][c + 1]):
                continue
            y_pri, y_sec, uv_pri, uv_sec = frame.cdef_strengths[idx]
            y_dir, var = direction(r, c)
            var_str = min((var >> 6).bit_length() - 1, 12) if var >> 6 else 0
            pri = (y_pri * (4 + var_str) + 8) >> 4 if var else 0
            filter_block(0, r, c, pri, y_sec, frame.cdef_damping, y_dir if y_pri else 0)
            uv_dir = av1_tables.CDEF_UV_DIR[subx][suby][y_dir] if uv_pri else 0
            for plane in (1, 2):
                filter_block(plane, r, c, uv_pri, uv_sec, frame.cdef_damping - 1, uv_dir)
    return out


@pytest.mark.parametrize("subx, suby", [(1, 1), (0, 0), (1, 0)])
def test_cdef_matches_the_specification(subx, suby):
    """av1_filters.cdef against the transcription above on a random frame
    of 40x48 4x4s (a partial 64x64 at the right and bottom) with skipped
    4x4s, a 64x64 without cdef_idx, four strength sets and smooth content
    beside noise."""
    from keras_ocr_tpu_torch import av1_filters

    rng = np.random.default_rng(subx * 2 + suby)
    frame = type("Frame", (), {})()
    frame.seq = type("Seq", (), {"subx": subx, "suby": suby, "num_planes": 3})()
    frame.mi_rows, frame.mi_cols = 40, 48
    frame.skips = (rng.random((40, 48)) < 0.3).astype(int).tolist()
    frame.cdef_idx = [[int(v) for v in row] for row in rng.integers(0, 4, (4, 4))]
    frame.cdef_idx[0][1] = -1
    frame.cdef_strengths = [(0, 0, 0, 0), (9, 2, 3, 1), (15, 4, 0, 2), (2, 0, 7, 4)]
    frame.cdef_damping = 5
    frame.seen = set()
    smooth = np.add.outer(np.arange(160), np.arange(192)) // 3
    planes = [np.clip(smooth + rng.integers(-12, 13, (160, 192)), 0, 255).astype(np.int32)]
    for _ in range(2):
        planes.append(rng.integers(0, 256, (160 >> suby, 192 >> subx)).astype(np.int32))
    got = av1_filters.cdef(frame, planes)
    want = _cdef_spec(frame, planes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert "cdef skipped 8x8" in frame.seen


# ---------------------------------------------------------------------------
# Refusals, and files cut short
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", REFUSED)
def test_refused_lossy_fixtures_name_the_kind(name):
    blob = _read(name)
    assert list(jtools.read(io.BytesIO(blob)).shape) == HASHES[name]["shape"]  # PIL reads it
    with pytest.raises(NotImplementedError, match=HASHES[name]["refused"]):
        avif.decode_avif(blob)


def _pil_fails(blob):
    try:
        np.array(Image.open(io.BytesIO(blob)).convert("RGB"))
    except Exception:
        return True
    return False


@pytest.mark.parametrize("cut", [0.5, 0.8, -3])
@pytest.mark.parametrize("name", ["lossy_photo48_q75.avif", "lossy_cdef_text444_q20.avif"])
def test_truncated_lossy_files_end_as_pils(name, cut):
    blob = _read(name)
    short = blob[:int(len(blob) * cut) if isinstance(cut, float) else len(blob) + cut]
    assert _pil_fails(short)
    with pytest.raises(ValueError):
        tools.read(io.BytesIO(short))


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

NEW_TABLES = ["DC_QLOOKUP", "AC_QLOOKUP", "COS128", "SINPI", "SCANS", "CDEF_DIRECTIONS",
              "CDEF_PRI_TAPS", "CDEF_DIV_TABLE", "CDEF_UV_DIR"]
NEW_CDFS = ["TX_DEPTH_CDF", "INTRA_TX_TYPE_SET1_CDF", "INTRA_TX_TYPE_SET2_CDF", "TXB_SKIP_CDF",
            "EOB_EXTRA_CDF", "DC_SIGN_CDF", "EOB_PT_16_CDF", "EOB_PT_32_CDF", "EOB_PT_64_CDF",
            "EOB_PT_128_CDF", "EOB_PT_256_CDF", "EOB_PT_512_CDF", "EOB_PT_1024_CDF",
            "COEFF_BASE_EOB_CDF", "COEFF_BASE_CDF", "COEFF_BR_CDF"]


@pytest.fixture(scope="module")
def library():
    try:
        path = make_av1_tables.library_path()
    except FileNotFoundError:
        pytest.skip("Pillow's bundled libavif is not installed")
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", NEW_TABLES)
def test_constant_tables_equal_the_installed_library(library, name):
    assert getattr(av1_tables, name) == make_av1_tables.constant_tables(library)[name]


@pytest.mark.parametrize("name", NEW_CDFS)
def test_coefficient_and_transform_cdfs_equal_the_installed_library(library, name):
    """Every q context and transform size context, as the library holds
    them."""
    entry = next(e for e in make_av1_tables.CDF_TABLES if e[0] == name)
    _, dims, symbols, stride, anchor, keep = entry
    rows = make_av1_tables.find_cdf(library, name, dims, symbols, stride, anchor)
    assert getattr(av1_tables, name) == make_av1_tables._nest(rows, dims, keep)
    assert np.array(getattr(av1_tables, name), dtype=object).shape[:len(dims)] == dims


def test_scans_follow_the_specification():
    """The default scans of the spec's tables: 4x4 and 8x8 zig-zags going
    down first, 4x8 along diagonals down and to the left, 8x4 up and to
    the right; the 1-D classes' scans by rows and by columns."""
    scans = av1_tables.SCANS
    assert scans["4x4 default"][:6] == [0, 1, 4, 8, 5, 2]
    assert scans["8x8 default"][:6] == [0, 1, 8, 16, 9, 2]
    assert scans["4x8 default"][:6] == [0, 1, 4, 2, 5, 8]
    assert scans["8x4 default"][:6] == [0, 8, 1, 16, 9, 2]
    assert scans["8x16 row"] == list(range(128))
    assert scans["4x16 col"][:5] == [0, 4, 8, 12, 16]
    for key, scan in scans.items():
        w, h = map(int, key.split()[0].split("x"))
        assert sorted(scan) == list(range(w * h)), key
