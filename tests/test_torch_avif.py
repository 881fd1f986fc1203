"""Port parity: ``tools.read`` of AVIF files (``keras_ocr_tpu_torch/avif.py``,
``av1.py``, ``av1_tables.py``).

JAX's ``tools.read`` is PIL's ``Image.open(f).convert("RGB")``, which
decodes AVIF with libavif over dav1d and converts with libyuv; the port's
decode must equal it bit for bit:

* every lossless fixture of ``tests/fixtures/avif`` (written by
  ``scripts/make_avif_fixtures.py`` with PIL's lossless writer and the
  script's container rewrites), and golden scene 3 in 2x2 tiles, by path,
  as a file object and as bytes, against JAX's ``read`` and the sha256 of
  PIL's decode in ``hashes.json`` (the lossy fixtures are
  ``tests/test_torch_avif_lossy.py``'s);
* what PIL reads and the port does not (film grain, grids, and streams
  made here with a bit depth above 8, superres, intra block copy, delta q
  or an inter frame) raises ``NotImplementedError`` naming the kind; what
  PIL refuses, files cut short among them, raises ``ValueError``;
* the symbol decoder against an AV1 symbol encoder written here, with CDF
  adaptation;
* ``av1_tables.py`` against the tables of the installed libavif, and each
  CDF row against the shape AV1 gives it.
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
from keras_ocr_tpu_torch import av1, av1_tables, avif, tools

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_av1_tables  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
AVIF = os.path.join(HERE, "fixtures", "avif")
with open(os.path.join(AVIF, "hashes.json"), encoding="utf8") as _f:
    HASHES = json.load(_f)
GOLDEN = {f"scene_{k:02d}.avif" for k in range(12)} | {"scene_03_444.avif"}
LOSSY = {name for name, entry in HASHES.items() if entry.get("lossy")}
REFUSED = sorted(name for name, entry in HASHES.items()
                 if entry.get("refused") and name not in LOSSY)
SMALL = sorted(set(HASHES) - GOLDEN - set(REFUSED) - LOSSY)


def _read(name):
    with open(os.path.join(AVIF, name), "rb") as f:
        return f.read()


def _check(name, got):
    assert got.dtype == np.uint8 and list(got.shape) == HASHES[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == HASHES[name]["decoded_sha256"]


@pytest.mark.parametrize("name", SMALL + ["scene_03.avif"])
def test_fixture_matches_pil(name):
    path = os.path.join(AVIF, name)
    got = tools.read(path)
    _check(name, got)
    np.testing.assert_array_equal(got, jtools.read(path))


@pytest.mark.parametrize("name", ["sub420_full.avif", "screen_palette444.avif",
                                  "sequence_avis.avif", "container_iloc1_idat.avif"])
def test_file_object_and_bytes(name):
    blob = _read(name)
    _check(name, tools.read(io.BytesIO(blob)))
    _check(name, avif.decode_avif(blob))


@pytest.mark.parametrize("name", REFUSED)
def test_refused_fixtures_name_the_kind(name):
    path = os.path.join(AVIF, name)
    assert list(jtools.read(path).shape) == HASHES[name]["shape"]  # PIL reads it
    with pytest.raises(NotImplementedError, match=HASHES[name]["refused"]):
        tools.read(path)


TOOLS = ["palette_y", "palette_uv", "palette_cache", "palette_v_delta", "uv_mode 13", "upsample",
         "angle_delta", "edge_filter 1", "edge_filter 2", "golomb", "superblock 128", "mono",
         "block 64x64"] + [f"partition {p}" for p in range(10)] + \
    [f"filter_intra {m}" for m in range(5)] + [f"y_mode {m}" for m in range(13)] + \
    [f"uv_mode {m}" for m in range(13)]


def test_fixtures_reach_every_intra_tool():
    """The fixtures exercise palette (cache, both planes, V's deltas), CFL,
    every y and uv mode, angle deltas with the edge filter and upsampling,
    every filter intra mode, every partition, 64x64 blocks, Golomb-coded
    levels, 128x128 superblocks and 4:0:0."""
    seen = set()
    for name in ("screen_palette444.avif", "screen_palette420.avif", "sb128.avif",
                 "screen_speed3_partitions.avif", "ramp_block64.avif",
                 "screen_palette_speed0.avif", "speed4_photo420.avif",
                 "sub400_full.avif", "speed0_text444.avif", "speed0_photo420.avif",
                 "speed4_text444.avif", "sub444_full.avif", "sub422_full.avif",
                 "speed10_text444.avif", "speed8_photo420.avif", "speed6_text444.avif"):
        av1.decode(avif._parse(_read(name))[0], seen)
    missing = [tool for tool in TOOLS if tool not in seen]
    assert not missing, missing


def test_golden_scene_has_tiles():
    seen = set()
    av1.decode(avif._parse(_read("scene_03.avif"))[0], seen)
    assert "tiles 2x2" in seen


@pytest.mark.parametrize("r, c, neighbour", [
    (2, 2, (1, 3)),  # an even MiCol reads the above block that holds chroma, one to the right
    (3, 3, (1, 3)),  # an odd MiRow reads two rows up, where the chroma above was coded
    (2, 3, (3, 1)),  # an odd MiCol reads two columns left, an even MiRow one row down
])
def test_chroma_filter_type_reads_the_blocks_that_hold_chroma(r, c, neighbour):
    """get_filter_type for a 4:2:0 chroma block: the above and left modes
    come from the 4x4 positions whose blocks coded the chroma next to it."""
    tile = av1._TileDecoder.__new__(av1._TileDecoder)
    tile.subx = tile.suby = 1
    tile.f = type("Frame", (), {})()
    tile.f.y_modes = [[av1.DC_PRED] * 6 for _ in range(6)]
    tile.f.uv_modes = [[av1.DC_PRED] * 6 for _ in range(6)]
    tile.f.uv_modes[neighbour[0]][neighbour[1]] = av1.SMOOTH_V_PRED
    block = av1._Block(r, c, av1.BLOCK_4X4, True, True, True, True, True)
    assert tile._filter_type(block, 1) == 1
    tile.f.uv_modes[neighbour[0]][neighbour[1]] = av1.DC_PRED
    assert tile._filter_type(block, 1) == 0


# ---------------------------------------------------------------------------
# What PIL refuses, and files cut short
# ---------------------------------------------------------------------------

def _pil_fails(blob):
    try:
        np.array(Image.open(io.BytesIO(blob)).convert("RGB"))
    except Exception:
        return True
    return False


@pytest.mark.parametrize("cut", [13, 40, 200, 0.5, 0.9, -1])
@pytest.mark.parametrize("name", ["sub420_full.avif", "sequence_avis.avif"])
def test_truncated_files_end_as_pils(name, cut):
    blob = _read(name)
    size = cut if isinstance(cut, int) and cut > 0 else (
        int(len(blob) * cut) if isinstance(cut, float) else len(blob) + cut)
    short = blob[:size]
    assert _pil_fails(short)
    with pytest.raises(ValueError):
        tools.read(io.BytesIO(short))


def _replace_box_type(blob, old, new):
    at = blob.index(old)
    return blob[:at] + new + blob[at + 4:]


@pytest.mark.parametrize("case", ["no_avif_brand", "no_pict_handler", "no_primary_item",
                                  "iloc_past_end", "primary_not_av01"])
def test_broken_containers_raise_value_error(case):
    blob = _read("sub420_full.avif")
    if case == "no_avif_brand":
        blob = blob[:8] + b"mif1" + blob[12:].replace(b"avif", b"miaf", 1)
    elif case == "no_pict_handler":
        blob = blob.replace(b"pict", b"vide", 1)
    elif case == "no_primary_item":
        blob = _replace_box_type(blob, b"pitm", b"free")
    elif case == "iloc_past_end":
        at = blob.index(b"iloc") + 4 + 4 + 2 + 2 + 2 + 2 + 2
        blob = blob[:at] + (len(blob)).to_bytes(4, "big") + blob[at + 4:]
    else:
        at = blob.index(b"av01")
        blob = blob[:at] + b"hvc1" + blob[at + 4:]
    assert _pil_fails(blob)
    with pytest.raises(ValueError):
        avif.decode_avif(blob)


# ---------------------------------------------------------------------------
# Streams made here: refusals the writer cannot reach
# ---------------------------------------------------------------------------

class BitWriter:
    def __init__(self):
        self.bits = []

    def f(self, n, value):
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def bytes(self):
        bits = self.bits + [1] + [0] * ((-len(self.bits) - 1) % 8)  # trailing bits
        return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


def _obu(kind, payload):
    return bytes([(kind << 3) | 2, len(payload)]) + payload


def _sequence_header(reduced=True, high_bitdepth=0, superres=0):
    w = BitWriter().f(3, 0).f(1, 1).f(1, reduced)
    if reduced:
        w.f(5, 0)
    else:
        w.f(1, 0).f(1, 0).f(5, 0).f(12, 0).f(5, 0)
    w.f(4, 5).f(4, 5).f(6, 15).f(6, 15)
    if not reduced:
        w.f(1, 0)  # frame_id_numbers_present_flag
    w.f(1, 0).f(1, 1).f(1, 1)
    if not reduced:
        w.f(4, 0).f(1, 0).f(1, 1).f(1, 1)  # compound tools, no order hint, choose sct / mv
    w.f(1, superres).f(1, 0).f(1, 0)
    w.f(1, high_bitdepth).f(1, 0).f(1, 0).f(1, 1).f(2, 0).f(1, 0)  # colour config, 4:2:0
    w.f(1, 0)  # film_grain_params_present
    return _obu(av1.OBU_SEQUENCE_HEADER, w.bytes())


def _frame_header(screen=0, intrabc=0, superres=0, q=0, delta_q_present=0):
    """A reduced still picture's frame header, up to what is asked; a
    superres frame needs a sequence header that enables superres; a lossy
    one (``q`` > 0) ends at delta_q_present."""
    w = BitWriter().f(1, 0).f(1, screen)
    if screen:
        w.f(1, 0)  # force_integer_mv
    if superres:
        return _obu(av1.OBU_FRAME_HEADER, w.f(1, 1).bytes())
    w.f(1, 0)  # render_and_frame_size_different
    if screen:
        w.f(1, intrabc)
    # Uniform tiles, base_q_idx, three delta_coded, using_qmatrix,
    # segmentation_enabled, then delta_q_present for a lossy frame, or
    # reduced_tx_set for a lossless one.
    w.f(1, 1).f(8, q).f(1, 0).f(1, 0).f(1, 0).f(1, 0).f(1, 0)
    w.f(1, delta_q_present if q else 0)
    return _obu(av1.OBU_FRAME_HEADER, w.bytes())


@pytest.mark.parametrize("stream, kind", [
    (lambda: _sequence_header(high_bitdepth=1), "bit depth 10"),
    (lambda: _sequence_header(superres=1) + _frame_header(superres=1), "superres"),
    (lambda: _sequence_header() + _frame_header(screen=1, intrabc=1), "allow_intrabc"),
    (lambda: _sequence_header() + _frame_header(q=40, delta_q_present=1), "delta_q_present"),
    (lambda: _sequence_header(reduced=False) + _obu(av1.OBU_FRAME_HEADER,
                                                     BitWriter().f(1, 0).f(2, 1).bytes()),
     "inter frames"),
    (lambda: _sequence_header(reduced=False) + _obu(av1.OBU_FRAME_HEADER,
                                                     BitWriter().f(1, 1).f(3, 0).bytes()),
     "show_existing_frame"),
])
def test_av1_refusals_name_the_kind(stream, kind):
    with pytest.raises(NotImplementedError, match=kind):
        av1.decode(stream())


def test_av1_stream_without_tiles_raises_value_error():
    with pytest.raises(ValueError):
        av1.decode(_sequence_header() + _frame_header())
    with pytest.raises(ValueError):
        av1.decode(_frame_header())


# ---------------------------------------------------------------------------
# The symbol decoder against an encoder
# ---------------------------------------------------------------------------

class SymbolEncoder:
    """An AV1 symbol encoder for the decoder of section 8.2: the interval
    [low, low + rng) of the decoder's SymbolValue, kept whole in a Python
    int; renormalised as the decoder is; flushed to the largest value of
    the last interval, as inverted bits."""

    def __init__(self):
        self.low, self.rng, self.bits = 0, 1 << 15, 15

    def _code(self, cdf, symbol, adapt):
        n = len(cdf) - 1
        r8 = self.rng >> 8

        def cur(k):
            return self.rng if k < 0 else ((r8 * ((32768 - cdf[k]) >> 6)) >> 1) + 4 * (n - k - 1)

        low, high = cur(symbol), cur(symbol - 1)
        self.low += low
        rng = high - low
        shift = 16 - rng.bit_length()
        self.rng = rng << shift
        self.low <<= shift
        self.bits += shift
        if adapt:
            count = cdf[n]
            rate = 3 + (count > 15) + (count > 31) + (2 if n > 3 else 1)
            for i in range(n - 1):
                cdf[i] += -(cdf[i] >> rate) if i < symbol else (32768 - cdf[i]) >> rate
            cdf[n] = min(count + 1, 32)

    def symbol(self, cdf, symbol):
        self._code(cdf, symbol, True)

    def literal(self, n, value):
        for i in range(n - 1, -1, -1):
            self._code([16384, 32768, 0], (value >> i) & 1, False)

    def finish(self) -> bytes:
        total = (self.bits + 7) // 8 * 8 + 8
        pad = total - self.bits
        value = ((self.low + self.rng - 1) << pad) | ((1 << pad) - 1)
        return (value ^ ((1 << total) - 1)).to_bytes(total // 8, "big")


@pytest.mark.parametrize("seed", range(4))
def test_symbol_decoder_round_trip(seed):
    rng = np.random.default_rng(seed)
    tables = [av1._cdfs(av1_tables.KF_Y_MODE_CDF[0][0]), av1._cdfs(av1_tables.SKIP_CDF[1]),
              av1._cdfs(av1_tables.COEFF_BASE_CDF[0][0][0][5]),
              av1._cdfs(av1_tables.CFL_ALPHA_CDF[2]),
              av1._cdfs(av1_tables.PALETTE_Y_COLOR_CDF[6][1])]
    script = []
    for _ in range(600):
        if rng.random() < 0.2:
            bits = int(rng.integers(1, 9))
            script.append(("literal", bits, int(rng.integers(0, 1 << bits))))
        else:
            table = int(rng.integers(len(tables)))
            # Skewed choices, so the adaptation moves the CDFs.
            symbol = min(int(rng.geometric(0.5)) - 1, len(tables[table]) - 2)
            script.append(("symbol", table, symbol))
    encoder = SymbolEncoder()
    enc_tables = [list(t) for t in tables]
    for kind, a, b in script:
        if kind == "literal":
            encoder.literal(a, b)
        else:
            encoder.symbol(enc_tables[a], b)
    data = encoder.finish()
    decoder = av1.SymbolDecoder(data, 0, len(data), update=True)
    dec_tables = [list(t) for t in tables]
    for kind, a, b in script:
        got = decoder.literal(a) if kind == "literal" else decoder.symbol(dec_tables[a])
        assert got == b
    assert dec_tables == enc_tables


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

SYMBOLS = {"KF_Y_MODE_CDF": 13, "ANGLE_DELTA_CDF": 7, "CFL_ALPHA_CDF": 16, "CFL_SIGN_CDF": 8,
           "FILTER_INTRA_CDF": 2, "FILTER_INTRA_MODE_CDF": 5, "SKIP_CDF": 2, "INTRABC_CDF": 2,
           "SEGMENT_ID_CDF": 8, "DELTA_CDF": 4, "PALETTE_Y_MODE_CDF": 2,
           "PALETTE_UV_MODE_CDF": 2, "PALETTE_Y_SIZE_CDF": 7, "PALETTE_UV_SIZE_CDF": 7,
           "TXB_SKIP_CDF": 2, "EOB_EXTRA_CDF": 2, "DC_SIGN_CDF": 2, "EOB_PT_16_CDF": 5,
           "EOB_PT_32_CDF": 6, "EOB_PT_64_CDF": 7, "EOB_PT_128_CDF": 8, "EOB_PT_256_CDF": 9,
           "EOB_PT_512_CDF": 10, "EOB_PT_1024_CDF": 11, "INTRA_TX_TYPE_SET1_CDF": 7,
           "INTRA_TX_TYPE_SET2_CDF": 5, "COEFF_BASE_EOB_CDF": 3, "COEFF_BASE_CDF": 4,
           "COEFF_BR_CDF": 4}


def _rows(table, path=()):
    if isinstance(table[0], int):
        yield path, table
    else:
        for i, row in enumerate(table):
            yield from _rows(row, path + (i,))


@pytest.mark.parametrize("name", [entry[0] for entry in make_av1_tables.CDF_TABLES])
def test_cdf_rows_have_av1_shape(name):
    for path, row in _rows(getattr(av1_tables, name)):
        if name == "UV_MODE_CDF":
            count = 13 + path[0]
        elif name == "PARTITION_CDF":
            count = 4 if path[0] < 4 else 8 if path[0] >= 16 else 10
        elif name.startswith("PALETTE_") and name.endswith("_COLOR_CDF"):
            count = 2 + path[0]
        elif name == "TX_DEPTH_CDF":
            count = 2 if path[0] == 0 else 3
        else:
            count = SYMBOLS[name]
        assert len(row) == count and row[-1] == 32768
        assert all(0 < a < b for a, b in zip(row, row[1:]))


def test_tables_equal_the_installed_library():
    try:
        path = make_av1_tables.library_path()
    except FileNotFoundError:
        pytest.skip("Pillow's bundled libavif is not installed")
    with open(path, "rb") as f:
        text = make_av1_tables.render(f.read())
    with open(av1_tables.__file__, encoding="utf8") as f:
        assert f.read() == text


def test_avif_is_first_and_takes_only_its_brands():
    assert tools._FORMATS[0][0] == "AVIF"
    from PIL import AvifImagePlugin

    for prefix in (b"\0\0\0\x1cftypavif", b"\0\0\0\x1cftypavis", b"\0\0\0\x1cftypmif1",
                   b"\0\0\0\x1cftypmsf1", b"\0\0\0\x1cftypheic", b"\0\0\0\x1cftypisom",
                   b"\x89PNG\r\n\x1a\n\0\0\0\0", b"RIFF\0\0\0\0WEBP"):
        assert avif.is_avif(prefix) == bool(AvifImagePlugin._accept(prefix))


def test_modules_import_only_numpy_and_the_standard_library():
    """``avif``, ``av1``, ``av1_tables``, ``av1_transforms`` and
    ``av1_filters`` import numpy, the standard library and each other,
    nothing else (no torch, PIL, ctypes or JAX); ``tools.read`` decodes
    lossless and lossy AVIF with PIL and JAX unimportable, as on the card's
    machine."""
    import ast
    import subprocess

    root = os.path.dirname(HERE)
    modules = sorted(name[:-3] for name in os.listdir(os.path.join(root, "keras_ocr_tpu_torch"))
                     if name.startswith(("av1", "avif")) and name.endswith(".py"))
    assert modules == ["av1", "av1_filters", "av1_tables", "av1_transforms", "avif"]
    for module in modules:
        with open(os.path.join(root, "keras_ocr_tpu_torch", f"{module}.py"), encoding="utf8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [("." * node.level) + (node.module or "")]
            else:
                continue
            allowed = {"__future__", "struct", "numpy", "functools"}
            if module != "av1_tables":
                allowed.add(".")
            for name in names:
                assert name in allowed, (module, name)
    code = (
        "import sys, hashlib, json, os\n"
        "for name in ('PIL', 'jax', 'jaxlib', 'flax', 'keras_ocr_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from keras_ocr_tpu_torch import tools\n"
        f"hashes = json.load(open({os.path.join(AVIF, 'hashes.json')!r}))\n"
        "for name in ('speed0_text444.avif', 'rgba_premultiplied.avif', 'sub400_full.avif',\n"
        "             'lossy_cdef_photo444_q20.avif', 'lossy_sub422_q75.avif'):\n"
        f"    out = tools.read(os.path.join({AVIF!r}, name))\n"
        "    assert hashlib.sha256(out.tobytes()).hexdigest() == hashes[name]['decoded_sha256']\n"
        "print('avif ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and "avif ok" in proc.stdout, proc.stderr[-3000:]
