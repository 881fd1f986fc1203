"""Write ``keras_ocr_tpu_torch/av1_tables.py``: the AV1 default CDFs and
constant tables that the port's AV1 intra-frame decoder reads, taken from
the AV1 libraries linked into Pillow's bundled libavif.

    python scripts/make_av1_tables.py [--check] [--out keras_ocr_tpu_torch/av1_tables.py]

Pillow's ``pillow.libs/libavif-*.so`` links dav1d (the decoder) and aom
(the encoder). Both keep the AV1 specification's default CDFs as
``32768 - value`` little-endian ``uint16`` rows, each row ending in zeros
(the 0 of 32768, the adaptation counter, and padding to the array's
width). Each table is found by the spec values of its first rows, and a
place is taken only if every row of the whole table has the shape AV1
gives it: ``n - 1`` values that fall strictly, then zeros to the row's
width, for a CDF of ``n`` symbols. Every place that passes must hold the
same table. The constant tables (the directional derivatives, the smooth
weights, the filter-intra taps, the edge-filter kernels, the quantiser
lookups, the transforms' cosines and sines, CDEF's directions, taps,
divisors and chroma directions) are found the same way by their first
entries. The scans are made here by their rule (zig-zag diagonals for
square sizes, diagonals for rectangles, rows and columns for the 1-D
classes) and each must be found whole in the library, as itself or, since
the libraries keep their coefficients transposed, as its transpose. The few tables that
are a handful of small integers are written here.

``--check`` writes nothing: it exits 1 if the committed module differs
from what the library gives. The script needs PIL's libavif; the module it
writes needs nothing.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "..", "keras_ocr_tpu_torch", "av1_tables.py")


def library_path() -> str:
    import PIL

    found = sorted(glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                          "libavif*.so*")))
    if not found:
        raise FileNotFoundError("Pillow's bundled libavif is not installed here")
    return found[0]


# (name, dims as the library stores them, symbols of a row (an int, or a
#  function of the row's index tuple), the row's width in the library,
#  the spec values of the first rows, the index of the part kept)
def _partition_symbols(index):
    ctx = index[0]
    return 4 if ctx < 4 else 8 if ctx >= 16 else 10


CDF_TABLES = (
    ("KF_Y_MODE_CDF", (5, 5), 13, 14,
     [[15588, 17027, 19338, 20218, 20682, 21110, 21825, 23244, 24189, 28165, 29093, 30466]], ()),
    ("UV_MODE_CDF", (2, 13), lambda i: 13 + i[0], 15,
     [[22631, 24152, 25378, 25661, 25986, 26520, 27055, 27923, 28244, 30059, 30941, 31961]], ()),
    ("ANGLE_DELTA_CDF", (8,), 7, 8, [[2180, 5032, 7567, 22776, 26989, 30217]], ()),
    ("PARTITION_CDF", (20,), _partition_symbols, 11, [[19132, 25510, 30392]], ()),
    ("CFL_ALPHA_CDF", (6,), 16, 17,
     [[7637, 20719, 31401, 32481, 32657, 32688, 32692, 32696, 32700, 32704, 32708, 32712, 32716,
       32720, 32724]], ()),
    ("CFL_SIGN_CDF", (1,), 8, 8, [[1418, 2123, 13340, 18405, 26972, 28343, 32294]], (0,)),
    ("FILTER_INTRA_CDF", (22,), 2, 3, [[4621], [6743], [5893]], ()),
    ("FILTER_INTRA_MODE_CDF", (1,), 5, 8, [[8949, 12776, 17211, 29558]], (0,)),
    ("SKIP_CDF", (3,), 2, 2, [[31671], [16515], [4576]], ()),
    ("INTRABC_CDF", (1,), 2, 2, [[30531]], (0,)),
    ("SEGMENT_ID_CDF", (3,), 8, 8, [[5622, 7893, 16093, 18233, 27809, 28373, 32533]], ()),
    ("DELTA_CDF", (6,), 4, 4, [[28160, 32120, 32677]] * 6, ()),
    ("PALETTE_Y_MODE_CDF", (7, 3), 2, 3, [[31676], [3419], [1261]], ()),
    ("PALETTE_UV_MODE_CDF", (2,), 2, 2, [[32461], [21488], [30531]], ()),
    ("PALETTE_Y_SIZE_CDF", (7,), 7, 8, [[7952, 13000, 18149, 21478, 25527, 29241]], ()),
    ("PALETTE_UV_SIZE_CDF", (7,), 7, 8, [[8713, 19979, 27128, 29609, 31331, 32272]], ()),
    ("PALETTE_Y_COLOR_CDF", (7, 5), lambda i: 2 + i[0], 9, [[28710], [16384], [10553]], ()),
    ("PALETTE_UV_COLOR_CDF", (7, 5), lambda i: 2 + i[0], 9, [[29089], [16384], [8713]], ()),
    # tx_depth by the largest transform's category (8, 16, 32, 64 wide or
    # high): two symbols for the first, three for the others.
    ("TX_DEPTH_CDF", (4, 3), lambda i: 2 if i[0] == 0 else 3, 4,
     [[19968], [19968], [24320]], ()),
    # intra_tx_type by the square transform size and the intra direction;
    # set 2's 4x4 and 8x8 rows are uniform.
    ("INTRA_TX_TYPE_SET1_CDF", (2, 13), 7, 8, [[1535, 8035, 9461, 12751, 23467, 27825]], ()),
    ("INTRA_TX_TYPE_SET2_CDF", (3, 13), 5, 8,
     [[6554, 13107, 19661, 26214]] * 26 + [[1127, 12814, 22772, 27483]], ()),
    # Coefficients: [q context][tx size context or plane type][...].
    ("TXB_SKIP_CDF", (4, 5, 13), 2, 3, [[31849], [5892], [12112]], ()),
    ("EOB_EXTRA_CDF", (4, 5, 2, 9), 2, 3, [[16961], [17223], [7621]], ()),
    ("DC_SIGN_CDF", (4, 2, 3), 2, 3, [[16000], [13056], [18816]], ()),
    ("EOB_PT_16_CDF", (4, 2, 2), 5, 6, [[840, 1039, 1980, 4895]], ()),
    ("EOB_PT_32_CDF", (4, 2, 2), 6, 7, [[400, 520, 977, 2102, 6542]], ()),
    ("EOB_PT_64_CDF", (4, 2, 2), 7, 8, [[329, 498, 1101, 1784, 3265, 7758]], ()),
    ("EOB_PT_128_CDF", (4, 2, 2), 8, 9, [[219, 482, 1140, 2091, 3680, 6028, 12586]], ()),
    ("EOB_PT_256_CDF", (4, 2, 2), 9, 10, [[310, 584, 1887, 3589, 6168, 8611, 11352, 15652]], ()),
    # The 512 and 1024 tables keep a row for the 1-D classes too, which
    # never reach them: uniform.
    ("EOB_PT_512_CDF", (4, 2, 2), 10, 11,
     [[641, 983, 3707, 5430, 10234, 14958, 18788, 23412, 26061]], ()),
    ("EOB_PT_1024_CDF", (4, 2, 2), 11, 12,
     [[393, 421, 751, 1623, 3160, 6352, 13345, 18047, 22571, 25830]], ()),
    ("COEFF_BASE_EOB_CDF", (4, 5, 2, 4), 3, 4, [[17837, 29055]], ()),
    ("COEFF_BASE_CDF", (4, 5, 2, 42), 4, 5, [[4034, 8930, 12727]], ()),
    ("COEFF_BR_CDF", (4, 5, 2, 21), 4, 5, [[14298, 20718, 24174]], ()),
)


def _rows_of(dims):
    return [tuple(int(x) for x in i) for i in np.ndindex(*dims)]


def _symbols(spec, index):
    return spec(index) if callable(spec) else spec


def _anchor_bytes(anchor, stride) -> bytes:
    out = []
    for row in anchor:
        out += [32768 - v for v in row] + [0] * (stride - len(row))
    return np.array(out, "<u2").tobytes()


def _read_table(words, start, dims, symbols, stride):
    """The table at word ``start`` in spec form (rows ascending, ending in
    32768), or None where a row does not have AV1's shape."""
    rows = {}
    for n, index in enumerate(_rows_of(dims)):
        count = _symbols(symbols, index)
        row = words[start + n * stride:start + (n + 1) * stride]
        if len(row) < stride:
            return None
        values, rest = row[:count - 1], row[count - 1:]
        if rest.any() or not values.all() or (np.diff(values.astype(np.int64)) >= 0).any():
            return None
        rows[index] = [32768 - int(v) for v in values] + [32768]
    return rows


def find_cdf(blob: bytes, name, dims, symbols, stride, anchor):
    key = _anchor_bytes(anchor, stride)
    found = {}
    words = np.frombuffer(blob[:len(blob) // 2 * 2], "<u2")
    at = blob.find(key)
    while at >= 0:
        if at % 2 == 0:
            table = _read_table(words, at // 2, dims, symbols, stride)
            if table is not None:
                found[at] = table
        at = blob.find(key, at + 1)
    if not found:
        raise LookupError(f"{name}: no place in the library holds a table of its shape")
    tables = list(found.values())
    if any(t != tables[0] for t in tables[1:]):
        raise LookupError(f"{name}: places {sorted(found)} hold different tables")
    return tables[0]


def _nest(rows, dims, keep):
    def build(prefix):
        depth = len(prefix)
        if depth == len(dims):
            return rows[prefix]
        return [build(prefix + (i,)) for i in range(dims[depth])]

    table = build(())
    for i in keep:
        table = table[i]
    return table


def find_words(blob: bytes, name, dtype, anchor, count):
    """``count`` entries of ``dtype`` from each place that starts with
    ``anchor``; every place must hold the same."""
    key = np.array(anchor, dtype).tobytes()
    size = np.dtype(dtype).itemsize
    places = []
    at = blob.find(key)
    while at >= 0:
        places.append(tuple(np.frombuffer(blob[at:at + count * size], dtype).tolist()))
        at = blob.find(key, at + 1)
    if not places or len(set(places)) != 1:
        raise LookupError(f"{name}: {len(set(places))} different tables hold its first entries")
    return list(places[0])


def constant_tables(blob: bytes) -> dict:
    out = {}
    # Spec form, indexed by the prediction angle (0..89); 0 where unused.
    out["DR_INTRA_DERIVATIVE"] = find_words(blob, "Dr_Intra_Derivative", "<i2",
                                            [0, 0, 0, 1023, 0, 0, 547, 0, 0, 372], 90)
    # dav1d's sm_weights: 2 unused entries, then the weights of 4, 8, ... 64.
    weights = find_words(blob, "Sm_Weights", "u1", [0, 0, 255, 128, 255, 149, 85, 64], 128)
    out["SM_WEIGHTS"] = {size: weights[size:2 * size] for size in (4, 8, 16, 32, 64)}
    taps = find_words(blob, "Intra_Filter_Taps", "i1", [-6, 10, 0, 0, 0, 12, 0, 0], 5 * 64)
    out["INTRA_FILTER_TAPS"] = [[taps[m * 64 + i * 8:m * 64 + i * 8 + 7] for i in range(8)]
                                for m in range(5)]
    kernel = find_words(blob, "Intra_Edge_Kernel", "<i4", [0, 4, 8, 4, 0, 0, 5, 6, 5, 0], 15)
    out["INTRA_EDGE_KERNEL"] = [kernel[i * 5:(i + 1) * 5] for i in range(3)]
    # Dc_Qlookup[0] and Ac_Qlookup[0]: the 8-bit rows, by qindex.
    out["DC_QLOOKUP"] = find_words(blob, "Dc_Qlookup", "<i2", [4, 8, 8, 9, 10, 11, 12, 12], 256)
    out["AC_QLOOKUP"] = find_words(blob, "Ac_Qlookup", "<i2", [4, 8, 9, 10, 11, 12, 13, 14], 256)
    # Cos128 of 0..64 (the library keeps 0..63; cos(pi / 2) is 0) and
    # sin(k pi / 9) scaled for the 4-point ADST.
    out["COS128"] = find_words(blob, "Cos128_Lookup", "<i4",
                               [4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036], 64) + [0]
    out["SINPI"] = find_words(blob, "Sinpi", "<i4", [0, 1321, 2482, 3344, 3803], 5)
    out["SCANS"] = scans(blob)
    # CDEF: aom keeps the directions as offsets in a buffer of 144 columns,
    # with directions 6, 7 before and 0, 1 after the eight.
    stride = 144
    first = [-1 * stride + 1, -2 * stride + 2, 0 * stride + 1, -1 * stride + 2, 1, 2]
    padded = find_words(blob, "Cdef_Directions", "<i4", first, 16)
    taps = [[round(v / stride), v - round(v / stride) * stride] for v in padded]
    out["CDEF_DIRECTIONS"] = [taps[d * 2:d * 2 + 2] for d in range(8)]
    out["CDEF_PRI_TAPS"] = np.reshape(find_words(blob, "Cdef_Pri_Taps", "<i4", [4, 2, 3, 3], 4),
                                      (2, 2)).tolist()
    out["CDEF_DIV_TABLE"] = find_words(blob, "Div_Table", "<i4", [0, 840, 420, 280], 9)
    # Cdef_Uv_Dir[subsampling_x][subsampling_y][dir]; 4:4:4 and 4:2:0 keep
    # the direction.
    same = list(range(8))
    uv_440 = find_words(blob, "Cdef_Uv_Dir 4:4:0", "<i4", [1, 2, 2, 2, 3, 4, 6, 0], 8)
    uv_422 = find_words(blob, "Cdef_Uv_Dir 4:2:2", "<i4", [7, 0, 2, 4, 5, 6, 6, 6], 8)
    out["CDEF_UV_DIR"] = [[same, uv_440], [uv_422, same]]
    return out


def _scan_rule(w: int, h: int, kind: str) -> list:
    """A scan of a w x h transform as raster positions: ``row`` and ``col``
    for the 1-D classes; else diagonals from the top left, each going down
    and to the left for tall sizes, up and to the right for wide ones, and
    alternating for square ones, the second diagonal going down."""
    if kind == "row":
        return list(range(w * h))
    if kind == "col":
        return [r * w + c for c in range(w) for r in range(h)]
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]  # going down
        if w > h or (w == h and d % 2 == 0):
            cells.reverse()
        out += [r * w + c for r, c in cells]
    return out


def scans(blob: bytes) -> dict:
    """The default scans of every size up to 32x32 and the row and column
    scans up to 16x16, keyed "WxH kind"; each made by its rule and found
    whole in the library."""
    out = {}
    for w in (4, 8, 16, 32):
        for h in (4, 8, 16, 32):
            if max(w, h) > 4 * min(w, h):
                continue
            kinds = ("default", "row", "col") if max(w, h) <= 16 else ("default",)
            for kind in kinds:
                scan = _scan_rule(w, h, kind)
                transposed = [(p % w) * h + p // w for p in scan]
                if all(blob.find(np.array(s, "<i2").tobytes()) < 0 for s in (scan, transposed)):
                    raise LookupError(f"{kind} scan {w}x{h}: not in the library")
                out[f"{w}x{h} {kind}"] = scan
    return out


WRITTEN = {
    # Mode_To_Angle: the angle of each directional y / uv mode, V_PRED..D67_PRED.
    "MODE_TO_ANGLE": [0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0],
    "PALETTE_COLOR_HASH_MULTIPLIERS": [1, 2, 2],
    "PALETTE_COLOR_CONTEXT": [-1, -1, 0, -1, -1, 4, 3, 2, 1],
    # Coeff_Base_Ctx_Offset by the transform's shape (square, wide, tall),
    # [min(row, 4)][min(col, 4)]; Coeff_Base_Pos_Ctx_Offset for the 1-D
    # classes.
    "COEFF_BASE_CTX_OFFSET": [
        [[0, 1, 6, 6, 21], [1, 6, 6, 21, 21], [6, 6, 21, 21, 21], [6, 21, 21, 21, 21],
         [21, 21, 21, 21, 21]],
        [[0, 16, 6, 6, 21], [16, 16, 6, 21, 21], [16, 16, 21, 21, 21], [16, 16, 21, 21, 21],
         [16, 16, 21, 21, 21]],
        [[0, 11, 11, 11, 11], [11, 11, 11, 11, 11], [6, 6, 21, 21, 21], [6, 21, 21, 21, 21],
         [21, 21, 21, 21, 21]]],
    "COEFF_BASE_POS_CTX_OFFSET": [26, 31, 36],
    # Sig_Ref_Diff_Offset and Mag_Ref_Offset_With_Tx_Class by tx class (2-D,
    # horizontal, vertical), as (row, column).
    "SIG_REF_DIFF_OFFSET": [[[0, 1], [1, 0], [1, 1], [0, 2], [2, 0]],
                            [[0, 1], [1, 0], [0, 2], [0, 3], [0, 4]],
                            [[0, 1], [1, 0], [2, 0], [3, 0], [4, 0]]],
    "MAG_REF_OFFSET": [[[0, 1], [1, 0], [1, 1]], [[0, 1], [1, 0], [0, 2]],
                       [[0, 1], [1, 0], [2, 0]]],
    # Mode_To_Txfm for the uv modes (DCT_DCT 0, ADST_DCT 1, DCT_ADST 2,
    # ADST_ADST 3), UV_CFL_PRED last.
    "MODE_TO_TXFM": [0, 1, 2, 0, 3, 1, 2, 2, 1, 3, 1, 2, 3, 0],
    # Tx_Type_Intra_Inv_Set1 / Set2: intra_tx_type to TxType (IDTX 9, V_DCT
    # 10, H_DCT 11).
    "TX_TYPE_INTRA_INV_SET1": [9, 0, 10, 11, 3, 1, 2],
    "TX_TYPE_INTRA_INV_SET2": [9, 0, 3, 1, 2],
    "FILTER_INTRA_MODE_TO_INTRA_DIR": [0, 1, 2, 6, 0],
    "CDEF_SEC_TAPS": [2, 1],
}


def render(blob: bytes) -> str:
    lines = ['"""AV1 default CDFs and constant tables for the intra-frame decoder',
             "(:mod:`.av1`), in the specification's form: each CDF row holds",
             "its symbols' cumulative counts, ascending, ending at 32768.",
             "",
             "Written by ``scripts/make_av1_tables.py`` from the dav1d and aom",
             "libraries linked into Pillow's bundled libavif. Do not edit.",
             '"""', ""]
    for name, dims, symbols, stride, anchor, keep in CDF_TABLES:
        rows = find_cdf(blob, name, dims, symbols, stride, anchor)
        lines.append(f"{name} = {_nest(rows, dims, keep)!r}")
    for name, value in {**constant_tables(blob), **WRITTEN}.items():
        lines.append(f"{name} = {value!r}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=OUT)
    parser.add_argument("--check", action="store_true")
    args = parser.parse_args(argv)
    with open(library_path(), "rb") as f:
        text = render(f.read())
    if args.check:
        with open(args.out, encoding="utf8") as f:
            same = f.read() == text
        print("av1_tables.py " + ("equals" if same else "differs from") + " the library's tables")
        return 0 if same else 1
    with open(args.out, "w", encoding="utf8") as f:
        f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
