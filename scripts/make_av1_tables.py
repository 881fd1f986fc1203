"""Write ``keras_ocr_tpu_torch/av1_tables.py``: the AV1 default CDFs and
constant tables that the port's lossless AV1 key-frame decoder reads,
taken from the AV1 libraries linked into Pillow's bundled libavif.

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
weights, the filter-intra taps, the edge-filter kernels, the 4x4 scan) are
found the same way by their first entries; the few that are a handful of
small integers are written here.

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
    # Coefficients: [q context][tx size][...]; the decoder keeps q context
    # 0 (base_q_idx <= 20, so every lossless frame) at TX_4X4.
    ("TXB_SKIP_CDF", (4, 5, 13), 2, 3, [[31849], [5892], [12112]], (0, 0)),
    ("EOB_EXTRA_CDF", (4, 5, 2, 9), 2, 3, [[16961], [17223], [7621]], (0, 0)),
    ("DC_SIGN_CDF", (4, 2, 3), 2, 3, [[16000], [13056], [18816]], (0,)),
    ("EOB_PT_16_CDF", (4, 2, 2), 5, 6, [[840, 1039, 1980, 4895]], (0,)),
    ("COEFF_BASE_EOB_CDF", (4, 5, 2, 4), 3, 4, [[17837, 29055]], (0, 0)),
    ("COEFF_BASE_CDF", (4, 5, 2, 42), 4, 5, [[4034, 8930, 12727]], (0, 0)),
    ("COEFF_BR_CDF", (4, 5, 2, 21), 4, 5, [[14298, 20718, 24174]], (0, 0)),
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
    out["DEFAULT_SCAN_4X4"] = find_words(blob, "Default_Scan_4x4", "<i2", [0, 1, 4, 8, 5, 2, 3, 6],
                                         16)
    return out


WRITTEN = {
    # Mode_To_Angle: the angle of each directional y / uv mode, V_PRED..D67_PRED.
    "MODE_TO_ANGLE": [0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0],
    "PALETTE_COLOR_HASH_MULTIPLIERS": [1, 2, 2],
    "PALETTE_COLOR_CONTEXT": [-1, -1, 0, -1, -1, 4, 3, 2, 1],
    # Coeff_Base_Ctx_Offset for TX_4X4 (the rows and columns past 4 are not reached).
    "COEFF_BASE_CTX_OFFSET_4X4": [[0, 1, 6, 6, 0], [1, 6, 6, 21, 0], [6, 6, 21, 21, 0],
                                  [6, 21, 21, 21, 0], [0, 0, 0, 0, 0]],
    "SIG_REF_DIFF_OFFSET_2D": [[0, 1], [1, 0], [1, 1], [0, 2], [2, 0]],
    "MAG_REF_OFFSET_2D": [[0, 1], [1, 0], [1, 1]],
}


def render(blob: bytes) -> str:
    lines = ['"""AV1 default CDFs and constant tables for the lossless key-frame',
             "decoder (:mod:`.av1`), in the specification's form: each CDF row holds",
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
