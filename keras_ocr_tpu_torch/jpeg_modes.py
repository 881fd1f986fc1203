"""Arithmetic-coded and lossless JPEG scans for
:func:`keras_ocr_tpu_torch.tools.decode_jpeg`.

JAX's ``tools.read`` is PIL's ``Image.open(f).convert("RGB")``, and PIL
12's libjpeg-turbo 3 reads these kinds besides Huffman-coded DCT frames.
This module decodes their scans with numpy and the standard library;
``tools._jpeg_frame`` parses the markers and calls it, and the frame's
IDCT, upsampling and colour conversion stay in ``tools``:

* arithmetic-coded sequential (SOF9) and progressive (SOF10) scans: the QM
  decoder of ITU-T T.81 Annex D (the ``Qe`` table with its
  ``Switch_MPS``), the DC statistics conditioned on the previous
  difference (``DAC``'s L and U, default 0 and 1) and the AC statistics
  split at ``DAC``'s Kx (default 5) of Annex F.1.4.4, and the progressive
  models of Annex G.1.3, as libjpeg-turbo's ``jdarith.c`` reads them:
  past the interval's data the decoder reads zeros, and statistics,
  predictions and contexts restart with each restart interval. The
  coefficients land where the Huffman path puts them
  (:func:`arith_sequential`, :func:`arith_dc_first`,
  :func:`arith_dc_refine`, :func:`arith_ac_first`,
  :func:`arith_ac_refine`, each one restart interval);
* lossless Huffman-coded scans (SOF3, :func:`lossless_scan`): predictors
  1-7, the point transform ``Pt``, the prediction 2**(P - Pt - 1) at the
  start of the scan and of each restart interval (which libjpeg-turbo
  takes in whole MCU rows only), Rb down the first column; samples
  come out shifted up by ``Pt``, with no DCT.

libjpeg-turbo has no arithmetic-coded lossless decoder (SOF11), and
converts no colours in a lossless frame (a JFIF marker, or an Adobe
transform other than 0, makes PIL refuse it): ``tools`` refuses both with
``NotImplementedError``. A corrupt arithmetic-coded stream, which
libjpeg-turbo decodes with a warning, raises ``ValueError`` here.
"""

from __future__ import annotations

import numpy as np

# T.81 Table D.2 as libjpeg's ``jaricom.c`` packs it: Qe << 16 |
# Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is a
# fixed estimate of one half that never adapts (sign and refinement bits).
_QE = tuple(qe << 16 | nmps << 8 | switch << 7 | nlps for qe, nlps, nmps, switch in (
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
))
_FIXED = 113
# Statistics bins per table: DC (5 contexts of 4, X1-X15 at 20, M2-M15 at
# 34) and AC (3 per coefficient index, then the two X/M banks at 189, 217).
_DC_BINS, _AC_BINS = 64, 256


def _zigzag():
    """The natural (row-major) index of each zigzag position, then 16
    entries of 63: a corrupt run past the block's end lands on the last
    coefficient, as in libjpeg's ``jpeg_natural_order``."""
    order = []
    for diagonal in range(15):
        rows = range(max(0, diagonal - 7), min(diagonal, 7) + 1)
        for row in rows if diagonal % 2 else reversed(rows):
            order.append(row * 8 + diagonal - row)
    return order + [63] * 16


NATURAL = _zigzag()


def parse_dac(segment: bytes, conditioning: dict, name: str) -> None:
    """A ``DAC`` segment into ``conditioning``: (0, table) -> (L, U) of a DC
    table, (1, table) -> Kx of an AC table, as ``jdmarker.c:get_dac``
    reads them."""
    if len(segment) % 2:
        raise ValueError(f"{name}: corrupt JPEG: bad DAC segment")
    for at in range(0, len(segment), 2):
        index, value = segment[at], segment[at + 1]
        if index >= 32:
            raise ValueError(f"{name}: corrupt JPEG: DAC table index {index}")
        if index >= 16:
            conditioning[1, index - 16] = value
        else:
            lower, upper = value & 15, value >> 4
            if lower > upper:
                raise ValueError(f"{name}: corrupt JPEG: DAC value {value:#x} has L > U")
            conditioning[0, index] = (lower, upper)


def _qm_decoder(data: bytes):
    """The QM decoder of one interval's unstuffed bytes (T.81 D.2, as
    ``jdarith.c:arith_decode``): ``decode(stats, index)`` returns one
    decision of the bin ``stats[index]`` (state index in the low 7 bits,
    the MPS in bit 7) and updates its estimate. Bytes past the data are
    zeros, as after a marker."""
    size = len(data)
    c = a = pos = 0
    ct = -16

    def decode(stats, index):
        nonlocal c, a, ct, pos
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                c = (c << 8) | (data[pos] if pos < size else 0)
                pos += 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:  # two initial bytes read
                        a = 0x8000
            a <<= 1
        sv = stats[index]
        q = _QE[sv & 0x7F]
        qe = q >> 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:  # conditional exchange: the MPS after all
                a = qe
                stats[index] = (sv & 0x80) ^ ((q >> 8) & 0xFF)
                return sv >> 7
            a = qe
            stats[index] = (sv & 0x80) ^ (q & 0xFF)
            return (sv >> 7) ^ 1
        if a < 0x8000:
            if a < qe:  # conditional exchange: the LPS
                stats[index] = (sv & 0x80) ^ (q & 0xFF)
                return (sv >> 7) ^ 1
            stats[index] = (sv & 0x80) ^ ((q >> 8) & 0xFF)
        return sv >> 7

    return decode


def _bad(name, what):
    return ValueError(f"{name}: corrupt JPEG: arithmetic-coded data ({what})")


def _magnitude(decode, stats, st, x1, name):
    """Figure F.23 from bin ``st``: the magnitude category's top bit ``m``
    (0 for |v| = 1) and the bin its last decision took. DC's later
    decisions take X1 = 20 on; AC takes a second decision at ``st``, then
    ``x1`` on."""
    m = decode(stats, st)
    if m:
        if x1 is None:
            st, more = 20, True
        else:
            more = decode(stats, st)
            if more:
                m, st = 2, x1
        if more:
            while decode(stats, st):
                m <<= 1
                if m == 0x8000:
                    raise _bad(name, "magnitude overflow")
                st += 1
    return m, st


def _bits(decode, stats, st, m):
    """Figure F.24: the bits of |v| - 1 below its top bit ``m`` from bin
    ``st`` + 14; returns |v|."""
    v = m
    st += 14
    while m := m >> 1:
        if decode(stats, st):
            v |= m
    return v + 1


def _dc_difference(decode, stats, context, slot, lower, upper, name):
    """F.1.4.4.1: a DC difference, decoded in the context its component's
    previous difference set (zero, small or large, by sign), and the
    context it sets by L and U."""
    st = context[slot]
    if not decode(stats, st):
        context[slot] = 0
        return 0
    sign = decode(stats, st + 1)
    m, st = _magnitude(decode, stats, st + 2 + sign, None, name)
    if m < (1 << lower) >> 1:
        context[slot] = 0
    elif m > (1 << upper) >> 1:
        context[slot] = 12 + 4 * sign
    else:
        context[slot] = 4 + 4 * sign
    v = _bits(decode, stats, st, m)
    return -v if sign else v


def _ac_value(decode, stats, fixed, st, k, kx, name):
    """F.1.4.4.2 from a coefficient's nonzero decision at ``st`` + 1 on:
    its sign (fixed estimate), magnitude category (X1 by ``k`` against
    Kx) and bits."""
    sign = decode(fixed, 0)
    m, st = _magnitude(decode, stats, st + 2, 189 if k <= kx else 217, name)
    v = _bits(decode, stats, st, m)
    return -v if sign else v


def arith_sequential(data, blocks, name):
    """A sequential (SOF9) scan's restart interval: each block's DC
    difference, then its AC coefficients 1-63 (F.1.4.4). ``blocks`` holds
    (coefficients, base, (DC table, L, U), (AC table, Kx), slot,
    predictions) per block in stream order."""
    decode = _qm_decoder(data)
    natural = NATURAL
    fixed = [_FIXED]
    dc_stats, ac_stats = {}, {}
    context = [0] * 4
    for coefs, base, (dc, lower, upper), (ac, kx), slot, preds in blocks:
        stats = dc_stats.get(dc) or dc_stats.setdefault(dc, [0] * _DC_BINS)
        preds[slot] += _dc_difference(decode, stats, context, slot, lower, upper, name)
        coefs[base] = preds[slot]
        stats = ac_stats.get(ac) or ac_stats.setdefault(ac, [0] * _AC_BINS)
        k = 1
        while k <= 63:
            st = 3 * (k - 1)
            if decode(stats, st):  # end of block
                break
            while not decode(stats, st + 1):
                st += 3
                k += 1
                if k > 63:
                    raise _bad(name, "spectral overflow")
            coefs[base + natural[k]] = _ac_value(decode, stats, fixed, st, k, kx, name)
            k += 1


def arith_dc_first(data, blocks, name, low):
    """A progressive DC scan's first pass: differences as in a sequential
    scan, the DC stored shifted up by ``low``."""
    decode = _qm_decoder(data)
    dc_stats = {}
    context = [0] * 4
    for coefs, base, (dc, lower, upper), _, slot, preds in blocks:
        stats = dc_stats.get(dc) or dc_stats.setdefault(dc, [0] * _DC_BINS)
        preds[slot] += _dc_difference(decode, stats, context, slot, lower, upper, name)
        coefs[base] = preds[slot] << low


def arith_dc_refine(data, blocks, name, low):
    """A progressive DC refinement: one bit at ``low`` per block, at the
    fixed estimate."""
    decode = _qm_decoder(data)
    fixed = [_FIXED]
    bit = 1 << low
    for coefs, base, _, _, _, _ in blocks:
        if decode(fixed, 0):
            coefs[base] |= bit


def arith_ac_first(data, blocks, name, start, end, low):
    """A first progressive AC pass over the band ``start``-``end`` of one
    component (G.1.3.2): coefficients shifted up by ``low``."""
    decode = _qm_decoder(data)
    natural = NATURAL
    fixed = [_FIXED]
    ac_stats = {}
    for coefs, base, _, (ac, kx), _, _ in blocks:
        stats = ac_stats.get(ac) or ac_stats.setdefault(ac, [0] * _AC_BINS)
        k = start
        while k <= end:
            st = 3 * (k - 1)
            if decode(stats, st):
                break
            while not decode(stats, st + 1):
                st += 3
                k += 1
                if k > end:
                    raise _bad(name, "spectral overflow")
            coefs[base + natural[k]] = _ac_value(decode, stats, fixed, st, k, kx, name) << low
            k += 1


def arith_ac_refine(data, blocks, name, start, end, low):
    """A progressive AC refinement over ``start``-``end`` (G.1.3.3): a
    correction bit for each coefficient already nonzero, new coefficients
    of magnitude ``1 << low``; the end-of-block decision is taken only
    past the last coefficient nonzero before this pass."""
    decode = _qm_decoder(data)
    natural = NATURAL
    fixed = [_FIXED]
    ac_stats = {}
    plus, minus = 1 << low, -1 << low
    for coefs, base, _, (ac, _), _, _ in blocks:
        stats = ac_stats.get(ac) or ac_stats.setdefault(ac, [0] * _AC_BINS)
        last = end
        while last > 0 and not coefs[base + natural[last]]:
            last -= 1
        k = start
        while k <= end:
            st = 3 * (k - 1)
            if k > last and decode(stats, st):
                break
            while True:
                index = base + natural[k]
                coef = coefs[index]
                if coef:
                    if decode(stats, st + 2):
                        coefs[index] = coef + (minus if coef < 0 else plus)
                    break
                if decode(stats, st + 1):
                    coefs[index] = minus if decode(fixed, 0) else plus
                    break
                st += 3
                k += 1
                if k > end:
                    raise _bad(name, "spectral overflow")
            k += 1


# ---------------------------------------------------------------------------
# Lossless (T.81 Annex H; jdlossls.c, jdlhuff.c)
# ---------------------------------------------------------------------------


def windows(data: bytes) -> list:
    """For each byte offset, the 40 bits starting there (big-endian), with
    0xFF fill past the end: a 16-bit Huffman code and its extra bits are
    read from one window whatever the bit offset in the first byte."""
    raw = np.frombuffer(data + b"\xff" * 8, np.uint8).astype(np.int64)
    n = len(data) + 1
    win = raw[:n] << 32
    for i in range(1, 5):
        win |= raw[i : n + i] << (32 - 8 * i)
    return win.tolist()


def _differences(data, tables, name) -> list:
    """The Huffman-coded differences of one restart interval, one per
    entry of ``tables`` (each a 16-bit lookup table: length << 8 |
    category); category 16 is 32768 with no extra bits."""
    win = windows(data)
    pos = 0
    out = []
    append = out.append
    for table in tables:
        w = win[pos >> 3]
        avail = 40 - (pos & 7)
        entry = table[(w >> (avail - 16)) & 0xFFFF]
        if not entry:
            raise ValueError(f"{name}: corrupt JPEG: bad Huffman code")
        length, size = entry >> 8, entry & 0xFF
        if size == 0:
            append(0)
        elif size == 16:
            append(32768)
        elif size > 16:
            raise ValueError(f"{name}: corrupt JPEG: lossless difference of {size} bits")
        else:
            value = (w >> (avail - length - size)) & ((1 << size) - 1)
            append(value - (1 << size) + 1 if value < 1 << (size - 1) else value)
            length += size
        pos += length
    if pos > 8 * len(data):
        raise ValueError(f"{name}: truncated JPEG: the scan data ends inside an MCU")
    return out


def lossless_scan(frame, members, predictor, pt, pieces, restart, name) -> None:
    """Decode a lossless scan into ``frame["components"][i]["samples"]``
    ((rows, cols) int64 at the component's size). ``members`` holds
    (component, DC lookup table) per scan component; ``pieces`` the
    unstuffed data of each restart interval of ``restart`` MCUs (0: one
    interval)."""
    width, height = frame["width"], frame["height"]
    hmax, vmax = frame["hmax"], frame["vmax"]
    interleaved = len(members) > 1
    if interleaved:
        mcus_y, mcus_x = -(-height // vmax), -(-width // hmax)
        per_mcu = [(c, table) for c, table in members for _ in range(c["v"] * c["h"])]
    else:
        c = members[0][0]
        mcus_y, mcus_x = -(-height * c["v"] // vmax), -(-width * c["h"] // hmax)
        per_mcu = [members[0]]
    if restart and restart % mcus_x:
        raise NotImplementedError(f"{name}: lossless JPEG with a restart interval of {restart} "
                                  f"MCUs, not whole rows of {mcus_x} (libjpeg refuses it)")
    rows_per = restart // mcus_x if restart else mcus_y
    intervals = -(-mcus_y // rows_per)
    if len(pieces) < intervals:
        raise ValueError(f"{name}: truncated JPEG: {len(pieces)} of {intervals} restart "
                         "intervals")
    tables = [table for _, table in per_mcu]
    values = []
    for i in range(intervals):
        count = min(rows_per, mcus_y - i * rows_per) * mcus_x
        values += _differences(pieces[i], tables * count, name)
    diffs = np.array(values, np.int64).reshape(mcus_y, mcus_x, len(per_mcu))
    at = 0
    for c, _ in members:
        h, v = (c["h"], c["v"]) if interleaved else (1, 1)
        grid = diffs[..., at : at + h * v].reshape(mcus_y, mcus_x, v, h)
        grid = grid.transpose(0, 2, 1, 3).reshape(mcus_y * v, mcus_x * h)
        at += h * v
        rows = -(-height * c["v"] // vmax)
        cols = -(-width * c["h"] // hmax)
        # jddiffct.c undifferences an iMCU row (v sample rows of a lone
        # component) after decoding it: a restart inside one resets the
        # predictor from its first row on.
        group = v if interleaved else c["v"]
        first = sorted({y // group * group for y in range(0, mcus_y * v, rows_per * v)})
        samples = _undifference(grid[:, :cols], predictor, first, 1 << (8 - pt - 1))[:rows]
        c["samples"] = ((samples << pt) & 0xFF).astype(np.uint8)


def _undifference(diff, predictor, first_rows, initial):
    """Samples (modulo 2**16) from their differences row by row: the first
    row of the scan and of each restart interval from ``initial`` then
    Ra, the first column from Rb, the rest by ``predictor``."""
    out = np.zeros(diff.shape, np.int64)
    first_rows = set(first_rows)
    mask = 0xFFFF
    for y in range(diff.shape[0]):
        d = diff[y]
        if y in first_rows:
            d = d.copy()
            d[0] += initial
            out[y] = np.cumsum(d) & mask
            continue
        rb = out[y - 1]
        rc = np.concatenate([[0], rb[:-1]])
        if predictor == 2:
            out[y] = (d + rb) & mask
        elif predictor == 3:
            row = d + rc
            row[0] = d[0] + rb[0]
            out[y] = row & mask
        elif predictor in (1, 4, 5):
            # x = d + Ra + t with t independent of the row: a running sum.
            t = {1: 0, 4: rb - rc, 5: (rb - rc) >> 1}[predictor]
            steps = d + t
            steps[0] = d[0] + rb[0]
            out[y] = np.cumsum(steps) & mask
        else:
            # Predictors 6 and 7 halve a sum with Ra: one sample at a time.
            row = [0] * len(d)
            dl, rbl, rcl = d.tolist(), rb.tolist(), rc.tolist()
            ra = row[0] = (dl[0] + rbl[0]) & mask
            if predictor == 6:
                for x in range(1, len(dl)):
                    ra = row[x] = (dl[x] + rbl[x] + ((ra - rcl[x]) >> 1)) & mask
            else:
                for x in range(1, len(dl)):
                    ra = row[x] = (dl[x] + ((ra + rbl[x]) >> 1)) & mask
            out[y] = row
    return out
