"""Tier-1 of the JPEG 2000 decoder (:mod:`.jpeg2000`): the MQ arithmetic
decoder of ITU-T T.800 Annex C, the three coding passes of Annex D over
one code-block, and the sample reconstruction that follows them, each as
OpenJPEG 2.5 (the library PIL decodes JPEG 2000 with) computes it:

* code-block values keep one fractional bit: a sample that turns
  significant at bit-plane ``p`` is set to ``3 << p`` (the middle of its
  interval, doubled) and each refinement moves it by ``1 << (p - 1)``;
  the 5/3 path divides by 2 toward zero at the end, the 9/7 path
  multiplies by half the step size in float32;
* the inverse 5/3 wavelet in integers and the 9/7 one in float32 with
  OpenJPEG's constants and step order (``opj_v8dwt_decode``: the
  ``K`` / ``2 / K`` scaling first, then the four lifting steps), each
  float32 operation rounded on its own as OpenJPEG's SSE code does;
* the reversible (RCT) and irreversible (ICT, ``opj_mct_decode_real``)
  colour transforms and the DC level shift with ``lrintf`` rounding.

numpy only; the passes are a Python loop over the samples a pass can
code, with the neighbourhood of each sample kept in one int of flags.
"""

from __future__ import annotations

import functools

import numpy as np

# T.800 Table C.2: (Qe, next index after an MPS, after an LPS, switch).
MQ_TABLE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0), (0x0AC1, 4, 12, 0),
    (0x0521, 5, 29, 0), (0x0221, 38, 33, 0), (0x5601, 7, 6, 1), (0x5401, 8, 14, 0),
    (0x4801, 9, 14, 0), (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1), (0x5401, 16, 14, 0),
    (0x5101, 17, 15, 0), (0x4801, 18, 16, 0), (0x3801, 19, 17, 0), (0x3401, 20, 18, 0),
    (0x3001, 21, 19, 0), (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0), (0x1401, 28, 25, 0),
    (0x1201, 29, 26, 0), (0x1101, 30, 27, 0), (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0),
    (0x08A1, 33, 30, 0), (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0), (0x0085, 40, 37, 0),
    (0x0049, 41, 38, 0), (0x0025, 42, 39, 0), (0x0015, 43, 40, 0), (0x0009, 44, 41, 0),
    (0x0005, 45, 42, 0), (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
)

# A context's state is one int, 2 * index + MPS; these give its Qe and
# the state after an MPS or an LPS decision (the switch applied).
QE = [q for q, _, _, _ in MQ_TABLE for _ in (0, 1)]
NEXT_MPS = [2 * n_mps + mps for _, n_mps, _, _ in MQ_TABLE for mps in (0, 1)]
NEXT_LPS = [2 * n_lps + (mps ^ switch) for _, _, n_lps, switch in MQ_TABLE for mps in (0, 1)]

# Shifts that renormalise an interval A below 0x8000 (its top bit to 15).
RENORM = [16 - a.bit_length() for a in range(0x8000)]

# The 19 contexts of Annex D: zero coding 0-8, sign 9-13, magnitude
# refinement 14-16, run length 17, uniform 18; their initial states.
CX_RL, CX_UNI = 17, 18
CONTEXTS_INIT = tuple(2 * 4 if cx == 0 else 2 * 3 if cx == CX_RL else 2 * 46 if cx == CX_UNI
                      else 0 for cx in range(19))

# Code-block style bits (COD / COC SPcod byte 4).
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32

# A sample's flags: which of its 8 neighbours are significant, the signs
# of its 4 direct neighbours, its own significance and whether it was
# refined.
NW, N, NE, W, E, SW, S, SE = 1, 2, 4, 8, 16, 32, 64, 128
N_NEG, S_NEG, W_NEG, E_NEG = 256, 512, 1024, 2048
SIG, MU = 4096, 8192
NEIGHBOURS = 0xFF
SIGN_BITS = 0xFFF


def _zero_coding(h: int, v: int, d: int, orient: int) -> int:
    """T.800 Table D.1: the context of a sample with ``h`` / ``v`` / ``d``
    significant horizontal / vertical / diagonal neighbours in a band of
    orientation ``orient`` (0 LL, 1 HL, 2 LH, 3 HH)."""
    if orient == 3:
        hv = h + v
        if d >= 3:
            return 8
        if d == 2:
            return 7 if hv >= 1 else 6
        if d == 1:
            return 5 if hv >= 2 else 4 if hv == 1 else 3
        return 2 if hv >= 2 else hv
    if orient == 1:  # HL: horizontally high-pass, the vertical neighbours lead
        h, v = v, h
    if h == 2:
        return 8
    if h == 1:
        return 7 if v >= 1 else 6 if d >= 1 else 5
    if v == 2:
        return 4
    if v == 1:
        return 3
    return 2 if d >= 2 else d


def _zero_coding_lut(orient: int) -> list:
    table = []
    for bits in range(256):
        h = bool(bits & W) + bool(bits & E)
        v = bool(bits & N) + bool(bits & S)
        d = bool(bits & NW) + bool(bits & NE) + bool(bits & SW) + bool(bits & SE)
        table.append(_zero_coding(h, v, d, orient))
    return table


def _sign_lut() -> list:
    """T.800 Table D.3 keyed by a sample's low 12 flag bits: ``2 * context
    + XOR bit``."""
    pairs = {(1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0), (0, 1): (10, 0),
             (0, 0): (9, 0), (0, -1): (10, 1), (-1, 1): (11, 1), (-1, 0): (12, 1),
             (-1, -1): (13, 1)}
    table = []
    for bits in range(4096):
        def contribution(sig, neg):
            return 0 if not bits & sig else -1 if bits & neg else 1
        h = max(-1, min(1, contribution(W, W_NEG) + contribution(E, E_NEG)))
        v = max(-1, min(1, contribution(N, N_NEG) + contribution(S, S_NEG)))
        cx, xor = pairs[(h, v)]
        table.append(2 * cx + xor)
    return table


ZC_LUTS = tuple(_zero_coding_lut(orient) for orient in range(4))
SC_LUT = _sign_lut()


@functools.lru_cache(maxsize=256)
def _layout(width: int, height: int):
    """Scan order of a ``width`` x ``height`` code-block in a flag array
    padded by one sample on each side: the columns of its full stripes of
    4 rows, the columns of its last, shorter stripe, and which padded
    indices lie on the first row of a stripe."""
    wide = width + 2
    full, partial = [], []
    top = bytearray(wide * (height + 2))
    for y0 in range(0, height, 4):
        rows = range(y0, min(y0 + 4, height))
        top[(y0 + 1) * wide:(y0 + 2) * wide] = b"\x01" * wide
        columns = full if len(rows) == 4 else partial
        for x in range(width):
            columns.append(tuple((y + 1) * wide + x + 1 for y in rows))
    return tuple(full), tuple(partial), bytes(top)


def mq_decoder(contexts: list):
    """The MQ decoder of T.800 Annex C as OpenJPEG runs it (``opj_mqc_*``)
    over the context states ``contexts`` (``2 * index + MPS``, updated in
    place): ``start(data)`` / ``start_raw(data)`` begin a codeword segment
    (arithmetic or BYPASS raw), ``decide(cx)`` and ``raw()`` return its
    next decision. Past its end a segment reads as 0xFF 0xFF, the marker
    OpenJPEG appends."""
    qe, next_mps, next_lps = QE, NEXT_MPS, NEXT_LPS
    mask = 0xFFFFFFFF
    a = c = ct = bp = 0
    buf = b""

    def start(data):
        nonlocal a, c, ct, bp, buf
        buf = bytes(data) + b"\xff\xff"
        bp = 0
        c = buf[0] << 16
        if buf[0] == 0xFF:
            if buf[1] > 0x8F:
                c += 0xFF00
                ct = 8
            else:
                bp = 1
                c += buf[1] << 9
                ct = 7
        else:
            bp = 1
            c += buf[1] << 8
            ct = 8
        c = (c << 7) & mask
        ct -= 7
        a = 0x8000

    def start_raw(data):
        nonlocal c, ct, bp, buf
        buf = bytes(data) + b"\xff\xff"
        bp = c = ct = 0

    def decide(cx):
        nonlocal a, c, ct, bp
        s = contexts[cx]
        q = qe[s]
        a -= q
        if (c >> 16) < q:
            if a < q:
                d = s & 1
                contexts[cx] = next_mps[s]
            else:
                d = (s & 1) ^ 1
                contexts[cx] = next_lps[s]
            a = q
        else:
            c -= q << 16
            if a & 0x8000:
                return s & 1
            if a < q:
                d = (s & 1) ^ 1
                contexts[cx] = next_lps[s]
            else:
                d = s & 1
                contexts[cx] = next_mps[s]
        shift = RENORM[a]
        a <<= shift
        while shift > ct:
            c = (c << ct) & mask
            shift -= ct
            if buf[bp] == 0xFF:
                nxt = buf[bp + 1]
                if nxt > 0x8F:
                    c += 0xFF00
                    ct = 8
                else:
                    bp += 1
                    c = (c + (nxt << 9)) & mask
                    ct = 7
            else:
                bp += 1
                c += buf[bp] << 8
                ct = 8
        c = (c << shift) & mask
        ct -= shift
        return d

    def raw():
        nonlocal c, ct, bp
        if ct == 0:
            if c == 0xFF:
                if buf[bp] > 0x8F:
                    c = 0xFF
                    ct = 8
                else:
                    c = buf[bp]
                    bp += 1
                    ct = 7
            else:
                c = buf[bp]
                bp += 1
                ct = 8
        ct -= 1
        return (c >> ct) & 1

    return start, start_raw, decide, raw


def mq_decode(data: bytes, contexts, initial=None) -> list:
    """The decisions of one MQ codeword segment, each in the context of the
    same index of ``contexts``; ``initial`` maps a context to its first
    state index (0 otherwise), its MPS 0."""
    states = [2 * (initial or {}).get(cx, 0) for cx in range(max(contexts, default=0) + 1)]
    start, _, decide, _ = mq_decoder(states)
    start(data)
    return [decide(cx) for cx in contexts]


def decode_codeblock(segments, width: int, height: int, orient: int, numbps: int,
                     roishift: int, style: int, name: str = "image") -> np.ndarray:
    """The (height, width) int64 values of one code-block, with OpenJPEG's
    extra fractional bit (``opj_t1_decode_cblk``): ``segments`` is a list
    of (bytes, passes) codeword segments, ``numbps`` the code-block's
    magnitude bit-planes (the band's less its zero bit-planes),
    ``roishift`` the RGN max-shift and ``style`` the code-block style
    bits."""
    bpno = roishift + numbps  # OpenJPEG's bpno_plus_one; below 1 (zero bit-planes past the
    if bpno >= 31:            # band's), no pass is decoded
        raise ValueError(f"{name}: a code-block has {numbps} bit-planes (ROI shift {roishift})")
    wide = width + 2
    size = wide * (height + 2)
    flags = [0] * size
    values = [0] * size
    visited = [0] * size  # the bit-plane whose significance pass coded the sample
    full, partial, top = _layout(width, height)
    columns = full + partial
    zc = ZC_LUTS[orient]
    sc = SC_LUT
    contexts = list(CONTEXTS_INIT)
    causal = bool(style & VSC)
    start, start_raw, decide, raw = mq_decoder(contexts)

    def significant(p, negative):
        flags[p] |= SIG
        flags[p - 1] |= E | (E_NEG if negative else 0)
        flags[p + 1] |= W | (W_NEG if negative else 0)
        if not (causal and top[p]):
            flags[p - wide - 1] |= SE
            flags[p - wide] |= S | (S_NEG if negative else 0)
            flags[p - wide + 1] |= SW
        flags[p + wide - 1] |= NE
        flags[p + wide] |= N | (N_NEG if negative else 0)
        flags[p + wide + 1] |= NW

    passtype = 2
    for data, passes in segments:
        lazy = bool(style & BYPASS) and bpno <= numbps - 4 and passtype < 2
        if lazy:
            start_raw(data)
        else:
            start(data)
        for _ in range(passes):
            if bpno < 1:
                break
            one = 1 << bpno
            if passtype == 0:  # significance propagation
                oneplushalf = one | (one >> 1)
                for column in columns:
                    for p in column:
                        f = flags[p]
                        if f & SIG or not f & NEIGHBOURS:
                            continue
                        if lazy:
                            if raw():
                                negative = raw()
                                values[p] = -oneplushalf if negative else oneplushalf
                                significant(p, negative)
                        elif decide(zc[f & NEIGHBOURS]):
                            v = sc[f & SIGN_BITS]
                            negative = decide(v >> 1) ^ (v & 1)
                            values[p] = -oneplushalf if negative else oneplushalf
                            significant(p, negative)
                        visited[p] = bpno
            elif passtype == 1:  # magnitude refinement
                half = one >> 1
                for column in columns:
                    for p in column:
                        f = flags[p]
                        if not f & SIG or visited[p] == bpno:
                            continue
                        if lazy:
                            bit = raw()
                        else:
                            bit = decide(16 if f & MU else 15 if f & NEIGHBOURS else 14)
                        value = values[p]
                        values[p] = value + half if bit ^ (value < 0) else value - half
                        flags[p] = f | MU
            else:  # cleanup, with run-length coding of quiet full columns
                oneplushalf = one | (one >> 1)
                for column in full:
                    p0, p1, p2, p3 = column
                    if flags[p0] | flags[p1] | flags[p2] | flags[p3]:
                        first = 0
                    else:
                        if not decide(CX_RL):
                            continue
                        first = decide(CX_UNI) << 1
                        first |= decide(CX_UNI)
                        p = column[first]
                        v = sc[flags[p] & SIGN_BITS]
                        negative = decide(v >> 1) ^ (v & 1)
                        values[p] = -oneplushalf if negative else oneplushalf
                        significant(p, negative)
                        first += 1
                    for p in column[first:]:
                        f = flags[p]
                        if f & SIG or visited[p] == bpno:
                            continue
                        if decide(zc[f & NEIGHBOURS]):
                            v = sc[f & SIGN_BITS]
                            negative = decide(v >> 1) ^ (v & 1)
                            values[p] = -oneplushalf if negative else oneplushalf
                            significant(p, negative)
                for column in partial:
                    for p in column:
                        f = flags[p]
                        if f & SIG or visited[p] == bpno:
                            continue
                        if decide(zc[f & NEIGHBOURS]):
                            v = sc[f & SIGN_BITS]
                            negative = decide(v >> 1) ^ (v & 1)
                            values[p] = -oneplushalf if negative else oneplushalf
                            significant(p, negative)
                if style & SEGSYM:
                    for _ in range(4):
                        decide(CX_UNI)
            if style & RESET and not lazy:
                contexts[:] = CONTEXTS_INIT
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno -= 1
    out = np.array(values, dtype=np.int64).reshape(height + 2, wide)
    return out[1:-1, 1:-1]


def reconstruct(values: np.ndarray, roishift: int, reversible: bool, stepsize: float):
    """OpenJPEG's last steps for a code-block's values
    (``opj_t1_clbl_decode_processor``): the ROI max-shift undone on the
    magnitudes at or above ``1 << roishift``, then halved toward zero
    (5/3, int32) or times ``0.5 * stepsize`` (9/7, float32)."""
    if roishift:
        if roishift >= 31:
            values = np.zeros_like(values)
        else:
            magnitude = np.abs(values)
            shifted = magnitude >= (1 << roishift)
            magnitude = np.where(shifted, magnitude >> roishift, magnitude)
            values = np.where(values < 0, -magnitude, magnitude)
    if reversible:
        return (np.sign(values) * (np.abs(values) // 2)).astype(np.int32)
    half = np.float32(0.5) * np.float32(stepsize)
    return values.astype(np.int32).astype(np.float32) * half


def _mirror(x: np.ndarray) -> np.ndarray:
    """``x`` along its last axis with one sample mirrored on each end
    (T.800's whole-sample symmetric extension; length >= 2)."""
    return np.concatenate([x[..., 1:2], x, x[..., -2:-1]], axis=-1)


def idwt53_1d(x: np.ndarray, parity: int) -> np.ndarray:
    """Inverse 5/3 lifting along the last axis of the interleaved int64
    ``x`` whose first sample sits at a coordinate of ``parity``."""
    length = x.shape[-1]
    if length == 1:
        return x if parity == 0 else np.sign(x) * (np.abs(x) // 2)
    x = x.copy()
    for target, offset in ((slice(parity, None, 2), 2 + parity),
                           (slice(1 - parity, None, 2), 3 - parity)):
        padded = _mirror(x)
        count = x[..., target].shape[-1]
        neighbours = padded[..., target][..., :count] + padded[..., offset::2][..., :count]
        if offset == 2 + parity:
            x[..., target] -= (neighbours + 2) >> 2
        else:
            x[..., target] += neighbours >> 1
    return x


# OpenJPEG 2.5's 9/7 constants (dwt.c), as float32.
ALPHA = np.float32(1.586134342)
BETA = np.float32(0.052980118)
GAMMA = np.float32(-0.882911075)
DELTA = np.float32(-0.443506852)
K = np.float32(1.230174105)
TWO_INV_K = np.float32(1.625732422)


def idwt97_1d(x: np.ndarray, parity: int) -> np.ndarray:
    """Inverse 9/7 along the last axis of the interleaved float32 ``x``,
    step for step as ``opj_v8dwt_decode``: low samples times ``K``, high
    ones times ``2 / K``, then ``x += (left + right) * c`` for c = delta
    (low), gamma (high), beta (low), alpha (high), with mirrored ends. A
    signal of one sample is left as it is."""
    length = x.shape[-1]
    if length == 1:
        return x
    x = x.copy()
    low = slice(parity, None, 2)
    high = slice(1 - parity, None, 2)
    x[..., low] *= K
    x[..., high] *= TWO_INV_K
    for target, offset, coefficient in ((low, 2 + parity, DELTA), (high, 3 - parity, GAMMA),
                                        (low, 2 + parity, BETA), (high, 3 - parity, ALPHA)):
        padded = _mirror(x)
        count = x[..., target].shape[-1]
        neighbours = padded[..., target][..., :count] + padded[..., offset::2][..., :count]
        x[..., target] = x[..., target] + neighbours * coefficient
    return x


def interleave(low: np.ndarray, high: np.ndarray, parity: int, axis: int) -> np.ndarray:
    """``low`` and ``high`` merged along ``axis``: low samples at the even
    coordinates of a signal whose first sample has ``parity``."""
    low = np.moveaxis(low, axis, -1)
    high = np.moveaxis(high, axis, -1)
    out = np.empty(low.shape[:-1] + (low.shape[-1] + high.shape[-1],), dtype=low.dtype)
    out[..., parity::2] = low
    out[..., 1 - parity::2] = high
    return out


def inverse_level(ll, hl, lh, hh, x0: int, y0: int, reversible: bool) -> np.ndarray:
    """One inverse decomposition level (``opj_dwt_decode_tile`` /
    ``opj_dwt_decode_tile_97``): every row first, then every column, of a
    resolution whose origin is (``x0``, ``y0``)."""
    lift = idwt53_1d if reversible else idwt97_1d
    top = lift(interleave(ll, hl, x0 & 1, axis=1), x0 & 1)
    bottom = lift(interleave(lh, hh, x0 & 1, axis=1), x0 & 1)
    return lift(interleave(top, bottom, y0 & 1, axis=0), y0 & 1).T


def inverse_rct(y: np.ndarray, u: np.ndarray, v: np.ndarray):
    """The reversible colour transform's inverse (``opj_mct_decode``)."""
    g = y - ((u + v) >> 2)
    return v + g, g, u + g


def inverse_ict(y: np.ndarray, u: np.ndarray, v: np.ndarray):
    """The irreversible colour transform's inverse in float32, as
    ``opj_mct_decode_real`` orders it."""
    r = y + v * np.float32(1.402)
    g = y - u * np.float32(0.34413) - v * np.float32(0.71414)
    b = y + u * np.float32(1.772)
    return r, g, b


def level_shift(plane: np.ndarray, reversible: bool, precision: int, signed: bool) -> np.ndarray:
    """``opj_tcd_dc_level_shift_decode``: float samples rounded half to
    even (``lrintf``), the DC offset added and the result clamped to the
    component's range, as int64."""
    if signed:
        low, high, offset = -(1 << (precision - 1)), (1 << (precision - 1)) - 1, 0
    else:
        low, high, offset = 0, (1 << precision) - 1, 1 << (precision - 1)
    if reversible:
        values = plane.astype(np.int64)
    else:
        plane = plane.astype(np.float32)
        values = np.rint(np.clip(plane, -2.0 ** 31, 2.0 ** 31)).astype(np.int64)
        values = np.where(plane > np.float32(2 ** 31 - 1), high - offset, values)
        values = np.where(plane < np.float32(-2 ** 31), low - offset, values)
    return np.clip(values + offset, low, high)
