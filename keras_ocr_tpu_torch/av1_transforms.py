"""AV1's dequantisation and inverse transforms (AV1 specification, sections
7.12.3 and 7.13), for :mod:`.av1`.

Each 1-D transform is written once, as the specification's butterfly steps
(``B`` rotations by ``cos128`` / ``sin128`` rounded to 12 bits, ``H``
sums and differences), and runs on a numpy ``int64`` array that holds
every row (then every column) of a transform block at once. The steps of a
stage act on disjoint pairs, so each stage is one gather and one scatter.
The intra transform sets have no flipped ADST and no 32-point identity, so
neither is built.
"""

from __future__ import annotations

import functools

import numpy as np

from . import av1_tables as T

DCT, ADST, IDENTITY = 0, 1, 2
# TxType -> (column transform, row transform): DCT_DCT, ADST_DCT, DCT_ADST,
# ADST_ADST, then IDTX, V_DCT and H_DCT; the flipped types are inter only.
TX_TYPE_KINDS = {0: (DCT, DCT), 1: (ADST, DCT), 2: (DCT, ADST), 3: (ADST, ADST),
                 9: (IDENTITY, IDENTITY), 10: (DCT, IDENTITY), 11: (IDENTITY, DCT)}


def cos128(angle: int) -> int:
    angle &= 255
    if angle <= 64:
        return T.COS128[angle]
    if angle <= 128:
        return -T.COS128[128 - angle]
    if angle <= 192:
        return -T.COS128[angle - 128]
    return T.COS128[256 - angle]


def sin128(angle: int) -> int:
    return cos128(angle - 64)


def _brev(bits: int, x: int) -> int:
    return int(f"{x:0{bits}b}"[::-1], 2) if bits else 0


class _Program:
    """A list of stages, each ("B", a, b, cos, sin, flip) or ("H", a, b)
    over index arrays, built from the specification's calls."""

    def __init__(self):
        self.stages = []

    def b(self, calls):
        a, b, c, s, flip = (np.array(v) for v in zip(*[(a, b, cos128(ang), sin128(ang), fl)
                                                       for a, b, ang, fl in calls]))
        assert len(set(a) | set(b)) == 2 * len(a)
        # B(a, b, angle, 1) is B(a, b, angle, 0) with T[a] and T[b] exchanged.
        self.stages.append(("B", a, b, c[:, None], s[:, None], np.where(flip, b, a),
                            np.where(flip, a, b)))

    def h(self, calls):
        # H(a, b, 1) is H(b, a, 0).
        a = np.array([b if fl else a for a, b, fl in calls])
        b = np.array([a if fl else b for a, b, fl in calls])
        assert len(set(a) | set(b)) == 2 * len(a)
        self.stages.append(("H", a, b))

    def run(self, t: np.ndarray) -> np.ndarray:
        for stage in self.stages:
            if stage[0] == "B":
                _, a, b, c, s, ta, tb = stage
                x, y = t[a], t[b]
                t[ta] = (x * c - y * s + 2048) >> 12
                t[tb] = (x * s + y * c + 2048) >> 12
            else:
                _, a, b = stage
                x, y = t[a], t[b]
                t[a] = x + y
                t[b] = x - y
        return t


@functools.lru_cache(maxsize=None)
def _dct_program(n: int) -> tuple:
    """The inverse DCT of 2^n points (section 7.13.2.3): the input
    permutation and the butterfly stages."""
    p = _Program()
    r4 = range(4)
    if n == 6:
        p.b([(32 + i, 63 - i, 63 - 4 * _brev(4, i), 0) for i in range(16)])
    if n >= 5:
        p.b([(16 + i, 31 - i, 6 + (_brev(3, 7 - i) << 3), 0) for i in range(8)])
    if n == 6:
        p.h([(32 + i * 2, 33 + i * 2, i & 1) for i in range(16)])
    if n >= 4:
        p.b([(8 + i, 15 - i, 12 + (_brev(2, 3 - i) << 4), 0) for i in range(4)])
    if n >= 5:
        p.h([(16 + 2 * i, 17 + 2 * i, i & 1) for i in range(8)])
    if n == 6:
        p.b([(62 - i * 4 - j, 33 + i * 4 + j, 60 - 16 * _brev(2, i) + 64 * j, 1)
             for i in r4 for j in range(2)])
    if n >= 3:
        p.b([(4 + i, 7 - i, 56 - 32 * i, 0) for i in range(2)])
    if n >= 4:
        p.h([(8 + 2 * i, 9 + 2 * i, i & 1) for i in r4])
    if n >= 5:
        p.b([(30 - 4 * i - j, 17 + 4 * i + j, 24 + (j << 6) + ((1 - i) << 5), 1)
             for i in range(2) for j in range(2)])
    if n == 6:
        p.h([(32 + i * 4 + j, 35 + i * 4 - j, i & 1) for i in range(8) for j in range(2)])
    p.b([(2 * i, 2 * i + 1, 32 + 16 * i, 1 - i) for i in range(2)])
    if n >= 3:
        p.h([(4 + 2 * i, 5 + 2 * i, i) for i in range(2)])
    if n >= 4:
        p.b([(14 - i, 9 + i, 48 + 64 * i, 1) for i in range(2)])
    if n >= 5:
        p.h([(16 + 4 * i + j, 19 + 4 * i - j, i & 1) for i in r4 for j in range(2)])
    if n == 6:
        p.b([(61 - i * 8 - j, 34 + i * 8 + j, 56 - i * 32 + (j >> 1) * 64, 1)
             for i in range(2) for j in r4])
    p.h([(i, 3 - i, 0) for i in range(2)])
    if n >= 3:
        p.b([(6, 5, 32, 1)])
    if n >= 4:
        p.h([(8 + 4 * i + j, 11 + 4 * i - j, i) for i in range(2) for j in range(2)])
    if n >= 5:
        p.b([(29 - i * 2 - j, 18 + i * 2 + j, 48 + (i << 6), 1)
             for i in range(2) for j in range(2)])
    if n == 6:
        p.h([(32 + 8 * i + j, 39 + 8 * i - j, i & 1) for i in r4 for j in r4])
    if n >= 3:
        p.h([(i, 7 - i, 0) for i in r4])
    if n >= 4:
        p.b([(13 - i, 10 + i, 32, 1) for i in range(2)])
    if n >= 5:
        p.h([(16 + i * 8 + j, 23 + i * 8 - j, i) for i in range(2) for j in r4])
    if n == 6:
        p.b([(59 - i, 36 + i, 48 if i < 4 else 112, 1) for i in range(8)])
    if n >= 4:
        p.h([(i, 15 - i, 0) for i in range(8)])
    if n >= 5:
        p.b([(27 - i, 20 + i, 32, 1) for i in r4])
    if n == 6:
        p.h([(32 + i, 47 - i, 0) for i in range(8)] + [(48 + i, 63 - i, 1) for i in range(8)])
    if n >= 5:
        p.h([(i, 31 - i, 0) for i in range(16)])
    if n == 6:
        p.b([(55 - i, 40 + i, 32, 1) for i in range(8)])
    if n == 6:
        p.h([(i, 63 - i, 0) for i in range(32)])
    return np.array([_brev(n, i) for i in range(1 << n)]), p


@functools.lru_cache(maxsize=None)
def _adst_program(n: int) -> tuple:
    """The inverse ADST of 8 or 16 points (sections 7.13.2.6-8): the input
    permutation, the stages, and the output permutation with its signs."""
    size = 1 << n
    p = _Program()
    if n == 3:
        p.b([(2 * i, 2 * i + 1, 60 - 16 * i, 1) for i in range(4)])
        p.h([(i, 4 + i, 0) for i in range(4)])
        p.b([(4 + 3 * i, 5 + i, 48 - 32 * i, 1) for i in range(2)])
        p.h([(4 * j + i, 2 + 4 * j + i, 0) for i in range(2) for j in range(2)])
        p.b([(2 + 4 * i, 3 + 4 * i, 32, 1) for i in range(2)])
    else:
        p.b([(2 * i, 2 * i + 1, 62 - 8 * i, 1) for i in range(8)])
        p.h([(i, 8 + i, 0) for i in range(8)])
        p.b([(8 + 2 * i, 9 + 2 * i, 56 - 32 * i, 1) for i in range(2)]
            + [(13 + 2 * i, 12 + 2 * i, 8 + 32 * i, 1) for i in range(2)])
        p.h([(8 * j + i, 4 + 8 * j + i, 0) for i in range(4) for j in range(2)])
        p.b([(4 + 8 * j + 3 * i, 5 + 8 * j + i, 48 - 32 * i, 1)
             for i in range(2) for j in range(2)])
        p.h([(4 * j + i, 2 + 4 * j + i, 0) for i in range(2) for j in range(4)])
        p.b([(2 + 4 * i, 3 + 4 * i, 32, 1) for i in range(4)])
    inp = np.array([i - 1 if i & 1 else size - i - 1 for i in range(size)])
    out = np.array([_brev(n, i ^ (i >> 1)) for i in range(size)])
    sign = np.array([-1 if i & 1 else 1 for i in range(size)])[:, None]
    return inp, p, out, sign


def _adst4(t: np.ndarray) -> np.ndarray:
    """Section 7.13.2.5, on rows of 4."""
    s1, s2, s3, s4 = T.SINPI[1:]
    x0, x1, x2, x3 = t
    a0 = s1 * x0 + s4 * x2 + s2 * x3
    a1 = s2 * x0 - s1 * x2 - s4 * x3
    a3 = s3 * x1
    out = np.empty_like(t)
    out[0] = (a0 + a3 + 2048) >> 12
    out[1] = (a1 + a3 + 2048) >> 12
    out[2] = (s3 * (x0 - x2 + x3) + 2048) >> 12
    out[3] = (a0 + a1 - a3 + 2048) >> 12
    return out


def inverse_1d(t: np.ndarray, n: int, kind: int) -> np.ndarray:
    """The inverse transform of 2^n points of each column of ``t`` (an
    int64 array of shape (2^n, batch)); returns the result."""
    if kind == IDENTITY:
        if n == 2:
            return (t * 5793 + 2048) >> 12
        if n == 3:
            return t * 2
        return (t * 11586 + 2048) >> 12
    if kind == ADST:
        if n == 2:
            return _adst4(t)
        inp, program, out, sign = _adst_program(n)
        return program.run(t[inp].copy())[out] * sign
    perm, program = _dct_program(n)
    return program.run(t[perm].copy())


TX_ROW_SHIFT = {(4, 4): 0, (8, 8): 1, (16, 16): 2, (32, 32): 2, (64, 64): 2, (4, 8): 0, (8, 4): 0,
                (8, 16): 1, (16, 8): 1, (16, 32): 1, (32, 16): 1, (32, 64): 1, (64, 32): 1,
                (4, 16): 1, (16, 4): 1, (8, 32): 2, (32, 8): 2, (16, 64): 2, (64, 16): 2}


def dequantise(quant: np.ndarray, dc_q: int, ac_q: int, w: int, h: int) -> np.ndarray:
    """Section 7.12.3 without quantiser matrices: the coded levels (the
    top-left min(w, 32) x min(h, 32), as an int64 array) times their
    quantiser, the magnitude masked to 24 bits, divided by 2 for 512 and
    1024 coefficients and by 4 for more, clamped to 16 bits."""
    q = np.full(quant.shape, ac_q, np.int64)
    q[0, 0] = dc_q
    shift = (w * h > 256) + (w * h > 1024)
    mag = ((np.abs(quant) * q) & 0xFFFFFF) >> shift
    return np.where(quant < 0, -np.minimum(mag, 1 << 15), np.minimum(mag, (1 << 15) - 1))


def inverse_transform_2d(coef: np.ndarray, w: int, h: int, tx_type: int) -> np.ndarray:
    """Section 7.13.3 at bit depth 8: the residual (h x w int64) of the
    dequantised coefficients ``coef`` (min(h, 32) x min(w, 32))."""
    col_kind, row_kind = TX_TYPE_KINDS[tx_type]
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    rows = min(h, 32)
    x = np.zeros((rows, w), np.int64)
    x[:, :min(w, 32)] = coef
    if abs(log2w - log2h) == 1:
        x = (x * 2896 + 2048) >> 12
    x = np.clip(x, -(1 << 15), (1 << 15) - 1)
    shift = TX_ROW_SHIFT[(w, h)]
    x = inverse_1d(x.T.copy(), log2w, row_kind).T
    if shift:
        x = (x + (1 << (shift - 1))) >> shift
    full = np.zeros((h, w), np.int64)
    full[:rows] = np.clip(x, -(1 << 15), (1 << 15) - 1)
    return (inverse_1d(full, log2h, col_kind) + 8) >> 4
