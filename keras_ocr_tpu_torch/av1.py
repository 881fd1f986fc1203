"""A decoder of AV1 intra frames, lossless and lossy, for :mod:`.avif`.

It reads what Pillow's AVIF writer makes: at ``quality=100`` libavif asks
aom for lossless coding (``base_q_idx`` 0, every transform block 4x4 with
the Walsh-Hadamard transform, no loop filter); below that the frame is
lossy. The decoder covers the OBU stream (temporal delimiter, sequence
header, frame header, tile groups), the symbol decoder with CDF
adaptation, partitions from 128x128 to 4x4, intra mode info (y / uv
modes, angle deltas, CFL alphas, palette with its colour cache and
colour-index map, filter intra, segment ids, CDEF indices), the transform
size (``tx_depth``) and intra transform type, the coefficients of every
transform size from 4x4 to 64x64 at the four q contexts, and every intra
predictor of the specification at every transform size: DC, V, H, the six
directional ones with edge filter and upsampling, the three smooth ones,
Paeth, CFL, filter intra and palette, for 4:4:4, 4:2:2, 4:2:0 and 4:0:0.
Dequantisation and the inverse DCT, ADST and identity transforms are
:mod:`.av1_transforms`; deblocking and CDEF, after the last tile, are
:mod:`.av1_filters`.

What it refuses raises ``NotImplementedError`` naming it: loop
restoration used by a plane, quantiser matrices, ``delta_q_present``
(delta q and delta lf), ``allow_intrabc``, bit depths above 8, film grain
to apply, superres, and frames other than intra frames. A stream that
breaks the syntax raises ``ValueError``.

The names follow the AV1 specification (AV1 Bitstream & Decoding Process
Specification, sections 5-7); the tables are :mod:`.av1_tables`.
"""

from __future__ import annotations

import functools

import numpy as np

from . import av1_filters
from . import av1_tables as T
from . import av1_transforms as X

# The OBU types read; the others (temporal delimiter, metadata, padding,
# ...) are skipped.
OBU_SEQUENCE_HEADER, OBU_FRAME_HEADER, OBU_TILE_GROUP, OBU_FRAME = 1, 3, 4, 6
KEY_FRAME, INTRA_ONLY_FRAME = 0, 2

DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED = range(9)
SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED = 9, 10, 11, 12
UV_CFL_PRED = 13
SMOOTH_MODES = (SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED)
INTRA_MODE_CONTEXT = (0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0)

(PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A,
 PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_HORZ_4,
 PARTITION_VERT_4) = range(10)

# Block sizes in the specification's order, as (width, height) in pixels.
BLOCK_DIMS = ((4, 4), (4, 8), (8, 4), (8, 8), (8, 16), (16, 8), (16, 16), (16, 32), (32, 16),
              (32, 32), (32, 64), (64, 32), (64, 64), (64, 128), (128, 64), (128, 128),
              (4, 16), (16, 4), (8, 32), (32, 8), (16, 64), (64, 16))
BLOCK_OF_DIMS = {dims: size for size, dims in enumerate(BLOCK_DIMS)}
BLOCK_4X4, BLOCK_8X8, BLOCK_64X64, BLOCK_128X128 = 0, 3, 12, 15
LOG2 = {1: 0, 2: 1, 4: 2, 8: 3, 16: 4, 32: 5, 64: 6, 128: 7}

# Segmentation features: bits, signed, limit.
SEG_FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEG_FEATURE_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
SEG_FEATURE_MAX = (255, 63, 63, 63, 63, 7, 0, 0)


def _partition_subsize(partition: int, bsize: int) -> int:
    w, h = BLOCK_DIMS[bsize]
    if partition == PARTITION_NONE:
        return bsize
    if partition in (PARTITION_HORZ, PARTITION_HORZ_A, PARTITION_HORZ_B):
        return BLOCK_OF_DIMS[(w, h // 2)]
    if partition in (PARTITION_VERT, PARTITION_VERT_A, PARTITION_VERT_B):
        return BLOCK_OF_DIMS[(w // 2, h)]
    if partition == PARTITION_SPLIT:
        return BLOCK_OF_DIMS[(w // 2, h // 2)]
    if partition == PARTITION_HORZ_4:
        return BLOCK_OF_DIMS[(w, h // 4)]
    return BLOCK_OF_DIMS[(w // 4, h)]


def _residual_size(bsize: int, subx: int, suby: int):
    """get_plane_residual_size: the chroma block of ``bsize``, or None where
    the subsampling makes it invalid."""
    w, h = BLOCK_DIMS[bsize]
    if subx and not suby and w < h:
        return None  # Subsampled_Size's BLOCK_INVALID entries of 4:2:2
    return BLOCK_OF_DIMS[(max(4, w >> subx), max(4, h >> suby))]


class BitReader:
    """MSB-first reader of a header's bits (the f(n), su(n), ns(n), le(n)
    and leb128() descriptors)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos * 8

    def f(self, n: int) -> int:
        value = 0
        for _ in range(n):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise ValueError("AV1 header runs past the end of its OBU")
            value = (value << 1) | ((self.data[byte] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return value

    def su(self, n: int) -> int:
        value = self.f(n)
        sign = 1 << (n - 1)
        return value - 2 * sign if value & sign else value

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        return v if v < m else (v << 1) - m + self.f(1)

    def uvlc(self) -> int:
        zeros = 0
        while not self.f(1):
            zeros += 1
            if zeros >= 32:
                return (1 << 32) - 1
        return self.f(zeros) + (1 << zeros) - 1

    def byte_alignment(self) -> None:
        while self.pos & 7:
            self.f(1)

    @property
    def byte_pos(self) -> int:
        return (self.pos + 7) >> 3


def leb128(data: bytes, pos: int):
    value = 0
    for i in range(8):
        if pos + i >= len(data):
            raise ValueError("AV1 OBU size runs past the end of the data")
        byte = data[pos + i]
        value |= (byte & 0x7F) << (7 * i)
        if not byte & 0x80:
            return value, pos + i + 1
    return value, pos + 8


class SymbolDecoder:
    """The symbol decoder of section 8.2: ``read_symbol`` with CDF
    adaptation, ``read_bool`` and ``read_literal``. The bits still to come
    wait in ``window`` as the spec's SymbolValue followed by ``ahead``
    inverted lookahead bits; bytes past the tile's end read as zeros."""

    def __init__(self, data: bytes, start: int, size: int, update: bool):
        if size < 1 or start + size > len(data):
            raise ValueError("AV1 tile runs past the end of its tile group")
        # The tile's bytes inverted, then inverted zeros to read past its end.
        self.inv = (int.from_bytes(data[start:start + size], "big") ^ ((1 << (8 * size)) - 1)
                    ).to_bytes(size, "big") + b"\xff" * 4096
        self.next = 0
        self.update = update
        self.window = 0
        self.ahead = -15
        self._refill()
        self.rng = 1 << 15

    def _refill(self) -> None:
        nxt = self.next
        if nxt + 6 > len(self.inv):
            self.inv += b"\xff" * 4096
        self.window = (self.window << 48) | int.from_bytes(self.inv[nxt:nxt + 6], "big")
        self.next = nxt + 6
        self.ahead += 48

    def symbol(self, cdf: list) -> int:
        n = len(cdf) - 1
        rng = self.rng
        ahead = self.ahead
        value = self.window >> ahead
        r8 = rng >> 8
        prev = rng
        cur = ((r8 * ((32768 - cdf[0]) >> 6)) >> 1) + 4 * (n - 1)
        sym = 0
        while value < cur:
            sym += 1
            prev = cur
            cur = ((r8 * ((32768 - cdf[sym]) >> 6)) >> 1) + 4 * (n - sym - 1)
        rng = prev - cur
        self.window -= cur << ahead
        bits = 16 - rng.bit_length()
        self.rng = rng << bits
        ahead -= bits
        self.ahead = ahead
        if ahead < 16:
            self._refill()
        if self.update:
            count = cdf[n]
            rate = 3 + (count > 15) + (count > 31) + (2 if n > 3 else 1)
            for i in range(sym):
                cdf[i] -= cdf[i] >> rate
            for i in range(sym, n - 1):
                cdf[i] += (32768 - cdf[i]) >> rate
            if count < 32:
                cdf[n] = count + 1
        return sym

    def bool_p(self, cut: int) -> int:
        """A symbol of two whose first symbol has probability ``cut`` /
        32768, with no adaptation (the partition's derived CDFs)."""
        rng = self.rng
        ahead = self.ahead
        cur = (((rng >> 8) * ((32768 - cut) >> 6)) >> 1) + 4
        if self.window >> ahead >= cur:
            bit = 0
            rng -= cur
            self.window -= cur << ahead
        else:
            bit = 1
            rng = cur
        bits = 16 - rng.bit_length()
        self.rng = rng << bits
        ahead -= bits
        self.ahead = ahead
        if ahead < 16:
            self._refill()
        return bit

    def literal(self, n: int) -> int:
        """read_literal: ``n`` bits of even odds (read_bool), MSB first."""
        value = 0
        for _ in range(n):
            rng = self.rng
            ahead = self.ahead
            cur = ((rng >> 8) << 7) + 4
            if self.window >> ahead >= cur:
                value <<= 1
                rng -= cur
                self.window -= cur << ahead
            else:
                value = (value << 1) | 1
                rng = cur
            bits = 16 - rng.bit_length()
            self.rng = rng << bits
            ahead -= bits
            self.ahead = ahead
            if ahead < 16:
                self._refill()
        return value

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.literal(w - 1)
        return v if v < m else (v << 1) - m + self.literal(1)


def _cdfs(table):
    """A deep copy of a spec-form table with a 0 counter after each row."""
    if isinstance(table[0], int):
        return list(table) + [0]
    return [_cdfs(row) for row in table]


def default_cdfs(q_ctx: int = 0) -> dict:
    """The CDFs a tile starts from; the coefficients' by the frame's q
    context (base_q_idx up to 20, 60, 120, or above)."""
    return {
        "kf_y_mode": _cdfs(T.KF_Y_MODE_CDF),
        "uv_mode": _cdfs(T.UV_MODE_CDF),
        "angle_delta": _cdfs(T.ANGLE_DELTA_CDF),
        "partition": _cdfs(T.PARTITION_CDF),
        "cfl_alpha": _cdfs(T.CFL_ALPHA_CDF),
        "cfl_sign": _cdfs(T.CFL_SIGN_CDF),
        "filter_intra": _cdfs(T.FILTER_INTRA_CDF),
        "filter_intra_mode": _cdfs(T.FILTER_INTRA_MODE_CDF),
        "skip": _cdfs(T.SKIP_CDF),
        "intrabc": _cdfs(T.INTRABC_CDF),
        "segment_id": _cdfs(T.SEGMENT_ID_CDF),
        "palette_y_mode": _cdfs(T.PALETTE_Y_MODE_CDF),
        "palette_uv_mode": _cdfs(T.PALETTE_UV_MODE_CDF),
        "palette_y_size": _cdfs(T.PALETTE_Y_SIZE_CDF),
        "palette_uv_size": _cdfs(T.PALETTE_UV_SIZE_CDF),
        "palette_color": [_cdfs(T.PALETTE_Y_COLOR_CDF), _cdfs(T.PALETTE_UV_COLOR_CDF)],
        "tx_depth": _cdfs(T.TX_DEPTH_CDF),
        "intra_tx_type": [None, _cdfs(T.INTRA_TX_TYPE_SET1_CDF),
                          _cdfs(T.INTRA_TX_TYPE_SET2_CDF)],
        "txb_skip": _cdfs(T.TXB_SKIP_CDF[q_ctx]),
        "eob_pt": [_cdfs(table[q_ctx]) for table in (
            T.EOB_PT_16_CDF, T.EOB_PT_32_CDF, T.EOB_PT_64_CDF, T.EOB_PT_128_CDF,
            T.EOB_PT_256_CDF, T.EOB_PT_512_CDF, T.EOB_PT_1024_CDF)],
        "eob_extra": _cdfs(T.EOB_EXTRA_CDF[q_ctx]),
        "coeff_base_eob": _cdfs(T.COEFF_BASE_EOB_CDF[q_ctx]),
        "coeff_base": _cdfs(T.COEFF_BASE_CDF[q_ctx]),
        "coeff_br": _cdfs(T.COEFF_BR_CDF[q_ctx]),
        "dc_sign": _cdfs(T.DC_SIGN_CDF[q_ctx]),
    }


class SequenceHeader:
    def __init__(self, data: bytes):
        r = BitReader(data)
        self.profile = r.f(3)
        if self.profile > 2:
            raise ValueError(f"AV1 seq_profile {self.profile} is reserved")
        self.still_picture = r.f(1)
        self.reduced = r.f(1)
        self.decoder_model_info = 0
        self.equal_picture_interval = 0
        self.frame_presentation_length = 0
        self.buffer_removal_length = 0
        self.op_idc = [0]
        self.decoder_model_for_op = [0]
        if self.reduced:
            r.f(5)
        else:
            if r.f(1):  # timing_info_present_flag
                r.f(32)
                r.f(32)
                self.equal_picture_interval = r.f(1)
                if self.equal_picture_interval:
                    r.uvlc()
                self.decoder_model_info = r.f(1)
                if self.decoder_model_info:
                    buffer_delay_length = r.f(5) + 1
                    r.f(32)
                    self.buffer_removal_length = r.f(5) + 1
                    self.frame_presentation_length = r.f(5) + 1
            initial_display_delay = r.f(1)
            count = r.f(5) + 1
            self.op_idc, self.decoder_model_for_op = [], []
            for _ in range(count):
                self.op_idc.append(r.f(12))
                if r.f(5) > 7:
                    r.f(1)
                present = 0
                if self.decoder_model_info:
                    present = r.f(1)
                    if present:
                        r.f(buffer_delay_length)
                        r.f(buffer_delay_length)
                        r.f(1)
                self.decoder_model_for_op.append(present)
                if initial_display_delay and r.f(1):
                    r.f(4)
        width_bits = r.f(4) + 1
        height_bits = r.f(4) + 1
        self.width_bits, self.height_bits = width_bits, height_bits
        self.max_width = r.f(width_bits) + 1
        self.max_height = r.f(height_bits) + 1
        self.frame_id_numbers = 0 if self.reduced else r.f(1)
        if self.frame_id_numbers:
            self.delta_frame_id_length = r.f(4) + 2
            self.frame_id_length = r.f(3) + 1 + self.delta_frame_id_length
        self.use_128 = r.f(1)
        self.enable_filter_intra = r.f(1)
        self.enable_intra_edge_filter = r.f(1)
        self.force_screen_content_tools = 2
        self.force_integer_mv = 2
        self.order_hint_bits = 0
        self.enable_warped_motion = 0
        if not self.reduced:
            r.f(1)  # enable_interintra_compound
            r.f(1)  # enable_masked_compound
            self.enable_warped_motion = r.f(1)
            r.f(1)  # enable_dual_filter
            enable_order_hint = r.f(1)
            if enable_order_hint:
                r.f(1)  # enable_jnt_comp
                r.f(1)  # enable_ref_frame_mvs
            if r.f(1):  # seq_choose_screen_content_tools
                self.force_screen_content_tools = 2
            else:
                self.force_screen_content_tools = r.f(1)
            if self.force_screen_content_tools > 0:
                self.force_integer_mv = 2 if r.f(1) else r.f(1)
            if enable_order_hint:
                self.order_hint_bits = r.f(3) + 1
        self.enable_superres = r.f(1)
        self.enable_cdef = r.f(1)
        self.enable_restoration = r.f(1)
        self._color_config(r)
        self.film_grain_params_present = r.f(1)

    def _color_config(self, r: BitReader) -> None:
        high_bitdepth = r.f(1)
        if self.profile == 2 and high_bitdepth:
            self.bit_depth = 12 if r.f(1) else 10
        else:
            self.bit_depth = 10 if high_bitdepth else 8
        self.mono_chrome = 0 if self.profile == 1 else r.f(1)
        self.num_planes = 1 if self.mono_chrome else 3
        self.color_primaries = self.transfer_characteristics = self.matrix_coefficients = 2
        if r.f(1):
            self.color_primaries = r.f(8)
            self.transfer_characteristics = r.f(8)
            self.matrix_coefficients = r.f(8)
        if self.mono_chrome:
            self.color_range = r.f(1)
            self.subx = self.suby = 1
            self.separate_uv_delta_q = 0
            return
        if (self.color_primaries, self.transfer_characteristics,
                self.matrix_coefficients) == (1, 13, 0):
            self.color_range = 1
            self.subx = self.suby = 0
        else:
            self.color_range = r.f(1)
            if self.profile == 0:
                self.subx = self.suby = 1
            elif self.profile == 1:
                self.subx = self.suby = 0
            elif self.bit_depth == 12:
                self.subx = r.f(1)
                self.suby = r.f(1) if self.subx else 0
            else:
                self.subx, self.suby = 1, 0
            if self.subx and self.suby:
                r.f(2)  # chroma_sample_position
        self.separate_uv_delta_q = r.f(1)


class Frame:
    """One intra frame: its header, then its tiles decoded into planes."""

    def __init__(self, seq: SequenceHeader, data: bytes, pos: int, temporal_id: int,
                 spatial_id: int, seen: set):
        self.seq = seq
        self.seen = seen
        r = BitReader(data, pos)
        self._uncompressed_header(r, temporal_id, spatial_id)
        self.header_end = r
        self._allocate()

    # -- frame header ------------------------------------------------------

    def _uncompressed_header(self, r: BitReader, temporal_id: int, spatial_id: int) -> None:
        seq = self.seq
        if seq.reduced:
            frame_type, show_frame, showable, error_resilient = KEY_FRAME, 1, 0, 1
        else:
            if r.f(1):
                raise NotImplementedError("AV1 show_existing_frame: frames other than intra "
                                          "frames")
            frame_type = r.f(2)
            if frame_type not in (KEY_FRAME, INTRA_ONLY_FRAME):
                raise NotImplementedError("AV1 inter frames: frames other than intra frames")
            show_frame = r.f(1)
            if show_frame and seq.decoder_model_info and not seq.equal_picture_interval:
                r.f(seq.frame_presentation_length)
            showable = frame_type != KEY_FRAME if show_frame else r.f(1)
            error_resilient = 1
            if not (frame_type == KEY_FRAME and show_frame):
                error_resilient = r.f(1)
        self.frame_type, self.show_frame, self.showable = frame_type, show_frame, showable
        self.disable_cdf_update = r.f(1)
        if seq.force_screen_content_tools == 2:
            self.allow_screen_content_tools = r.f(1)
        else:
            self.allow_screen_content_tools = seq.force_screen_content_tools
        if self.allow_screen_content_tools and seq.force_integer_mv == 2:
            r.f(1)  # force_integer_mv
        if seq.frame_id_numbers:
            r.f(seq.frame_id_length)
        frame_size_override = 0 if seq.reduced else r.f(1)
        r.f(seq.order_hint_bits)
        if seq.decoder_model_info:
            if r.f(1):  # buffer_removal_time_present_flag
                for idc, present in zip(seq.op_idc, seq.decoder_model_for_op):
                    if present:
                        in_temporal = (idc >> temporal_id) & 1
                        in_spatial = (idc >> (spatial_id + 8)) & 1
                        if idc == 0 or (in_temporal and in_spatial):
                            r.f(seq.buffer_removal_length)
        if not (frame_type == KEY_FRAME and show_frame):
            if r.f(8) != 0xFF and error_resilient and seq.order_hint_bits:
                for _ in range(8):
                    r.f(seq.order_hint_bits)  # ref_order_hint
        # frame_size, superres_params, render_size
        if frame_size_override:
            self.width = r.f(seq.width_bits) + 1
            self.height = r.f(seq.height_bits) + 1
        else:
            self.width, self.height = seq.max_width, seq.max_height
        if seq.enable_superres and r.f(1):
            raise NotImplementedError("AV1 superres")
        self.mi_cols = 2 * ((self.width + 7) >> 3)
        self.mi_rows = 2 * ((self.height + 7) >> 3)
        if r.f(1):  # render_and_frame_size_different
            r.f(16)
            r.f(16)
        self.allow_intrabc = 0
        if self.allow_screen_content_tools:
            self.allow_intrabc = r.f(1)
        if self.allow_intrabc:
            raise NotImplementedError("AV1 allow_intrabc (intra block copy)")
        if not seq.reduced and not self.disable_cdf_update:
            r.f(1)  # disable_frame_end_update_cdf
        self._tile_info(r)
        self._quantization_params(r)
        self._segmentation_params(r)
        # delta_q_params (delta_lf_params reads only after a delta_q_present).
        if self.base_q_idx > 0 and r.f(1):
            raise NotImplementedError("AV1 delta_q_present (delta q / delta lf): next AVIF PR")
        self.qindex = [self._qidx(segment) for segment in range(8)]
        self.lossless = [q == 0 and not any(self.delta_q) for q in self.qindex]
        self.coded_lossless = all(self.lossless)
        if self.using_qmatrix and not self.coded_lossless:
            raise NotImplementedError("AV1 using_qmatrix (quantiser matrices): next AVIF PR")
        # (dc, ac) quantiser of each plane of each segment; Y's AC has no delta.
        dq = self.delta_q + [0] * (5 - len(self.delta_q))
        self.quantisers = [[(T.DC_QLOOKUP[min(255, max(0, q + dc))],
                             T.AC_QLOOKUP[min(255, max(0, q + ac))])
                            for dc, ac in ((dq[0], 0), (dq[1], dq[2]), (dq[3], dq[4]))]
                           for q in self.qindex]
        self._loop_filter_params(r)
        self._cdef_params(r)
        self._lr_params(r)
        # read_tx_mode; an intra frame reads no reference mode, skip mode or
        # warped motion.
        self.tx_mode_select = 0 if self.coded_lossless else r.f(1)
        self.reduced_tx_set = r.f(1)
        if seq.film_grain_params_present and (show_frame or showable):
            if r.f(1):  # apply_grain
                raise NotImplementedError("AV1 film grain")

    def _qidx(self, segment: int) -> int:
        """get_qidx(1, segment)."""
        if self.feature_enabled[segment][0]:
            return min(255, max(0, self.base_q_idx + self.feature_data[segment][0]))
        return self.base_q_idx

    def _loop_filter_params(self, r: BitReader) -> None:
        # setup_past_independence's deltas: INTRA_FRAME 1, LAST 0, ... ; an
        # intra frame's blocks read only the first.
        self.lf_levels = [0, 0, 0, 0]
        self.lf_sharpness = 0
        self.lf_ref_delta = 1
        self.lf_delta_enabled = 0
        if self.coded_lossless:
            return
        self.lf_levels[0] = r.f(6)
        self.lf_levels[1] = r.f(6)
        if self.seq.num_planes > 1 and (self.lf_levels[0] or self.lf_levels[1]):
            self.lf_levels[2] = r.f(6)
            self.lf_levels[3] = r.f(6)
        self.lf_sharpness = r.f(3)
        self.lf_delta_enabled = r.f(1)
        if self.lf_delta_enabled and r.f(1):  # loop_filter_delta_update
            for ref in range(8):
                if r.f(1):
                    delta = r.su(7)
                    if ref == 0:
                        self.lf_ref_delta = delta
            for _ in range(2):
                if r.f(1):
                    r.su(7)  # loop_filter_mode_deltas: inter blocks only

    def _cdef_params(self, r: BitReader) -> None:
        self.cdef_on = bool(self.seq.enable_cdef and not self.coded_lossless)
        self.cdef_damping, self.cdef_bits = 3, 0
        self.cdef_strengths = [(0, 0, 0, 0)]
        if not self.cdef_on:
            return
        self.cdef_damping = r.f(2) + 3
        self.cdef_bits = r.f(2)
        self.cdef_strengths = []
        for _ in range(1 << self.cdef_bits):
            y_pri, y_sec = r.f(4), r.f(2)
            uv_pri = uv_sec = 0
            if self.seq.num_planes > 1:
                uv_pri, uv_sec = r.f(4), r.f(2)
            # A secondary strength of 3 means 4.
            self.cdef_strengths.append((y_pri, y_sec + (y_sec == 3), uv_pri,
                                        uv_sec + (uv_sec == 3)))

    def _lr_params(self, r: BitReader) -> None:
        if self.coded_lossless or not self.seq.enable_restoration:
            return
        for plane in range(self.seq.num_planes):
            if r.f(2):  # lr_type: RESTORE_NONE is 0
                raise NotImplementedError(
                    f"AV1 loop restoration (Wiener / self-guided filter on plane {plane}): "
                    "next AVIF PR")
        self.seen.add("restoration enabled, used by no plane")

    def _tile_info(self, r: BitReader) -> None:
        seq = self.seq
        sb_shift = 5 if seq.use_128 else 4
        sb_cols = (self.mi_cols + (1 << sb_shift) - 1) >> sb_shift
        sb_rows = (self.mi_rows + (1 << sb_shift) - 1) >> sb_shift
        sb_size = sb_shift + 2
        max_tile_width_sb = 4096 >> sb_size
        max_tile_area_sb = (4096 * 2304) >> (2 * sb_size)

        def tile_log2(blk, target):
            k = 0
            while (blk << k) < target:
                k += 1
            return k

        min_log2_cols = tile_log2(max_tile_width_sb, sb_cols)
        max_log2_cols = tile_log2(1, min(sb_cols, 64))
        max_log2_rows = tile_log2(1, min(sb_rows, 64))
        min_log2_tiles = max(min_log2_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols))
        cols, rows = [], []
        if r.f(1):  # uniform_tile_spacing_flag
            cols_log2 = min_log2_cols
            while cols_log2 < max_log2_cols and r.f(1):
                cols_log2 += 1
            width_sb = (sb_cols + (1 << cols_log2) - 1) >> cols_log2
            cols = [sb << sb_shift for sb in range(0, sb_cols, width_sb)]
            rows_log2 = max(min_log2_tiles - cols_log2, 0)
            while rows_log2 < max_log2_rows and r.f(1):
                rows_log2 += 1
            height_sb = (sb_rows + (1 << rows_log2) - 1) >> rows_log2
            rows = [sb << sb_shift for sb in range(0, sb_rows, height_sb)]
        else:
            widest = 0
            start = 0
            while start < sb_cols:
                cols.append(start << sb_shift)
                size = r.ns(min(sb_cols - start, max_tile_width_sb)) + 1
                widest = max(widest, size)
                start += size
            cols_log2 = tile_log2(1, len(cols))
            area = (sb_rows * sb_cols) >> (min_log2_tiles + 1) if min_log2_tiles else \
                sb_rows * sb_cols
            max_height = max(area // widest, 1)
            start = 0
            while start < sb_rows:
                rows.append(start << sb_shift)
                start += r.ns(min(sb_rows - start, max_height)) + 1
            rows_log2 = tile_log2(1, len(rows))
        self.mi_col_starts = cols + [self.mi_cols]
        self.mi_row_starts = rows + [self.mi_rows]
        self.tile_cols, self.tile_rows = len(cols), len(rows)
        self.tile_cols_log2, self.tile_rows_log2 = cols_log2, rows_log2
        self.tile_size_bytes = 4
        if cols_log2 or rows_log2:
            r.f(rows_log2 + cols_log2)  # context_update_tile_id
            self.tile_size_bytes = r.f(2) + 1

    def _quantization_params(self, r: BitReader) -> None:
        seq = self.seq
        self.base_q_idx = r.f(8)

        def delta_q():
            return r.su(7) if r.f(1) else 0

        deltas = [delta_q()]
        if seq.num_planes > 1:
            diff_uv = r.f(1) if seq.separate_uv_delta_q else 0
            u_dc, u_ac = delta_q(), delta_q()
            deltas += [u_dc, u_ac] + ([delta_q(), delta_q()] if diff_uv else [u_dc, u_ac])
        self.delta_q = deltas
        self.using_qmatrix = r.f(1)
        if self.using_qmatrix:
            r.f(4)
            r.f(4)
            if seq.separate_uv_delta_q:
                r.f(4)

    def _segmentation_params(self, r: BitReader) -> None:
        self.feature_enabled = [[0] * 8 for _ in range(8)]
        self.feature_data = [[0] * 8 for _ in range(8)]
        self.segmentation_enabled = r.f(1)
        if self.segmentation_enabled:
            # primary_ref_frame is PRIMARY_REF_NONE in an intra frame: the
            # map and the data are always updated.
            for i in range(8):
                for j in range(8):
                    if r.f(1):
                        self.feature_enabled[i][j] = 1
                        bits, limit = SEG_FEATURE_BITS[j], SEG_FEATURE_MAX[j]
                        if SEG_FEATURE_SIGNED[j]:
                            value = max(-limit, min(limit, r.su(1 + bits)))
                        else:
                            value = max(0, min(limit, r.f(bits)))
                        self.feature_data[i][j] = value
        self.seg_id_pre_skip = 0
        self.last_active_seg_id = 0
        for i in range(8):
            for j in range(8):
                if self.feature_enabled[i][j]:
                    self.last_active_seg_id = i
                    if j >= 5:
                        self.seg_id_pre_skip = 1

    # -- tiles -------------------------------------------------------------

    def decode_tile_group(self, data: bytes, start: int, end: int) -> bool:
        """Decodes one tile group OBU's tiles; True after the frame's last."""
        r = BitReader(data, start)
        num_tiles = self.tile_cols * self.tile_rows
        tg_start, tg_end = 0, num_tiles - 1
        if num_tiles > 1 and r.f(1):
            bits = self.tile_cols_log2 + self.tile_rows_log2
            tg_start, tg_end = r.f(bits), r.f(bits)
        r.byte_alignment()
        pos = r.byte_pos
        for tile in range(tg_start, tg_end + 1):
            if tile == tg_end:
                size = end - pos
            else:
                if pos + self.tile_size_bytes > end:
                    raise ValueError("AV1 tile size runs past the end of its tile group")
                size = int.from_bytes(data[pos:pos + self.tile_size_bytes], "little") + 1
                pos += self.tile_size_bytes
            if size <= 0 or pos + size > end:
                raise ValueError("AV1 tile runs past the end of its tile group")
            row, col = divmod(tile, self.tile_cols)
            self.seen.add(f"tiles {self.tile_cols}x{self.tile_rows}")
            _TileDecoder(self, SymbolDecoder(data, pos, size, not self.disable_cdf_update),
                         self.mi_row_starts[row], self.mi_row_starts[row + 1],
                         self.mi_col_starts[col], self.mi_col_starts[col + 1]).decode()
            pos += size
        return tg_end == num_tiles - 1

    def _allocate(self) -> None:
        seq = self.seq
        self.planes = []
        for plane in range(seq.num_planes):
            subx = seq.subx if plane else 0
            suby = seq.suby if plane else 0
            # The decoded area, and 64 more rows and columns that transforms
            # reaching past it write to.
            h, w = ((self.mi_rows * 4) >> suby) + 64, ((self.mi_cols * 4) >> subx) + 64
            self.planes.append([[0] * w for _ in range(h)])
        rows, cols = self.mi_rows, self.mi_cols
        self.y_modes = [[DC_PRED] * cols for _ in range(rows)]
        self.uv_modes = [[DC_PRED] * cols for _ in range(rows)]
        self.mi_sizes = [[BLOCK_4X4] * cols for _ in range(rows)]
        self.skips = [[0] * cols for _ in range(rows)]
        self.segment_ids = [[0] * cols for _ in range(rows)]
        self.palette_sizes = [[[0] * cols for _ in range(rows)] for _ in range(2)]
        self.palette_colors = [[[()] * cols for _ in range(rows)] for _ in range(2)]
        # The luma transform size (w, h) of each 4x4 (InterTxSizes); the
        # transform width and height at each 4x4 of each plane
        # (LoopfilterTxSizes), with room for transforms past the frame's
        # edge; the CDEF strength index of each 64x64.
        self.tx_sizes = [[(4, 4)] * cols for _ in range(rows)]
        self.lf_tx = []
        for plane in range(seq.num_planes):
            subx = seq.subx if plane else 0
            suby = seq.suby if plane else 0
            shape = ((rows >> suby) + 32, (cols >> subx) + 32)
            self.lf_tx.append((np.full(shape, 4, np.int32), np.full(shape, 4, np.int32)))
        self.cdef_idx = [[-1] * ((cols >> 4) + 2) for _ in range((rows >> 4) + 2)]

    def output(self) -> list:
        """The planes as uint8 arrays, deblocked and CDEF-filtered where
        the frame says so, cropped to the frame's size."""
        seq = self.seq
        planes = []
        for plane, rows in enumerate(self.planes):
            subx = seq.subx if plane else 0
            suby = seq.suby if plane else 0
            h, w = (self.mi_rows * 4) >> suby, (self.mi_cols * 4) >> subx
            planes.append(np.array([row[:w] for row in rows[:h]], dtype=np.int32))
        if not self.coded_lossless:
            planes = av1_filters.deblock(self, planes)
            if self.cdef_on:
                planes = av1_filters.cdef(self, planes)
        out = []
        for plane, pixels in enumerate(planes):
            subx = seq.subx if plane else 0
            suby = seq.suby if plane else 0
            h = (self.height + suby) >> suby
            w = (self.width + subx) >> subx
            out.append(pixels[:h, :w].astype(np.uint8))
        return out


class _TileDecoder:
    """decode_tile: the blocks of one tile, section 5.11 and 7.11."""

    def __init__(self, frame: Frame, sd: SymbolDecoder, row_start, row_end, col_start, col_end):
        self.f = frame
        self.seq = frame.seq
        self.seen = frame.seen
        self.sd = sd
        q = frame.base_q_idx
        q_ctx = 0 if q <= 20 else 1 if q <= 60 else 2 if q <= 120 else 3
        self.cdf = default_cdfs(q_ctx)
        if not frame.coded_lossless:
            self.seen.add(f"q_ctx {q_ctx}")
        self.row_start, self.row_end = row_start, row_end
        self.col_start, self.col_end = col_start, col_end
        seq = frame.seq
        self.num_planes = seq.num_planes
        self.subx, self.suby = seq.subx, seq.suby
        cols4 = frame.mi_cols + 32
        rows4 = frame.mi_rows + 32
        self.above_level = [[0] * cols4 for _ in range(3)]
        self.above_dc = [[0] * cols4 for _ in range(3)]
        self.left_level = [[0] * rows4 for _ in range(3)]
        self.left_dc = [[0] * rows4 for _ in range(3)]
        self.sb4 = 32 if seq.use_128 else 16
        self.sb_mask = self.sb4 - 1

    def decode(self) -> None:
        sb4 = self.sb4
        bsize = BLOCK_128X128 if self.seq.use_128 else BLOCK_64X64
        self.seen.add(f"superblock {BLOCK_DIMS[bsize][0]}")
        for r in range(self.row_start, self.row_end, sb4):
            for plane in range(3):
                self.left_level[plane] = [0] * len(self.left_level[plane])
                self.left_dc[plane] = [0] * len(self.left_dc[plane])
            for c in range(self.col_start, self.col_end, sb4):
                # clear_cdef
                cdef_idx = self.f.cdef_idx
                for y in range(r >> 4, (r + sb4) >> 4):
                    for x in range(c >> 4, (c + sb4) >> 4):
                        cdef_idx[y][x] = -1
                self._clear_block_decoded(r, c)
                self._partition(r, c, bsize)

    def _clear_block_decoded(self, r: int, c: int) -> None:
        sb4 = self.sb4
        self.decoded = []
        for plane in range(self.num_planes):
            subx = self.subx if plane else 0
            suby = self.suby if plane else 0
            width4 = (self.col_end - c) >> subx
            height4 = (self.row_end - r) >> suby
            size_y, size_x = sb4 >> suby, sb4 >> subx
            # Indexed [y + 1][x + 1] for y, x from -1.
            grid = [[0] * (size_x + 3) for _ in range(size_y + 3)]
            for x in range(-1, size_x + 1):
                if x < width4:
                    grid[0][x + 1] = 1
            for y in range(0, size_y + 1):
                if y < height4:
                    grid[y + 1][0] = 1
            grid[size_y + 1][0] = 0
            self.decoded.append(grid)

    def _inside(self, r: int, c: int) -> bool:
        return self.col_start <= c < self.col_end and self.row_start <= r < self.row_end

    # -- partitions --------------------------------------------------------

    def _partition(self, r: int, c: int, bsize: int) -> None:
        f = self.f
        if r >= f.mi_rows or c >= f.mi_cols:
            return
        avail_u = self._inside(r - 1, c)
        avail_l = self._inside(r, c - 1)
        num4 = BLOCK_DIMS[bsize][0] >> 2
        half = num4 >> 1
        quarter = half >> 1
        has_rows = (r + half) < f.mi_rows
        has_cols = (c + half) < f.mi_cols
        if bsize < BLOCK_8X8:
            partition = PARTITION_NONE
        else:
            bsl = LOG2[num4]
            above = avail_u and LOG2[BLOCK_DIMS[f.mi_sizes[r - 1][c]][0] >> 2] < bsl
            left = avail_l and LOG2[BLOCK_DIMS[f.mi_sizes[r][c - 1]][1] >> 2] < bsl
            cdf = self.cdf["partition"][(bsl - 1) * 4 + left * 2 + above]
            if has_rows and has_cols:
                partition = self.sd.symbol(cdf)
            elif has_cols or has_rows:
                def p(k):
                    return cdf[k] - (cdf[k - 1] if k else 0) if k < len(cdf) - 1 else 0

                if has_cols:  # split_or_horz
                    parts = [PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A, PARTITION_VERT_A,
                             PARTITION_VERT_B]
                    if bsize != BLOCK_128X128:
                        parts.append(PARTITION_VERT_4)
                else:  # split_or_vert
                    parts = [PARTITION_HORZ, PARTITION_SPLIT, PARTITION_HORZ_A, PARTITION_HORZ_B,
                             PARTITION_VERT_A]
                    if bsize != BLOCK_128X128:
                        parts.append(PARTITION_HORZ_4)
                if bsize == BLOCK_8X8:
                    parts = parts[:2]
                psum = sum(p(k) for k in parts)
                split = self.sd.bool_p(32768 - psum)
                partition = PARTITION_SPLIT if split else (
                    PARTITION_HORZ if has_cols else PARTITION_VERT)
            else:
                partition = PARTITION_SPLIT
        self.seen.add(f"partition {partition}")
        sub = _partition_subsize(partition, bsize)
        if PARTITION_HORZ_A <= partition <= PARTITION_VERT_B:
            split = _partition_subsize(PARTITION_SPLIT, bsize)
        block = self._block
        if partition == PARTITION_NONE:
            block(r, c, sub)
        elif partition == PARTITION_HORZ:
            block(r, c, sub)
            if has_rows:
                block(r + half, c, sub)
        elif partition == PARTITION_VERT:
            block(r, c, sub)
            if has_cols:
                block(r, c + half, sub)
        elif partition == PARTITION_SPLIT:
            self._partition(r, c, sub)
            self._partition(r, c + half, sub)
            self._partition(r + half, c, sub)
            self._partition(r + half, c + half, sub)
        elif partition == PARTITION_HORZ_A:
            block(r, c, split)
            block(r, c + half, split)
            block(r + half, c, sub)
        elif partition == PARTITION_HORZ_B:
            block(r, c, sub)
            block(r + half, c, split)
            block(r + half, c + half, split)
        elif partition == PARTITION_VERT_A:
            block(r, c, split)
            block(r + half, c, split)
            block(r, c + half, sub)
        elif partition == PARTITION_VERT_B:
            block(r, c, sub)
            block(r, c + half, split)
            block(r + half, c + half, split)
        elif partition == PARTITION_HORZ_4:
            for i in range(4):
                if i < 3 or r + quarter * 3 < f.mi_rows:
                    block(r + quarter * i, c, sub)
        else:
            for i in range(4):
                if i < 3 or c + quarter * 3 < f.mi_cols:
                    block(r, c + quarter * i, sub)

    # -- blocks --------------------------------------------------------------

    def _block(self, r: int, c: int, bsize: int) -> None:
        f, sd, cdf = self.f, self.sd, self.cdf
        subx, suby = self.subx, self.suby
        bw, bh = BLOCK_DIMS[bsize]
        bw4, bh4 = bw >> 2, bh >> 2
        if self.num_planes == 1:
            has_chroma = False
        elif bh4 == 1 and suby and not r & 1:
            has_chroma = False
        elif bw4 == 1 and subx and not c & 1:
            has_chroma = False
        else:
            has_chroma = True
        avail_u = self._inside(r - 1, c)
        avail_l = self._inside(r, c - 1)
        avail_uc, avail_lc = avail_u, avail_l
        if has_chroma:
            if suby and bh4 == 1:
                avail_uc = self._inside(r - 2, c)
            if subx and bw4 == 1:
                avail_lc = self._inside(r, c - 2)
        else:
            avail_uc = avail_lc = False
        b = _Block(r, c, bsize, has_chroma, avail_u, avail_l, avail_uc, avail_lc)

        # intra_frame_mode_info
        b.segment_id = 0
        if f.seg_id_pre_skip:
            self._segment_id(b, 0)
        if f.seg_id_pre_skip and f.feature_enabled[b.segment_id][6]:
            b.skip = 1
        else:
            b.skip = sd.symbol(cdf["skip"][(f.skips[r - 1][c] if avail_u else 0)
                                           + (f.skips[r][c - 1] if avail_l else 0)])
        if not f.seg_id_pre_skip:
            self._segment_id(b, b.skip)
        b.lossless = f.lossless[b.segment_id]
        if b.lossless and not f.coded_lossless:
            self.seen.add("lossless segment")
        # read_cdef, per 64x64; read_delta_qindex and read_delta_lf read
        # nothing without delta_q_present.
        if f.cdef_on and not b.skip:
            r16, c16 = r >> 4, c >> 4
            if f.cdef_idx[r16][c16] == -1:
                value = sd.literal(f.cdef_bits)
                for y in range(r16, r16 + max(1, bh4 >> 4)):
                    for x in range(c16, c16 + max(1, bw4 >> 4)):
                        f.cdef_idx[y][x] = value
        above_mode = f.y_modes[r - 1][c] if avail_u else DC_PRED
        left_mode = f.y_modes[r][c - 1] if avail_l else DC_PRED
        b.y_mode = sd.symbol(cdf["kf_y_mode"][INTRA_MODE_CONTEXT[above_mode]]
                             [INTRA_MODE_CONTEXT[left_mode]])
        b.angle_y = 0
        if bsize >= BLOCK_8X8 and V_PRED <= b.y_mode <= D67_PRED:
            b.angle_y = sd.symbol(cdf["angle_delta"][b.y_mode - V_PRED]) - 3
        b.uv_mode = DC_PRED
        b.angle_uv = 0
        if has_chroma:
            if b.lossless:
                cfl_allowed = _residual_size(bsize, subx, suby) == BLOCK_4X4
            else:
                cfl_allowed = max(bw, bh) <= 32
            if cfl_allowed:
                b.uv_mode = sd.symbol(cdf["uv_mode"][1][b.y_mode])
            else:
                b.uv_mode = sd.symbol(cdf["uv_mode"][0][b.y_mode])
            if b.uv_mode == UV_CFL_PRED:
                self._cfl_alphas(b)
            if bsize >= BLOCK_8X8 and V_PRED <= b.uv_mode <= D67_PRED:
                b.angle_uv = sd.symbol(cdf["angle_delta"][b.uv_mode - V_PRED]) - 3
        b.palette_y = b.palette_uv = ()
        if (bsize >= BLOCK_8X8 and bw <= 64 and bh <= 64
                and f.allow_screen_content_tools):
            self._palette_mode_info(b)
        b.filter_intra = -1
        if (self.seq.enable_filter_intra and b.y_mode == DC_PRED and not b.palette_y
                and max(bw, bh) <= 32):
            if sd.symbol(cdf["filter_intra"][bsize]):
                b.filter_intra = sd.symbol(cdf["filter_intra_mode"])
                self.seen.add(f"filter_intra {b.filter_intra}")
        self._palette_tokens(b)
        # read_block_tx_size: Max_Tx_Size_Rect, split tx_depth times.
        tx = (min(bw, 64), min(bh, 64))
        if b.lossless:
            tx = (4, 4)
        elif bsize != BLOCK_4X4 and f.tx_mode_select:
            max_w, max_h = tx
            above = f.tx_sizes[r - 1][c][0] if avail_u else 0
            left = f.tx_sizes[r][c - 1][1] if avail_l else 0
            depth = sd.symbol(cdf["tx_depth"][LOG2[max(tx)] - 3][(above >= max_w)
                                                                 + (left >= max_h)])
            for _ in range(depth):
                tx = _split_tx(tx)
            self.seen.add(f"tx_depth {depth}")
        b.tx = tx
        self.seen.update((f"y_mode {b.y_mode}", f"uv_mode {b.uv_mode}" if has_chroma else "mono",
                          f"block {bw}x{bh}"))
        if b.skip:
            self.seen.add("skip")
            self._reset_block_context(b)
        for y in range(r, min(r + bh4, f.mi_rows)):
            ym, sk, ms = f.y_modes[y], f.skips[y], f.mi_sizes[y]
            sid = f.segment_ids[y]
            ps0, ps1 = f.palette_sizes[0][y], f.palette_sizes[1][y]
            pc0, pc1 = f.palette_colors[0][y], f.palette_colors[1][y]
            txs = f.tx_sizes[y]
            for x in range(c, min(c + bw4, f.mi_cols)):
                ym[x] = b.y_mode
                sk[x] = b.skip
                ms[x] = bsize
                txs[x] = tx
                sid[x] = b.segment_id
                ps0[x] = len(b.palette_y)
                ps1[x] = len(b.palette_u)
                pc0[x] = b.palette_y
                pc1[x] = b.palette_u
            if has_chroma:
                um = f.uv_modes[y]
                for x in range(c, min(c + bw4, f.mi_cols)):
                    um[x] = b.uv_mode
        self._residual(b)

    def _segment_id(self, b, skip: int) -> None:
        f = self.f
        b.segment_id = 0
        if not f.segmentation_enabled:
            return
        r, c = b.r, b.c
        ids = f.segment_ids
        prev_ul = ids[r - 1][c - 1] if b.avail_u and b.avail_l else -1
        prev_u = ids[r - 1][c] if b.avail_u else -1
        prev_l = ids[r][c - 1] if b.avail_l else -1
        if prev_u == -1:
            pred = 0 if prev_l == -1 else prev_l
        elif prev_l == -1:
            pred = prev_u
        else:
            pred = prev_u if prev_ul == prev_u else prev_l
        if skip:
            b.segment_id = pred
            return
        if prev_ul < 0:
            ctx = 0
        elif prev_ul == prev_u and prev_ul == prev_l:
            ctx = 2
        elif prev_ul == prev_u or prev_ul == prev_l or prev_u == prev_l:
            ctx = 1
        else:
            ctx = 0
        coded = self.sd.symbol(self.cdf["segment_id"][ctx])
        last = f.last_active_seg_id + 1
        # neg_deinterleave
        diff, ref, maximum = coded, pred, last
        if not ref:
            value = diff
        elif ref >= maximum - 1:
            value = maximum - diff - 1
        elif 2 * ref < maximum:
            if diff <= 2 * ref:
                value = ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
            else:
                value = diff
        else:
            if diff <= 2 * (maximum - ref - 1):
                value = ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
            else:
                value = maximum - (diff + 1)
        b.segment_id = max(0, min(f.last_active_seg_id, value))

    def _cfl_alphas(self, b) -> None:
        sd, cdf = self.sd, self.cdf
        signs = sd.symbol(cdf["cfl_sign"])
        sign_u, sign_v = (signs + 1) // 3, (signs + 1) % 3
        b.cfl_u = b.cfl_v = 0
        if sign_u:
            b.cfl_u = sd.symbol(cdf["cfl_alpha"][(sign_u - 1) * 3 + sign_v]) + 1
            if sign_u == 1:
                b.cfl_u = -b.cfl_u
        if sign_v:
            b.cfl_v = sd.symbol(cdf["cfl_alpha"][(sign_v - 1) * 3 + sign_u]) + 1
            if sign_v == 1:
                b.cfl_v = -b.cfl_v

    # -- palette -------------------------------------------------------------

    def _palette_cache(self, b, plane: int) -> list:
        f = self.f
        r, c = b.r, b.c
        above_n = f.palette_sizes[plane][r - 1][c] if (r * 4) % 64 and b.avail_u else 0
        left_n = f.palette_sizes[plane][r][c - 1] if b.avail_l else 0
        above = f.palette_colors[plane][r - 1][c] if above_n else ()
        left = f.palette_colors[plane][r][c - 1] if left_n else ()
        ai = li = 0
        cache = []
        while ai < above_n and li < left_n:
            above_c, left_c = above[ai], left[li]
            if left_c < above_c:
                if not cache or left_c != cache[-1]:
                    cache.append(left_c)
                li += 1
            else:
                if not cache or above_c != cache[-1]:
                    cache.append(above_c)
                ai += 1
                if left_c == above_c:
                    li += 1
        for value in list(above[ai:above_n]) + list(left[li:left_n]):
            if not cache or value != cache[-1]:
                cache.append(value)
        return cache

    def _palette_colors(self, b, plane: int, size: int) -> list:
        sd = self.sd
        depth = self.seq.bit_depth
        colors = []
        for value in self._palette_cache(b, plane):
            if len(colors) >= size:
                break
            if sd.literal(1):
                colors.append(value)
                self.seen.add("palette_cache")
        if len(colors) < size:
            colors.append(sd.literal(depth))
            if len(colors) < size:
                bits = depth - 3 + sd.literal(2)
                while len(colors) < size:
                    delta = sd.literal(bits)
                    if plane == 0:
                        delta += 1
                    color = min((1 << depth) - 1, colors[-1] + delta)
                    colors.append(color)
                    span = (1 << depth) - color - (1 if plane == 0 else 0)
                    bits = min(bits, max(0, (span - 1).bit_length()) if span > 0 else 0)
        return sorted(colors)

    def _palette_mode_info(self, b) -> None:
        f, sd, cdf = self.f, self.sd, self.cdf
        bw, bh = BLOCK_DIMS[b.bsize]
        bsize_ctx = LOG2[bw >> 2] + LOG2[bh >> 2] - 2
        if b.y_mode == DC_PRED:
            ctx = (b.avail_u and f.palette_sizes[0][b.r - 1][b.c] > 0) + \
                  (b.avail_l and f.palette_sizes[0][b.r][b.c - 1] > 0)
            if sd.symbol(cdf["palette_y_mode"][bsize_ctx][ctx]):
                size = sd.symbol(cdf["palette_y_size"][bsize_ctx]) + 2
                b.palette_y = tuple(self._palette_colors(b, 0, size))
                self.seen.add("palette_y")
        if b.has_chroma and b.uv_mode == DC_PRED:
            if sd.symbol(cdf["palette_uv_mode"][1 if b.palette_y else 0]):
                size = sd.symbol(cdf["palette_uv_size"][bsize_ctx]) + 2
                u = self._palette_colors(b, 1, size)
                depth = self.seq.bit_depth
                if sd.literal(1):  # delta_encode_palette_colors_v
                    self.seen.add("palette_v_delta")
                    bits = depth - 4 + sd.literal(2)
                    maximum = 1 << depth
                    v = [sd.literal(depth)]
                    for _ in range(1, size):
                        delta = sd.literal(bits)
                        if delta and sd.literal(1):
                            delta = -delta
                        value = v[-1] + delta
                        if value < 0:
                            value += maximum
                        if value >= maximum:
                            value -= maximum
                        v.append(min(maximum - 1, max(0, value)))
                else:
                    v = [sd.literal(depth) for _ in range(size)]
                self.seen.add("palette_uv")
                b.palette_u = tuple(u)
                b.palette_uv = (tuple(u), tuple(v))

    def _color_map(self, size: int, block_w: int, block_h: int, onscreen_w: int,
                   onscreen_h: int, plane_type: int) -> list:
        sd = self.sd
        cdfs = self.cdf["palette_color"][plane_type][size - 2]
        colormap = [[0] * block_w for _ in range(block_h)]
        colormap[0][0] = sd.ns(size)
        context = T.PALETTE_COLOR_CONTEXT
        for i in range(1, onscreen_h + onscreen_w - 1):
            for j in range(min(i, onscreen_w - 1), max(0, i - onscreen_h + 1) - 1, -1):
                row, col = i - j, j
                scores = [0] * 8
                if col > 0:
                    scores[colormap[row][col - 1]] += 2
                    if row > 0:
                        scores[colormap[row - 1][col - 1]] += 1
                if row > 0:
                    scores[colormap[row - 1][col]] += 2
                order = list(range(8))
                for k in range(3):
                    best, best_at = scores[k], k
                    for m in range(k + 1, size):
                        if scores[m] > best:
                            best, best_at = scores[m], m
                    if best_at != k:
                        best_order = order[best_at]
                        for m in range(best_at, k, -1):
                            scores[m] = scores[m - 1]
                            order[m] = order[m - 1]
                        scores[k] = best
                        order[k] = best_order
                ctx = context[scores[0] + 2 * scores[1] + 2 * scores[2]]
                colormap[row][col] = order[sd.symbol(cdfs[ctx])]
        for i in range(onscreen_h):
            last = colormap[i][onscreen_w - 1]
            for j in range(onscreen_w, block_w):
                colormap[i][j] = last
        for i in range(onscreen_h, block_h):
            colormap[i] = list(colormap[onscreen_h - 1])
        return colormap

    def _palette_tokens(self, b) -> None:
        f = self.f
        bw, bh = BLOCK_DIMS[b.bsize]
        onscreen_h = min(bh, (f.mi_rows - b.r) * 4)
        onscreen_w = min(bw, (f.mi_cols - b.c) * 4)
        if b.palette_y:
            b.map_y = self._color_map(len(b.palette_y), bw, bh, onscreen_w, onscreen_h, 0)
        if b.palette_uv:
            bw, bh = bw >> self.subx, bh >> self.suby
            onscreen_w >>= self.subx
            onscreen_h >>= self.suby
            if bw < 4:
                bw += 2
                onscreen_w += 2
            if bh < 4:
                bh += 2
                onscreen_h += 2
            b.map_uv = self._color_map(len(b.palette_uv[0]), bw, bh, onscreen_w, onscreen_h, 1)

    def _reset_block_context(self, b) -> None:
        bw4, bh4 = BLOCK_DIMS[b.bsize][0] >> 2, BLOCK_DIMS[b.bsize][1] >> 2
        for plane in range(1 + 2 * b.has_chroma):
            subx = self.subx if plane else 0
            suby = self.suby if plane else 0
            for i in range(b.c >> subx, ((b.c + bw4 - 1) >> subx) + 1):
                self.above_level[plane][i] = 0
                self.above_dc[plane][i] = 0
            for i in range(b.r >> suby, ((b.r + bh4 - 1) >> suby) + 1):
                self.left_level[plane][i] = 0
                self.left_dc[plane][i] = 0

    # -- residual and reconstruction -----------------------------------------

    def _residual(self, b) -> None:
        """residual(): the transform blocks of each plane at the block's
        transform size, 64x64 at a time."""
        bw, bh = BLOCK_DIMS[b.bsize]
        width_chunks = max(1, bw >> 6)
        height_chunks = max(1, bh >> 6)
        size_chunk = BLOCK_OF_DIMS[(min(bw, 64), min(bh, 64))]
        for chunk_y in range(height_chunks):
            for chunk_x in range(width_chunks):
                for plane in range(1 + 2 * b.has_chroma):
                    subx = self.subx if plane else 0
                    suby = self.suby if plane else 0
                    if plane:
                        plane_size = _residual_size(size_chunk, subx, suby)
                        if plane_size is None:
                            raise ValueError("AV1 block has an invalid chroma size")
                    else:
                        plane_size = size_chunk
                    if b.lossless:
                        tx = (4, 4)
                    elif plane:
                        tx = _uv_tx(b.bsize, subx, suby)
                    else:
                        tx = b.tx
                    num4w = BLOCK_DIMS[plane_size][0] >> 2
                    num4h = BLOCK_DIMS[plane_size][1] >> 2
                    base_x = (b.c >> subx) * 4
                    base_y = (b.r >> suby) * 4
                    for y in range(0, num4h, tx[1] >> 2):
                        for x in range(0, num4w, tx[0] >> 2):
                            self._transform_block(b, plane, base_x, base_y, tx,
                                                  x + ((chunk_x << 4) >> subx),
                                                  y + ((chunk_y << 4) >> suby))

    def _transform_block(self, b, plane: int, base_x: int, base_y: int, tx: tuple, x: int,
                         y: int) -> None:
        f = self.f
        w, h = tx
        start_x = base_x + 4 * x
        start_y = base_y + 4 * y
        subx = self.subx if plane else 0
        suby = self.suby if plane else 0
        row = (start_y << suby) >> 2
        col = (start_x << subx) >> 2
        sub_row = row & self.sb_mask
        sub_col = col & self.sb_mask
        step_x, step_y = w >> 2, h >> 2
        max_x = f.mi_cols * 4 - 1
        max_y = f.mi_rows * 4 - 1
        if start_x >= (max_x >> subx) or start_y >= (max_y >> suby):
            return
        decoded = self.decoded[plane]
        dy, dx = (sub_row >> suby) + 1, (sub_col >> subx) + 1
        frame = f.planes[plane]
        if b.palette_uv if plane else b.palette_y:
            colors = b.palette_uv[plane - 1] if plane else b.palette_y
            cmap = b.map_uv if plane else b.map_y
            for i in range(h):
                src = cmap[y * 4 + i]
                frame[start_y + i][start_x:start_x + w] = [colors[src[x * 4 + j]]
                                                            for j in range(w)]
        else:
            cfl = plane > 0 and b.uv_mode == UV_CFL_PRED
            if plane == 0:
                mode = b.y_mode
            else:
                mode = DC_PRED if cfl else b.uv_mode
            have_left = (b.avail_l if plane == 0 else b.avail_lc) or x > 0
            have_above = (b.avail_u if plane == 0 else b.avail_uc) or y > 0
            self._predict_intra(b, plane, start_x, start_y, have_left, have_above,
                                decoded[dy - 1][dx + step_x], decoded[dy + step_y][dx - 1], mode,
                                w, h)
            if cfl:
                self._predict_cfl(b, plane, start_x, start_y, w, h)
        if plane == 0:
            b.max_luma_w = start_x + w
            b.max_luma_h = start_y + h
        if not b.skip:
            coeffs = self._coeffs(b, plane, start_x, start_y, tx)
            if coeffs is not None:
                if b.lossless:
                    self._reconstruct_wht(frame, start_x, start_y, coeffs[0])
                else:
                    self._reconstruct(b, plane, start_x, start_y, tx, *coeffs)
        if not f.coded_lossless:  # deblocking's transform sizes
            lf_w, lf_h = f.lf_tx[plane]
            y4, x4 = start_y >> 2, start_x >> 2
            lf_w[y4:y4 + step_y, x4:x4 + step_x] = w
            lf_h[y4:y4 + step_y, x4:x4 + step_x] = h
        for i in range(step_y):
            marks = decoded[dy + i]
            for j in range(step_x):
                marks[dx + j] = 1

    # -- prediction ----------------------------------------------------------

    def _filter_type(self, b, plane: int) -> int:
        f = self.f
        above_smooth = left_smooth = False
        if b.avail_u if plane == 0 else b.avail_uc:
            r, c = b.r - 1, b.c
            if plane:
                if self.subx and not b.c & 1:
                    c += 1
                if self.suby and b.r & 1:
                    r -= 1
            above_smooth = (f.y_modes if plane == 0 else f.uv_modes)[r][c] in SMOOTH_MODES
        if b.avail_l if plane == 0 else b.avail_lc:
            r, c = b.r, b.c - 1
            if plane:
                if self.subx and b.c & 1:
                    c -= 1
                if self.suby and not b.r & 1:
                    r += 1
            left_smooth = (f.y_modes if plane == 0 else f.uv_modes)[r][c] in SMOOTH_MODES
        return 1 if above_smooth or left_smooth else 0

    def _predict_intra(self, b, plane, x, y, have_left, have_above, have_above_right,
                       have_below_left, mode, w, h) -> None:
        f = self.f
        frame = f.planes[plane]
        subx = self.subx if plane else 0
        suby = self.suby if plane else 0
        max_x = ((f.mi_cols * 4) >> subx) - 1
        max_y = ((f.mi_rows * 4) >> suby) - 1
        base = 1 << (self.seq.bit_depth - 1)
        n = w + h
        # AboveRow[-1..n-1] and LeftCol[-1..n-1] at offset 16, room for
        # upsampling on both sides.
        above = [0] * (2 * n + 32)
        left = [0] * (2 * n + 32)
        if not have_above and have_left:
            value = frame[y][x - 1]
            above[16:16 + n] = [value] * n
        elif not have_above:
            above[16:16 + n] = [base - 1] * n
        else:
            limit = min(max_x, x + (2 * w if have_above_right else w) - 1)
            src = frame[y - 1]
            inside = src[x:limit + 1]
            above[16:16 + n] = (inside + [src[limit]] * (n - len(inside)))[:n]
        if not have_left and have_above:
            value = frame[y - 1][x]
            left[16:16 + n] = [value] * n
        elif not have_left:
            left[16:16 + n] = [base + 1] * n
        else:
            limit = min(max_y, y + (2 * h if have_below_left else h) - 1)
            inside = [frame[i][x - 1] for i in range(y, min(limit + 1, y + n))]
            left[16:16 + n] = inside + [inside[-1]] * (n - len(inside))
        if have_above and have_left:
            corner = frame[y - 1][x - 1]
        elif have_above:
            corner = frame[y - 1][x]
        elif have_left:
            corner = frame[y][x - 1]
        else:
            corner = base
        above[15] = left[15] = corner

        if plane == 0 and b.filter_intra >= 0:
            pred = self._filter_intra(b.filter_intra, above, left, w, h)
        elif V_PRED <= mode <= D67_PRED:
            angle = T.MODE_TO_ANGLE[mode] + 3 * (b.angle_y if plane == 0 else b.angle_uv)
            if angle % 45 and angle not in (113, 157, 203, 67):
                self.seen.add("angle_delta")
            pred = self._directional(b, plane, x, y, have_left, have_above, angle, above, left,
                                     max_x, max_y, w, h)
        elif mode == SMOOTH_PRED:
            wx, wy = T.SM_WEIGHTS[w], T.SM_WEIGHTS[h]
            bottom, right = left[16 + h - 1], above[16 + w - 1]
            pred = [[(wy[i] * above[16 + j] + (256 - wy[i]) * bottom
                      + wx[j] * left[16 + i] + (256 - wx[j]) * right + 256) >> 9
                     for j in range(w)] for i in range(h)]
        elif mode == SMOOTH_V_PRED:
            wy = T.SM_WEIGHTS[h]
            bottom = left[16 + h - 1]
            pred = [[(wy[i] * above[16 + j] + (256 - wy[i]) * bottom + 128) >> 8
                     for j in range(w)] for i in range(h)]
        elif mode == SMOOTH_H_PRED:
            wx = T.SM_WEIGHTS[w]
            right = above[16 + w - 1]
            pred = [[(wx[j] * left[16 + i] + (256 - wx[j]) * right + 128) >> 8
                     for j in range(w)] for i in range(h)]
        elif mode == DC_PRED:
            if have_left and have_above:
                total = sum(above[16:16 + w]) + sum(left[16:16 + h])
                avg = (total + ((w + h) >> 1)) // (w + h)
            elif have_left:
                avg = (sum(left[16:16 + h]) + (h >> 1)) >> LOG2[h]
            elif have_above:
                avg = (sum(above[16:16 + w]) + (w >> 1)) >> LOG2[w]
            else:
                avg = base
            pred = [[avg] * w for _ in range(h)]
        else:  # PAETH_PRED
            pred = []
            for i in range(h):
                out = []
                lft = left[16 + i]
                for j in range(w):
                    top = above[16 + j]
                    p = top + lft - corner
                    p_left, p_top, p_corner = abs(p - lft), abs(p - top), abs(p - corner)
                    if p_left <= p_top and p_left <= p_corner:
                        out.append(lft)
                    elif p_top <= p_corner:
                        out.append(top)
                    else:
                        out.append(corner)
                pred.append(out)
        for i in range(h):
            frame[y + i][x:x + w] = pred[i]

    def _filter_intra(self, mode: int, above: list, left: list, w: int, h: int) -> list:
        taps = T.INTRA_FILTER_TAPS[mode]
        pred = [[0] * w for _ in range(h)]
        top = (1 << self.seq.bit_depth) - 1
        for i2 in range(h >> 1):
            for j4 in range(w >> 2):
                p = []
                for i in range(7):
                    if i < 5:
                        if i2 == 0:
                            p.append(above[16 + (j4 << 2) + i - 1])
                        elif j4 == 0 and i == 0:
                            p.append(left[16 + (i2 << 1) - 1])
                        else:
                            p.append(pred[(i2 << 1) - 1][(j4 << 2) + i - 1])
                    elif j4 == 0:
                        p.append(left[16 + (i2 << 1) + i - 5])
                    else:
                        p.append(pred[(i2 << 1) + i - 5][(j4 << 2) - 1])
                for i in range(8):
                    tap = taps[i]
                    s = sum(tap[k] * p[k] for k in range(7))
                    value = (s + 8) >> 4 if s >= 0 else -((-s + 8) >> 4)
                    pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = min(top, max(0, value))
        return pred

    def _edge_filter(self, buf: list, size: int, strength: int) -> None:
        """Filters buf[15..15 + size - 1] (AboveRow / LeftCol from -1)."""
        if not strength:
            return
        kernel = T.INTRA_EDGE_KERNEL[strength - 1]
        edge = buf[15:15 + size]
        for i in range(1, size):
            s = 0
            for j in range(5):
                k = min(size - 1, max(0, i - 2 + j))
                s += kernel[j] * edge[k]
            buf[15 + i] = (s + 8) >> 4

    def _upsample(self, buf: list, num_px: int) -> None:
        top = (1 << self.seq.bit_depth) - 1
        dup = [0] * (num_px + 3)
        dup[0] = buf[15]
        for i in range(-1, num_px):
            dup[i + 2] = buf[16 + i]
        dup[num_px + 2] = buf[16 + num_px - 1]
        buf[14] = dup[0]
        for i in range(num_px):
            s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
            s = min(top, max(0, (s + 8) >> 4))
            buf[16 + 2 * i - 1] = s
            buf[16 + 2 * i] = dup[i + 2]

    def _directional(self, b, plane, x, y, have_left, have_above, angle, above, left,
                     max_x, max_y, w, h) -> list:
        upsample_above = upsample_left = 0
        if self.seq.enable_intra_edge_filter:
            if angle != 90 and angle != 180:
                if 90 < angle < 180 and (w + h) >= 24:
                    corner = (left[16] * 5 + above[15] * 6 + above[16] * 5 + 8) >> 4
                    above[15] = left[15] = corner
                filter_type = self._filter_type(b, plane)
                if have_above:
                    strength = _edge_strength(w, h, filter_type, angle - 90)
                    num_px = min(w, max_x - x + 1) + (h if angle < 90 else 0) + 1
                    self._edge_filter(above, num_px, strength)
                    self.seen.add(f"edge_filter {strength}")
                if have_left:
                    strength = _edge_strength(w, h, filter_type, angle - 180)
                    num_px = min(h, max_y - y + 1) + (w if angle > 180 else 0) + 1
                    self._edge_filter(left, num_px, strength)
            else:
                filter_type = 0
            upsample_above = _use_upsample(w, h, filter_type, angle - 90)
            if upsample_above:
                self.seen.add("upsample")
                self._upsample(above, w + (h if angle < 90 else 0))
            upsample_left = _use_upsample(w, h, filter_type, angle - 180)
            if upsample_left:
                self._upsample(left, h + (w if angle > 180 else 0))
        deriv = T.DR_INTRA_DERIVATIVE
        if angle < 90:
            dx = deriv[angle]
        elif 90 < angle < 180:
            dx = deriv[180 - angle]
        if 90 < angle < 180:
            dy = deriv[angle - 90]
        elif angle > 180:
            dy = deriv[270 - angle]
        pred = [[0] * w for _ in range(h)]
        for i in range(h):
            row = pred[i]
            for j in range(w):
                if angle < 90:
                    idx = (i + 1) * dx
                    base = (idx >> (6 - upsample_above)) + (j << upsample_above)
                    shift = ((idx << upsample_above) >> 1) & 0x1F
                    max_base = (w + h - 1) << upsample_above
                    if base < max_base:
                        row[j] = (above[16 + base] * (32 - shift)
                                  + above[17 + base] * shift + 16) >> 5
                    else:
                        row[j] = above[16 + max_base]
                elif 90 < angle < 180:
                    idx = (j << 6) - (i + 1) * dx
                    base = idx >> (6 - upsample_above)
                    if base >= -(1 << upsample_above):
                        shift = ((idx << upsample_above) >> 1) & 0x1F
                        row[j] = (above[16 + base] * (32 - shift)
                                  + above[17 + base] * shift + 16) >> 5
                    else:
                        idx = (i << 6) - (j + 1) * dy
                        base = idx >> (6 - upsample_left)
                        shift = ((idx << upsample_left) >> 1) & 0x1F
                        row[j] = (left[16 + base] * (32 - shift)
                                  + left[17 + base] * shift + 16) >> 5
                elif angle > 180:
                    idx = (j + 1) * dy
                    base = (idx >> (6 - upsample_left)) + (i << upsample_left)
                    shift = ((idx << upsample_left) >> 1) & 0x1F
                    row[j] = (left[16 + base] * (32 - shift) + left[17 + base] * shift + 16) >> 5
                elif angle == 90:
                    row[j] = above[16 + j]
                else:
                    row[j] = left[16 + i]
        return pred

    def _predict_cfl(self, b, plane: int, start_x: int, start_y: int, w: int, h: int) -> None:
        f = self.f
        subx, suby = self.subx, self.suby
        alpha = b.cfl_u if plane == 1 else b.cfl_v
        luma = f.planes[0]
        frame = f.planes[plane]
        values = []
        for i in range(h):
            luma_y = min(b.max_luma_h - (1 << suby), (start_y + i) << suby)
            row = []
            for j in range(w):
                luma_x = min(b.max_luma_w - (1 << subx), (start_x + j) << subx)
                t = 0
                for ddy in range(suby + 1):
                    src = luma[luma_y + ddy]
                    for ddx in range(subx + 1):
                        t += src[luma_x + ddx]
                row.append(t << (3 - subx - suby))
            values.append(row)
        shift = LOG2[w] + LOG2[h]
        avg = (sum(sum(row) for row in values) + (1 << (shift - 1))) >> shift
        top = (1 << self.seq.bit_depth) - 1
        for i in range(h):
            out = frame[start_y + i]
            for j in range(w):
                scaled = alpha * (values[i][j] - avg)
                scaled = (scaled + 32) >> 6 if scaled >= 0 else -((-scaled + 32) >> 6)
                out[start_x + j] = min(top, max(0, out[start_x + j] + scaled))

    # -- coefficients --------------------------------------------------------

    def _tx_set(self, tx: tuple) -> int:
        """get_tx_set for an intra block: 0 (DCT only), 1 or 2."""
        if max(tx) >= 32:
            return 0
        if self.f.reduced_tx_set or min(tx) == 16:
            return 2
        return 1

    def _tx_type(self, b, plane: int, tx: tuple) -> int:
        """The luma block's intra_tx_type, read here, or compute_tx_type
        for chroma."""
        if b.lossless:
            return 0
        tx_set = self._tx_set(tx)
        if not tx_set:
            return 0
        if plane:
            return T.MODE_TO_TXFM[b.uv_mode]
        if not self.f.qindex[b.segment_id]:
            return 0
        mode = T.FILTER_INTRA_MODE_TO_INTRA_DIR[b.filter_intra] if b.filter_intra >= 0 else \
            b.y_mode
        symbol = self.sd.symbol(self.cdf["intra_tx_type"][tx_set][LOG2[min(tx)] - 2][mode])
        return (T.TX_TYPE_INTRA_INV_SET1 if tx_set == 1 else T.TX_TYPE_INTRA_INV_SET2)[symbol]

    def _coeffs(self, b, plane: int, start_x: int, start_y: int, tx: tuple):
        """coeffs() for one transform block: (the levels with their signs
        in raster order of the coded min(w, 32) x min(h, 32), the transform
        type), or None where the block has none."""
        f, sd, cdf = self.f, self.sd, self.cdf
        w, h = tx
        x4, y4 = start_x >> 2, start_y >> 2
        subx = self.subx if plane else 0
        suby = self.suby if plane else 0
        # The 4x4 columns and rows of the block inside the frame.
        x_end = min(x4 + (w >> 2), f.mi_cols >> subx)
        y_end = min(y4 + (h >> 2), f.mi_rows >> suby)
        ptype = 1 if plane else 0
        above_level, above_dc = self.above_level[plane], self.above_dc[plane]
        left_level, left_dc = self.left_level[plane], self.left_dc[plane]
        plane_size = b.bsize if plane == 0 else _residual_size(b.bsize, subx, suby)
        pw, ph = BLOCK_DIMS[plane_size]
        tx_ctx = _TX_SIZE_CTX[tx]
        if plane == 0:
            top = max(above_level[x4:x_end], default=0)
            lft = max(left_level[y4:y_end], default=0)
            if pw == w and ph == h:
                ctx = 0
            elif top == 0 and lft == 0:
                ctx = 1
            elif top == 0 or lft == 0:
                ctx = 2 + (max(top, lft) > 3)
            elif max(top, lft) <= 3:
                ctx = 4
            elif min(top, lft) <= 3:
                ctx = 5
            else:
                ctx = 6
        else:
            above = any(above_level[x4:x_end]) or any(above_dc[x4:x_end])
            left = any(left_level[y4:y_end]) or any(left_dc[y4:y_end])
            ctx = 7 + above + left + (3 if pw * ph > w * h else 0)
        if sd.symbol(cdf["txb_skip"][tx_ctx][ctx]):
            above_level[x4:x_end] = above_dc[x4:x_end] = [0] * (x_end - x4)
            left_level[y4:y_end] = left_dc[y4:y_end] = [0] * (y_end - y4)
            return None
        tx_type = self._tx_type(b, plane, tx)
        tx_class = _TX_CLASS.get(tx_type, 0)
        scan, base_nb, base_off, br_nb, br_off, eob_8, eob_4, size_ctx, name = \
            _contexts(w, h, tx_class)
        if not b.lossless:
            self.seen.update((name, _TX_TYPE_NAMES[tx_type]))
        eob_pt = sd.symbol(cdf["eob_pt"][size_ctx][ptype][1 if tx_class else 0]) + 1
        eob = eob_pt if eob_pt < 2 else (1 << (eob_pt - 2)) + 1
        if eob_pt >= 3:
            if sd.symbol(cdf["eob_extra"][tx_ctx][ptype][eob_pt - 3]):
                eob += 1 << (eob_pt - 3)
            for i in range(1, eob_pt - 2):
                if sd.literal(1):
                    eob += 1 << (eob_pt - 3 - i)
        quant = [0] * (min(w, 32) * min(h, 32))
        base_cdf = cdf["coeff_base"][tx_ctx][ptype]
        br_cdf = cdf["coeff_br"][min(tx_ctx, 3)][ptype]
        eob_cdf = cdf["coeff_base_eob"][tx_ctx][ptype]
        # The level and sign loops run the symbol decoder inline (as
        # SymbolDecoder.symbol and .literal do) on local copies of its state.
        rng, window, ahead, nxt = sd.rng, sd.window, sd.ahead, sd.next
        inv, update = sd.inv, sd.update
        for c in range(eob - 1, -1, -1):
            pos = scan[c]
            if c == eob - 1:
                row = eob_cdf[0 if c == 0 else 1 if c <= eob_8 else 2 if c <= eob_4 else 3]
                level = 1
            else:
                offset = base_off[pos]
                if offset < 0:
                    row = base_cdf[0]
                else:
                    mag = 0
                    for k in base_nb[pos]:
                        q = quant[k]
                        mag += q if q < 3 else 3
                    row = base_cdf[(4 if mag > 6 else (mag + 1) >> 1) + offset]
                level = 0
            steps = 1
            while steps:
                n = len(row) - 1
                value = window >> ahead
                r8 = rng >> 8
                prev = rng
                cur = ((r8 * ((32768 - row[0]) >> 6)) >> 1) + 4 * (n - 1)
                sym = 0
                while value < cur:
                    sym += 1
                    prev = cur
                    cur = ((r8 * ((32768 - row[sym]) >> 6)) >> 1) + 4 * (n - sym - 1)
                rng = prev - cur
                window -= cur << ahead
                bits = 16 - rng.bit_length()
                rng <<= bits
                ahead -= bits
                if ahead < 16:
                    if nxt + 6 > len(inv):
                        inv += b"\xff" * 4096
                    window = (window << 48) | int.from_bytes(inv[nxt:nxt + 6], "big")
                    nxt += 6
                    ahead += 48
                if update:
                    count = row[n]
                    rate = 3 + (count > 15) + (count > 31) + (2 if n > 3 else 1)
                    for i in range(sym):
                        row[i] -= row[i] >> rate
                    for i in range(sym, n - 1):
                        row[i] += (32768 - row[i]) >> rate
                    if count < 32:
                        row[n] = count + 1
                level += sym
                if steps == 1:
                    if level <= 2:
                        break
                    mag = 0
                    for k in br_nb[pos]:
                        q = quant[k]
                        mag += q if q < 15 else 15
                    row = br_cdf[(6 if mag > 10 else (mag + 1) >> 1) + br_off[pos]]
                    steps = 2
                elif sym < 3 or steps == 5:
                    break
                else:
                    steps += 1
            quant[pos] = level
        cul_level = 0
        dc_category = 0
        for c in range(eob):
            pos = scan[c]
            level = quant[pos]
            if not level:
                continue
            if c == 0:
                dc_sign = 0
                for s in above_dc[x4:x_end] + left_dc[y4:y_end]:
                    dc_sign += -1 if s == 1 else 1 if s == 2 else 0
                sd.rng, sd.window, sd.ahead, sd.next, sd.inv = rng, window, ahead, nxt, inv
                sign = sd.symbol(cdf["dc_sign"][ptype][1 if dc_sign < 0 else 2 if dc_sign > 0
                                                       else 0])
                rng, window, ahead, nxt, inv = sd.rng, sd.window, sd.ahead, sd.next, sd.inv
            else:
                cur = ((rng >> 8) << 7) + 4
                if window >> ahead >= cur:
                    sign = 0
                    rng -= cur
                    window -= cur << ahead
                else:
                    sign = 1
                    rng = cur
                bits = 16 - rng.bit_length()
                rng <<= bits
                ahead -= bits
                if ahead < 16:
                    if nxt + 6 > len(inv):
                        inv += b"\xff" * 4096
                    window = (window << 48) | int.from_bytes(inv[nxt:nxt + 6], "big")
                    nxt += 6
                    ahead += 48
            if level > 14:
                self.seen.add("golomb")
                sd.rng, sd.window, sd.ahead, sd.next, sd.inv = rng, window, ahead, nxt, inv
                length = 0
                while True:
                    length += 1
                    if sd.literal(1):
                        break
                    if length >= 32:
                        raise ValueError("AV1 coefficient Golomb code is too long")
                level = sd.literal(length - 1) + (1 << (length - 1)) + 14
                rng, window, ahead, nxt, inv = sd.rng, sd.window, sd.ahead, sd.next, sd.inv
            if pos == 0:
                dc_category = 1 if sign else 2
            level &= 0xFFFFF
            cul_level += level
            quant[pos] = -level if sign else level
        sd.rng, sd.window, sd.ahead, sd.next, sd.inv = rng, window, ahead, nxt, inv
        cul_level = min(63, cul_level)
        above_level[x4:x_end] = [cul_level] * (x_end - x4)
        above_dc[x4:x_end] = [dc_category] * (x_end - x4)
        left_level[y4:y_end] = [cul_level] * (y_end - y4)
        left_dc[y4:y_end] = [dc_category] * (y_end - y4)
        return quant, tx_type

    def _reconstruct(self, b, plane: int, x: int, y: int, tx: tuple, quant: list,
                     tx_type: int) -> None:
        """Dequantisation, the inverse transform and the sum with the
        prediction, clipped to 8 bits."""
        w, h = tx
        dc_q, ac_q = self.f.quantisers[b.segment_id][plane]
        frame = self.f.planes[plane]
        coef = np.array(quant, np.int64).reshape(min(h, 32), min(w, 32))
        residual = X.inverse_transform_2d(X.dequantise(coef, dc_q, ac_q, w, h), w, h, tx_type)
        pred = np.array([frame[y + i][x:x + w] for i in range(h)], np.int64)
        out = np.clip(pred + residual, 0, 255).tolist()
        for i in range(h):
            frame[y + i][x:x + w] = out[i]

    def _reconstruct_wht(self, frame, x: int, y: int, quant: list) -> None:
        """A lossless block's 4x4: dequantisation at qindex 0 (a factor of
        4), the inverse WHT and the sum with the prediction, clipped to the
        bit depth."""
        if max(quant) >= 8192 or min(quant) <= -8192:
            # The factor of 4 meets the 24-bit mask and the clamp to
            # +-2^(7 + BitDepth); the row pass's shift of 2 takes it back.
            limit = 1 << (7 + self.seq.bit_depth)
            quant = [max(-limit, min(limit - 1, -((-q * 4) & 0xFFFFFF) if q < 0
                                     else (q * 4) & 0xFFFFFF)) >> 2 for q in quant]
        rows = []
        for i in range(0, 16, 4):
            a, c, d, b = quant[i], quant[i + 1], quant[i + 2], quant[i + 3]
            a += c
            d -= b
            e = (a - d) >> 1
            b = e - b
            c = e - c
            rows.append((a - b, b, c, d + c))
        top = (1 << self.seq.bit_depth) - 1
        r0, r1, r2, r3 = rows
        out = (frame[y], frame[y + 1], frame[y + 2], frame[y + 3])
        for j in range(4):
            a, c, d, b = r0[j], r1[j], r2[j], r3[j]
            a += c
            d -= b
            e = (a - d) >> 1
            b = e - b
            c = e - c
            for row, value in zip(out, (a - b, b, c, d + c)):
                v = row[x + j] + value
                row[x + j] = v if 0 <= v <= top else (0 if v < 0 else top)


def _split_tx(tx: tuple) -> tuple:
    """Split_Tx_Size: a square transform halves both sides, a rectangle its
    longer one; 4x4 stays."""
    w, h = tx
    if w == h:
        return (max(4, w >> 1), max(4, h >> 1))
    return (w >> 1, h) if w > h else (w, h >> 1)


# TxType -> tx class: V_DCT vertical (2), H_DCT horizontal (1), the others 2-D.
_TX_CLASS = {10: 2, 11: 1}
_TX_TYPE_NAMES = [f"tx_type {t}" for t in range(16)]
# The transform size context of the coefficient CDFs: the mean of the
# square sizes below and above, rounded up (4x4 0 .. 64x64 4).
_TX_SIZE_CTX = {(w, h): (LOG2[min(w, h)] + LOG2[max(w, h)] - 3) >> 1
                for w in (4, 8, 16, 32, 64) for h in (4, 8, 16, 32, 64)}


@functools.lru_cache(maxsize=None)
def _contexts(w: int, h: int, tx_class: int) -> tuple:
    """The scan and coefficient contexts of a w x h transform of one tx
    class, over the coded min(w, 32) x min(h, 32) in raster order: each
    position's neighbours that get_coeff_base_ctx sums and its offset (-1
    for the 2-D DC, whose context is 0), the coeff_br neighbours and
    offset, the eob positions up to which coeff_base_eob takes contexts 1
    and 2, the eob_pt CDF's size (16 to 1024 coefficients as 0 to 6), and
    the name ``seen`` takes."""
    cw, ch = min(w, 32), min(h, 32)
    kind = ("default", "col", "row")[tx_class]
    scan = T.SCANS[f"{cw}x{ch} {kind}"]
    shape = 0 if w == h else 1 if w > h else 2
    base_nb, base_off, br_nb, br_off = [], [], [], []
    for pos in range(cw * ch):
        row, col = divmod(pos, cw)
        base_nb.append([(row + dr) * cw + col + dc for dr, dc in T.SIG_REF_DIFF_OFFSET[tx_class]
                        if row + dr < ch and col + dc < cw])
        br_nb.append([(row + dr) * cw + col + dc for dr, dc in T.MAG_REF_OFFSET[tx_class]
                      if row + dr < ch and col + dc < cw])
        if tx_class == 0:
            base_off.append(-1 if pos == 0 else
                            T.COEFF_BASE_CTX_OFFSET[shape][min(row, 4)][min(col, 4)])
            near = row < 2 and col < 2
        else:
            along = col if tx_class == 1 else row
            base_off.append(T.COEFF_BASE_POS_CTX_OFFSET[min(along, 2)])
            near = along == 0
        br_off.append(0 if pos == 0 else 7 if near else 14)
    size_ctx = LOG2[cw] + LOG2[ch] - 4
    return (scan, base_nb, base_off, br_nb, br_off, cw * ch // 8, cw * ch // 4, size_ctx,
            f"tx {w}x{h}")


def _uv_tx(bsize: int, subx: int, suby: int) -> tuple:
    """get_tx_size for chroma: the largest transform of the chroma block,
    with 64 taken down to 32."""
    w, h = BLOCK_DIMS[_residual_size(bsize, subx, suby)]
    w, h = min(w, 64), min(h, 64)
    if w == 64 or h == 64:
        return (16, 32) if w == 16 else (32, 16) if h == 16 else (32, 32)
    return (w, h)


def _edge_strength(w: int, h: int, filter_type: int, delta: int) -> int:
    d = abs(delta)
    wh = w + h
    if filter_type:
        if wh <= 8:
            return 2 if d >= 64 else 1 if d >= 40 else 0
        if wh <= 16:
            return 2 if d >= 48 else 1 if d >= 20 else 0
        if wh <= 24:
            return 3 if d >= 4 else 0
        return 3
    if wh <= 8:
        return 1 if d >= 56 else 0
    if wh <= 16:
        return 1 if d >= 40 else 0
    if wh <= 24:
        return 3 if d >= 32 else 2 if d >= 16 else 1 if d >= 8 else 0
    if wh <= 32:
        return 3 if d >= 32 else 2 if d >= 4 else 1
    return 3


def _use_upsample(w: int, h: int, filter_type: int, delta: int) -> int:
    d = abs(delta)
    if d <= 0 or d >= 40:
        return 0
    return int(w + h <= (8 if filter_type else 16))


class _Block:
    __slots__ = ("r", "c", "bsize", "has_chroma", "avail_u", "avail_l", "avail_uc", "avail_lc",
                 "skip", "segment_id", "y_mode", "uv_mode", "angle_y", "angle_uv", "cfl_u",
                 "cfl_v", "palette_y", "palette_uv", "palette_u", "map_y", "map_uv",
                 "filter_intra", "max_luma_w", "max_luma_h", "lossless", "tx")

    def __init__(self, r, c, bsize, has_chroma, avail_u, avail_l, avail_uc, avail_lc):
        self.r, self.c, self.bsize, self.has_chroma = r, c, bsize, has_chroma
        self.avail_u, self.avail_l = avail_u, avail_l
        self.avail_uc, self.avail_lc = avail_uc, avail_lc
        self.palette_u = ()
        self.max_luma_w = self.max_luma_h = 0


def decode(data: bytes, seen: set = None):
    """Decodes the first shown intra frame of an AV1 OBU stream (the
    "low overhead" format AVIF items hold). Returns ``(planes, sequence
    header)``: the Y plane and, unless the stream is monochrome, the U and
    V planes, as uint8 arrays of the frame's size. ``seen``, where given,
    gains the name of each coding tool the decode reached ("partition 3",
    "y_mode 12", "palette_y", ...)."""
    seen = set() if seen is None else seen
    seq = None
    frame = None
    pos = 0
    while pos < len(data):
        header = data[pos]
        if header & 0x80:
            raise ValueError("AV1 OBU forbidden bit is set")
        obu_type = (header >> 3) & 0xF
        extension = (header >> 2) & 1
        has_size = (header >> 1) & 1
        pos += 1
        temporal_id = spatial_id = 0
        if extension:
            if pos >= len(data):
                raise ValueError("AV1 OBU header runs past the end of the data")
            temporal_id, spatial_id = data[pos] >> 5, (data[pos] >> 3) & 3
            pos += 1
        if has_size:
            size, pos = leb128(data, pos)
        else:
            size = len(data) - pos
        end = pos + size
        if end > len(data):
            raise ValueError("AV1 OBU runs past the end of the data")
        if obu_type == OBU_SEQUENCE_HEADER:
            seq = SequenceHeader(data[pos:end])
            if seq.bit_depth > 8:
                raise NotImplementedError(f"AV1 at bit depth {seq.bit_depth} (above 8)")
        elif obu_type in (OBU_FRAME_HEADER, OBU_FRAME) and frame is None:
            if seq is None:
                raise ValueError("AV1 frame header before any sequence header")
            frame = Frame(seq, data[:end], pos, temporal_id, spatial_id, seen)
            if obu_type == OBU_FRAME:
                r = frame.header_end
                r.byte_alignment()
                if frame.decode_tile_group(data[:end], r.byte_pos, end):
                    break
        elif obu_type == OBU_TILE_GROUP:
            if frame is None:
                raise ValueError("AV1 tile group before any frame header")
            if frame.decode_tile_group(data[:end], pos, end):
                break
        pos = end
    else:
        raise ValueError("AV1 stream ends before its frame's last tile")
    if not frame.show_frame and not frame.showable:
        raise NotImplementedError("AV1 frame that is not shown: frames other than intra frames")
    return frame.output(), seq
