"""Port parity: ``tools.read`` of PSD, QOI, SGI, Sun raster, ICNS, IM, MSP,
XBM and XPM files (``keras_ocr_tpu_torch/rasters.py``).

JAX's ``tools.read`` is PIL's ``Image.open(f).convert("RGB")``; the
port's decodes must equal it bit for bit:

* every committed fixture of ``tests/fixtures/rasters`` (written by
  ``scripts/make_raster_fixtures.py``) by path and by buffer, at the
  sha256 of PIL's decode in ``hashes.json`` and against JAX's ``read``;
  the large files the script writes at run time (the golden scenes as
  PackBits PSD and QOI, scene 3 as raw PSD and RLE SGI, a 640x480
  photo), written here from the port's reads of the sources;
* files written here by the script's writers and PIL's: each colour mode,
  compression, depth, file type, op and header variant, PIL's quirks
  included (PackBits runs cut at a row's end, QOI index misses, SGI RLE
  rows that keep the last row's tail or stop the decode, Sun runs across
  rows, IM's bit decoder and ``Lut``, XPM pixels as a stream);
* what PIL refuses raises ``NotImplementedError`` or ``ValueError``;
  files cut short end as PIL's end (both raise, or both decode alike);
* the dispatch follows PIL's ``Image.ID`` order: the table's order, DIB
  against TGA, and IM's opener (PIL's verdict on JPEG, TGA, text and IM
  headers);
* PIL's Lab -> RGB conversion (LittleCMS) on a quarter million Lab
  triples.
"""

import hashlib
import io
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image, ImImagePlugin

from keras_ocr_tpu import tools as jtools
from keras_ocr_tpu_torch import rasters, tools

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_raster_fixtures as mf  # noqa: E402
from make_image_fixtures import scene, write_pcx, write_tga  # noqa: E402

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
RASTERS = os.path.join(HERE, "fixtures", "rasters")
with open(os.path.join(RASTERS, "hashes.json"), encoding="utf8") as _f:
    HASHES = json.load(_f)
COMMITTED = sorted(n for n, h in HASHES.items() if not h.get("written_at_run_time"))
LARGE = sorted(n for n, h in HASHES.items() if h.get("written_at_run_time"))

RNG = np.random.RandomState(26)
RGB = scene(19, 23, seed=4)
GREY = np.asarray(Image.fromarray(RGB).convert("L"))
PALETTE = RNG.randint(0, 256, (256, 3)).astype(np.uint8)


def _pil_rgb(blob):
    with Image.open(io.BytesIO(blob)) as image:
        return np.array(image.convert("RGB"))


def _pil(image, fmt, **kwargs):
    out = io.BytesIO()
    image.save(out, fmt, **kwargs)
    return out.getvalue()


def _sha(array):
    return hashlib.sha256(array.tobytes()).hexdigest()


# ---------------------------------------------------------------------------
# Generated cases
# ---------------------------------------------------------------------------


def _psd_cases():
    cases = {}
    planes = {"RGB": mf.rgb_planes(RGB), "grey": GREY[None], "multichannel": GREY[None],
              "duotone": GREY[None], "indexed": (GREY // 2)[None],
              "CMYK": mf.rgb_planes(np.concatenate([RGB, GREY[..., None]], -1)),
              "Lab": mf.rgb_planes(RGB)}
    palette = np.ascontiguousarray(PALETTE.T).tobytes()
    for colour, data in planes.items():
        extra = {"colour_data": palette} if colour == "indexed" else {}
        for k in (0, 1):
            cases[f"psd_{colour}_{k}"] = lambda d=data, c=colour, k=k, e=extra: mf.write_psd(
                d, c, compression=k, **e)
    rgba = np.concatenate([mf.rgb_planes(RGB), GREY[None]])
    five = np.concatenate([rgba, (GREY // 3)[None]])
    for compression in (0, 1):
        cases[f"psd_rgba_{compression}"] = lambda k=compression: mf.write_psd(rgba, "RGB",
                                                                               compression=k)
        # A fifth channel: ignored raw; PackBits data PIL starts reading
        # before the fifth channel's row counts end.
        cases[f"psd_rgb_five_channels_{compression}"] = lambda k=compression: mf.write_psd(
            five, "RGB", compression=k)
        cases[f"psd_cmyk_five_channels_{compression}"] = lambda k=compression: mf.write_psd(
            five, "CMYK", compression=k)
        cases[f"psd_grey_two_channels_{compression}"] = lambda k=compression: mf.write_psd(
            five[:2], "grey", compression=k)
    for width in (1, 7, 8, 9, 23):
        bits = np.packbits(GREY[:, :width] > 110, axis=1)
        for compression in (0, 1):
            cases[f"psd_bitmap_w{width}_{compression}"] = lambda b=bits, w=width, k=compression: \
                mf.write_psd(b[None], "bitmap", bits=1, width=w, compression=k)
    cases["psd_indexed_short_palette"] = lambda: mf.write_psd((GREY // 2)[None], "indexed",
                                                              colour_data=palette[:300])
    cases["psd_indexed_no_palette"] = lambda: mf.write_psd((GREY // 2)[None], "indexed")
    resources = mf.psd_resources((1005, b"", bytes(16)), (1039, b"ab", bytes(7)),
                                 (1036, b"odd", bytes(9)), (1060, b"x" * 10, bytes(1)))
    cases["psd_resources_layers"] = lambda: mf.write_psd(mf.rgb_planes(RGB), "RGB",
                                                         resources=resources,
                                                         layers=mf.psd_layers())
    cases["psd_resources_layers_raw"] = lambda: mf.write_psd(
        mf.rgb_planes(RGB), "RGB", compression=0, resources=resources, layers=bytes(5))
    # Rows written as odd PackBits: runs and literals past a row's end,
    # no-ops between packets, a literal of 128.
    row = GREY.shape[1]

    def odd_packbits():
        out = bytearray()
        for y in range(GREY.shape[0]):
            values = GREY[y].tobytes()
            out += bytes([0x80, 9]) + values[:10] + bytes([0x80])
            out += bytes([257 - 30, values[10]])  # a run of 30 cut at the row's end
        return out

    def with_stream(stream, counts):
        head = bytearray(mf.write_psd(GREY[None], "grey", compression=0)[:-row * GREY.shape[0]])
        head[-2:] = b"\x00\x01"
        return bytes(head) + struct.pack(f">{len(counts)}H", *counts) + bytes(stream)

    stream = odd_packbits()
    cases["psd_packbits_runs_past_rows"] = lambda: with_stream(stream, [0] * GREY.shape[0])
    wide = np.tile(GREY, (1, 7))

    def long_literals():
        head = bytearray(mf.write_psd(wide[None], "grey", compression=0)[:-wide.size])
        head[-2:] = b"\x00\x01"
        body = b"".join(bytes([127]) + r.tobytes()[:128] + bytes([r.size - 129])
                        + r.tobytes()[128:] for r in wide)
        return bytes(head) + bytes(2 * wide.shape[0]) + body

    cases["psd_packbits_literals_of_128"] = long_literals
    return cases


def _qoi_cases():
    cases = {}
    rgba = np.concatenate([RGB, GREY[..., None]], -1)
    cases["qoi_pil_rgb"] = lambda: _pil(Image.fromarray(RGB), "QOI")
    cases["qoi_pil_rgba"] = lambda: _pil(Image.fromarray(rgba), "QOI")
    cases["qoi_encoder_rgb"] = lambda: mf.qoi_encode(RGB)
    cases["qoi_encoder_rgba"] = lambda: mf.qoi_encode(rgba)
    flat = np.zeros((9, 70, 3), np.uint8)
    flat[4:] = 200
    cases["qoi_long_runs"] = lambda: mf.qoi_encode(flat)
    cases["qoi_rgba_as_3_channels"] = lambda: mf.qoi_encode(rgba, channels=3)
    cases["qoi_channels_byte_5"] = lambda: mf.qoi_encode(rgba, channels=5)
    # Hand-made op streams: an index miss reads (0, 0, 0, 0); a run at the
    # start repeats opaque black without entering the index; wrap-around
    # in DIFF and LUMA; a run longer than the pixels left.
    ops = (bytes([0xC2, 0x35, 0x00, 0xFE, 250, 3, 128, 0x40, 0x7F, 0x80, 0x0F, 0xBF, 0xFF,
                  0xFF, 1, 2, 3, 4, 0x12, 0xFF, 9, 9, 9, 0, 0xC0 | 61, 0x2F, 0x3F]) * 4)
    cases["qoi_hand_ops"] = lambda: mf.qoi_header(7, 9, 3) + ops + mf.QOI_END
    cases["qoi_hand_ops_rgba"] = lambda: mf.qoi_header(7, 9, 4) + ops + mf.QOI_END
    # The opening run's black is not in the index: slot 53 misses, so the
    # next pixels are transparent and hash elsewhere than opaque ones.
    cases["qoi_opening_run_outside_index"] = lambda: mf.qoi_header(7, 1, 3) + bytes(
        [0xC2, 0x35, 0x7F, 0x0F, 0x04]) + mf.QOI_END
    return cases


def _sgi_cases():
    cases = {}
    wide = (RGB.astype(np.uint16) * 257 + RNG.randint(0, 256, RGB.shape)).astype(np.uint16)
    rgba = np.concatenate([RGB, GREY[..., None]], -1)
    wide_rgba = np.concatenate([wide, wide[..., :1] // 3], -1)
    for label, pixels, bpc in (("grey", GREY, 1), ("rgb", RGB, 1), ("rgba", rgba, 1),
                               ("grey16", wide[..., 0], 2), ("rgb16", wide, 2),
                               ("rgba16", wide_rgba, 2)):
        cases[f"sgi_{label}_verbatim"] = lambda p=pixels, b=bpc: mf.write_sgi(p, bpc=b)
        cases[f"sgi_{label}_rle"] = lambda p=pixels, b=bpc: mf.write_sgi(p, bpc=b, rle=True)
    cases["sgi_rle_shared_rows"] = lambda: mf.write_sgi(np.repeat(GREY[:3], 5, 0), rle=True,
                                                        share_rows=True)
    cases["sgi_grey_dimension_1"] = lambda: mf.write_sgi(GREY[:1], dimension=1)
    cases["sgi_grey_dimension_1_tall"] = lambda: mf.write_sgi(GREY, dimension=1)
    for mode in ("L", "RGB", "RGBA"):
        cases[f"sgi_pil_{mode}"] = lambda m=mode: _pil(Image.fromarray(rgba).convert(m), "SGI")
    cases["sgi_pil_rgb_16"] = lambda: _pil(Image.fromarray(RGB), "SGI", bpc=2)
    # A row ended early keeps the row buffer's tail from the row below; a
    # row whose counted packets end on a non-zero byte stops the decode.
    short = {(0, 5): bytes([3, 7, 0]), (1, 5): bytes([0x82, 1, 2, 0])}
    cases["sgi_rle_short_rows"] = lambda: mf.write_sgi(RGB, rle=True, rows=short)
    cases["sgi_rle_stops"] = lambda: mf.write_sgi(RGB, rle=True, lengths={(0, 9): 2})
    # What PIL does not read: dimension 3 with 1 or 2 channels, 5
    # channels, 3 bytes a sample, compression 2, a row past a row's end.
    cases["sgi_grey_dimension_3"] = lambda: mf.write_sgi(GREY, dimension=3)
    cases["sgi_two_channels"] = lambda: mf.write_sgi(RGB[..., :2].copy())
    cases["sgi_compression_2"] = lambda: mf.sgi_header(4, 4, 1, 1, 2) + bytes(16)
    cases["sgi_rle_row_too_long"] = lambda: mf.write_sgi(GREY[:, :5], rle=True,
                                                         rows={(0, 2): bytes([6, 9, 0])})
    cases["sgi_rle_offset_in_header"] = lambda: mf.write_sgi(GREY, rle=True).replace(
        mf.write_sgi(GREY, rle=True)[512:516], struct.pack(">I", 100), 1)
    return cases


def _sun_cases():
    cases = {}
    for kind in (0, 1, 2, 3, 4, 5):
        for width in (23, 22, 1):
            grey, rgb = GREY[:, :width], RGB[:, :width]
            cases[f"sun_1_t{kind}_w{width}"] = lambda g=grey, k=kind: mf.write_sun(g > 100, 1,
                                                                                    kind=k)
            cases[f"sun_4_t{kind}_w{width}"] = lambda g=grey, k=kind: mf.write_sun(g // 16, 4,
                                                                                    kind=k)
            cases[f"sun_8_t{kind}_w{width}"] = lambda g=grey, k=kind: mf.write_sun(g, 8, kind=k)
            cases[f"sun_24_t{kind}_w{width}"] = lambda r=rgb, k=kind: mf.write_sun(r, 24, kind=k)
            cases[f"sun_32_t{kind}_w{width}"] = lambda r=rgb, k=kind: mf.write_sun(r, 32, kind=k)
    cases["sun_rle_padded_rows"] = lambda: mf.write_sun(GREY, 8, kind=2, padded=True)
    noise = RNG.randint(0, 256, (5, 9)).astype(np.uint8)
    noise[1, 2:7] = 0x80
    noise[3, 3] = 0x80
    cases["sun_rle_0x80"] = lambda: mf.write_sun(noise, 8, kind=2)
    cases["sun_rle_run_across_rows"] = lambda: mf.write_sun(
        GREY[:4, :9], 8, kind=2, data=bytes([0x80, 29, 77, 1, 2, 0x80, 0, 3, 4, 5, 6]))
    for entries in (2, 16, 100, 256):
        cases[f"sun_8_map_{entries}"] = lambda n=entries: mf.write_sun(GREY.astype(int) % n, 8,
                                                                       palette=PALETTE[:n])
    cases["sun_4_map_16_rle"] = lambda: mf.write_sun(GREY // 16, 4, kind=2,
                                                     palette=PALETTE[:16])
    cases["sun_8_map_odd_length"] = lambda: mf.write_sun(GREY, 8, map_bytes=bytes(range(50)))
    for size in (770, 771, 1024):
        cases[f"sun_8_map_{size}_bytes"] = lambda n=size: mf.write_sun(GREY, 8, map_bytes=bytes(
            (np.arange(n) % 251).astype(np.uint8)))
    cases["sun_1_with_map"] = lambda: mf.write_sun(GREY > 99, 1, palette=PALETTE[:2])
    cases["sun_24_with_map"] = lambda: mf.write_sun(RGB, 24, palette=PALETTE[:8])
    # What PIL does not read: other depths, file types, map types, maps
    # over 1024 bytes.
    cases["sun_depth_16"] = lambda: mf.write_sun(GREY, 8, data=bytes(2 * 19 * 24))[:12] + \
        struct.pack(">I", 16) + mf.write_sun(GREY, 8, data=bytes(2 * 19 * 24))[16:]
    cases["sun_type_6"] = lambda: mf.write_sun(GREY, 8, kind=6)
    cases["sun_map_type_2"] = lambda: mf.write_sun(GREY, 8, palette=PALETTE[:16], map_type=2)
    cases["sun_map_1025_bytes"] = lambda: mf.write_sun(GREY, 8, map_bytes=bytes(1025))
    return cases


def _icns_cases():
    cases = {}
    icons = {size: scene(size, size, seed=size) for size in (16, 32, 48, 128)}
    masks = {size: RNG.randint(0, 256, (size, size)).astype(np.uint8).tobytes()
             for size in icons}
    rle = {16: (b"is32", b"s8mk"), 32: (b"il32", b"l8mk"), 48: (b"ih32", b"h8mk"),
           128: (b"it32", b"t8mk")}
    for size, (kind, mask) in rle.items():
        for raw in (False, True):
            body = mf.icns_rgb(icons[size], kind, raw=raw)
            cases[f"icns_{kind.decode()}_{'raw' if raw else 'rle'}"] = \
                lambda k=kind, b=body, m=mask, s=size: mf.write_icns([(k, b), (m, masks[s])])
            cases[f"icns_{kind.decode()}_{'raw' if raw else 'rle'}_no_mask"] = \
                lambda k=kind, b=body: mf.write_icns([(k, b)])
    every = [(k, mf.icns_rgb(icons[s], k)) for s, (k, _) in rle.items()]
    cases["icns_largest_of_four"] = lambda: mf.write_icns(every)
    cases["icns_largest_of_four_reversed"] = lambda: mf.write_icns(every[::-1])
    png = {mode: _pil(Image.fromarray(scene(32, 32, seed=3)).convert(mode), "PNG")
           for mode in ("1", "L", "P", "RGB", "RGBA", "LA")}
    for mode, blob in png.items():
        cases[f"icns_png_{mode}"] = lambda b=blob: mf.write_icns([(b"icp5", b)])
    cases["icns_png_beside_rle"] = lambda: mf.write_icns([(b"il32", every[1][1]),
                                                          (b"icp5", png["RGB"])])
    cases["icns_png_retina_16"] = lambda: mf.write_icns([(b"ic11", png["RGB"])])
    cases["icns_png_half_size"] = lambda: mf.write_icns([(b"ic07", png["RGB"])])
    cases["icns_png_size_fits_none"] = lambda: mf.write_icns([(b"icp4", _pil(
        Image.fromarray(scene(20, 20, seed=2)), "PNG"))])
    for mode in ("L", "RGB", "RGBA", "LA"):
        cases[f"icns_jp2_{mode}"] = lambda m=mode: mf.write_icns([(b"icp5", _pil(
            Image.fromarray(scene(32, 32, seed=5)).convert(m), "JPEG2000"))])
    cases["icns_j2k"] = lambda: mf.write_icns([(b"icp5", _pil(
        Image.fromarray(scene(32, 32, seed=5)), "JPEG2000", no_jp2=True))])
    cases["icns_header_short_total"] = lambda: mf.write_icns(every[:2], total=8)
    cases["icns_duplicate_entry"] = lambda: mf.write_icns([every[1], (b"il32", mf.icns_rgb(
        scene(32, 32, seed=99), b"il32"))])
    # What PIL does not read: no 32-bit icon; a run past a channel's end;
    # an it32 without its zero bytes; a mask without colour; an entry
    # neither PNG nor JPEG 2000; a zero-length entry header.
    cases["icns_only_old_icons"] = lambda: mf.write_icns([(b"ICN#", bytes(256))])
    cases["icns_rle_overrun"] = lambda: mf.write_icns([(b"is32", bytes([0xFF, 1]) * 3)])
    cases["icns_it32_no_zeros"] = lambda: mf.write_icns([(b"it32", mf.icns_rgb(
        icons[128], b"is32"))])
    cases["icns_mask_only"] = lambda: mf.write_icns([(b"s8mk", masks[16])])
    cases["icns_not_png"] = lambda: mf.write_icns([(b"icp5", b"GIF89a" + bytes(30))])
    cases["icns_zero_entry"] = lambda: b"icns" + struct.pack(">I", 24) + b"is32" + bytes(12)
    return cases


def _im_planes(image, bands):
    return np.stack([image[::-1, :, k] for k in bands], 1).tobytes()


def _im_cases():
    cases = {}
    h, w = GREY.shape
    flipped = GREY[::-1]
    wide = RNG.randint(0, 1 << 16, (h, w))
    noise = RNG.randint(0, 256, (h, 4 * w)).astype(np.uint8)
    image = Image.fromarray(RGB)
    for mode in ("1", "L", "LA", "P", "PA", "I", "I;16", "I;16L", "I;16B", "F", "RGB", "RGBA",
                 "RGBX", "CMYK", "YCbCr"):
        converted = image.convert(mode) if mode not in ("I;16", "I;16L", "I;16B") else \
            Image.fromarray(wide.astype(np.uint16) % 300).convert(mode)
        cases[f"im_pil_{mode}"] = lambda c=converted: _pil(c, "IM")
    rows = {"1": np.packbits(flipped > 100, axis=1), "L": flipped,
            "P;2": np.packbits(((flipped // 64)[..., None] >> np.arange(1, -1, -1) & 1).reshape(
                h, -1), axis=1),
            "P;4": np.packbits(((flipped // 16)[..., None] >> np.arange(3, -1, -1) & 1).reshape(
                h, -1), axis=1)}
    for kind, (mode, rawmode) in sorted(ImImagePlugin.OPEN.items()):
        if rawmode in rows:
            data = rows[rawmode].tobytes()
        elif rawmode in ("RGB", "RLB"):
            data = RGB[::-1].tobytes()
        elif rawmode in ("RGB;T", "RYB;T"):
            data = np.stack([RGB[::-1, :, 1], RGB[::-1, :, 0], RGB[::-1, :, 2]]).tobytes()
        elif rawmode.endswith(";L"):
            bands = {"RGB;L": 3, "YCbCr;L": 3, "LA;L": 2, "PA;L": 2}.get(rawmode, 4)
            data = np.concatenate([RGB[::-1], GREY[::-1, :, None]], -1)[..., :bands]
            data = np.ascontiguousarray(data.transpose(0, 2, 1)).tobytes()
        elif rawmode[2:].isdigit() and int(rawmode[2:]) not in (8, 16, 32):
            bits = int(rawmode[2:])
            data = mf._im_bits((wide[::-1] >> max(0, 16 - bits)) % (1 << bits) * 1 + 0, bits)
        else:
            data = noise.tobytes()
        cases[f"im_{kind.replace(' ', '_').replace('*', 'x')}"] = \
            lambda k=kind, d=data: mf.write_im(k, w, h, d)
    lut = PALETTE
    grey_lut = np.repeat(np.arange(256)[::-1, None], 3, 1)
    for label, kind, data in (("greyscale", "Greyscale image", flipped.tobytes()),
                              ("b4", "B4 image", flipped.tobytes()),
                              ("la", "LA image", _im_planes(np.stack([GREY, GREY // 2], -1),
                                                            (0, 1)))):
        cases[f"im_{label}_lut"] = lambda k=kind, d=data: mf.write_im(k, w, h, d, lut=lut)
        cases[f"im_{label}_grey_lut"] = lambda k=kind, d=data: mf.write_im(k, w, h, d,
                                                                          lut=grey_lut)
    cases["im_rgb_lut"] = lambda: mf.write_im("RGB image", w, h, _im_planes(RGB, (0, 1, 2)),
                                              lut=lut)
    cases["im_unpadded_header"] = lambda: mf.write_im("Greyscale image", w, h,
                                                      flipped.tobytes(), pad=False)
    cases["im_comments_and_frames"] = lambda: mf.write_im(
        "RGB image", w, h, _im_planes(RGB, (0, 1, 2)),
        lines=(b"Comment: one", b"Comment: two", b"File size (no of images): 3",
               b"Scale (x,y): 1.5*2", b"Name: fixture.im", b"Unknown key: kept"))
    cases["im_lf_cr_lines"] = lambda: mf.write_im(None, w, h, flipped.tobytes(), header=(
        f"Image type: Greyscale image\n\rImage size (x*y): {w}*{h}\n\r").encode())
    cases["im_default_mode"] = lambda: mf.write_im(None, w, h, flipped.tobytes(), header=(
        f"Image size (x*y): {w}*{h}\r\n").encode())
    cases["im_bare_mode_l"] = lambda: mf.write_im("L", w, h, flipped.tobytes())

    def spare_bits_set(bits):
        # Each row's spare bits set: PIL's bit decoder drops their count at
        # a new row but not the bits, which the next row's first byte meets.
        stride = (w * bits + 7) // 8
        rows = np.frombuffer(mf._im_bits(wide[::-1] % (1 << bits), bits), np.uint8).reshape(
            h, stride).copy()
        rows[:, -1] |= (0xFF << ((w * bits) % 8 or 8)) & 0xFF
        return rows.tobytes()

    for bits in (5, 12, 27):
        cases[f"im_bits_{bits}_spare_bits_set"] = lambda b=bits: mf.write_im(
            f"L*{b} image", w, h, spare_bits_set(b))
    # What PIL does not read: image types without an unpacker, a mode
    # name it does not know, a size that is not a number.
    cases["im_unknown_type"] = lambda: mf.write_im("Fancy image", w, h, flipped.tobytes())
    cases["im_bad_size"] = lambda: mf.write_im(None, w, h, flipped.tobytes(), header=(
        b"Image type: Greyscale image\r\nImage size (x*y): wide*tall\r\n"))
    return cases


def _msp_cases():
    cases = {}
    for width in (23, 16, 5):
        bits = GREY[:, :width] > 110
        cases[f"msp_pil_w{width}"] = lambda b=bits: _pil(Image.fromarray(b), "MSP")
        cases[f"msp_v2_w{width}"] = lambda b=bits: mf.write_msp_v2(b)
        cases[f"msp_v2_literals_w{width}"] = lambda b=bits: mf.write_msp_v2(b, literal_only=True)
    cases["msp_v2_blank_rows"] = lambda: mf.write_msp_v2(GREY > 110, blank_rows=(0, 5, 18))
    cases["msp_v2_long_runs"] = lambda: mf.write_msp_v2(np.ones((3, 2100), bool))
    cases["msp_bad_checksum"] = lambda: b"DanM" + bytes([5, 0, 3, 0]) + bytes(24) + bytes(3)
    return cases


def _xbm_cases():
    cases = {}
    for width in (23, 16, 8, 1):
        bits = GREY[:, :width] > 110
        cases[f"xbm_pil_w{width}"] = lambda b=bits: _pil(Image.fromarray(b), "XBM")
        cases[f"xbm_upper_w{width}"] = lambda b=bits: mf.write_xbm(b, upper=True, per_line=7)
    bits = GREY > 110
    cases["xbm_hotspot"] = lambda: mf.write_xbm(bits, hotspot=(4, 9))
    cases["xbm_leading_space"] = lambda: mf.write_xbm(bits, lead=b"  \n\t")
    cases["xbm_comment_with_x"] = lambda: mf.write_xbm(bits).replace(b"{\n", b"{ /* x1 */\n")
    cases["xbm_short_hex"] = lambda: mf.write_xbm(bits).replace(b"0x0", b"0x", 3)
    cases["xbm_bad_header"] = lambda: b"#define foo 3\n" + bytes(30)
    return cases


def _xpm_cases():
    cases = {}
    colours = [b"#%02x%02x%02x" % tuple(c) for c in PALETTE[:64].tolist()]
    index = GREY // 4
    cases["xpm_one_char"] = lambda: mf.write_xpm(index, colours)
    cases["xpm_two_chars"] = lambda: mf.write_xpm(index, colours, chars=2)
    cases["xpm_other_keys"] = lambda: mf.write_xpm(index, colours, extra_keys=b"m #000000 s sym ")
    cases["xpm_no_pixels_comment"] = lambda: mf.write_xpm(index, colours, pixels_comment=False)
    cases["xpm_comment_lines"] = lambda: mf.write_xpm(index, colours, comment_lines=True)
    cases["xpm_spill"] = lambda: mf.write_xpm(index, colours, spill=3)
    cases["xpm_none_unused"] = lambda: mf.write_xpm(index, colours + [None])
    cases["xpm_long_colours"] = lambda: mf.write_xpm(index, [b"#%012x" % (k * 0x10203040506)
                                                             for k in range(64)])
    many = [b"#%06x" % (k * 7919 % (1 << 24)) for k in range(257)]
    cases["xpm_257_colours"] = lambda: mf.write_xpm(GREY.astype(np.int64) + 1, many, chars=2)
    cases["xpm_duplicate_key"] = lambda: mf.write_xpm(index % 3, colours[:3],
                                                      keys=[b"a", b"b", b"a"])
    # What PIL does not read: a colour name, a pixel of the None colour,
    # a colour line without a c key, too few pixels.
    cases["xpm_named_colour"] = lambda: mf.write_xpm(index % 2, [b"red", b"#00ff00"])
    cases["xpm_none_used"] = lambda: mf.write_xpm(index % 2, [None, b"#00ff00"])
    cases["xpm_no_c_key"] = lambda: mf.write_xpm(index % 2, [b"#00ff00", b"#00ff00"]).replace(
        b" c #", b" g #", 1)
    cases["xpm_short"] = lambda: mf.write_xpm(index, colours)[:-200] + b"};\n"
    return cases


def _dispatch_cases():
    """Files of the formats around the new ones in PIL's order."""
    return {
        "tga_grey": lambda: write_tga(GREY, 3, 8),
        "dcx_grey": lambda: mf.write_dcx([write_pcx(GREY, 8, 1)]),
        "dib_grey": lambda: mf.write_dib(GREY, 8, palette=PALETTE),
    }


CASES = {**_psd_cases(), **_qoi_cases(), **_sgi_cases(), **_sun_cases(), **_icns_cases(),
         **_im_cases(), **_msp_cases(), **_xbm_cases(), **_xpm_cases(), **_dispatch_cases()}

# What PIL does not read, and the port refuses too.
PIL_REFUSES = {
    "sgi_grey_dimension_3", "sgi_two_channels", "sgi_compression_2", "sgi_rle_row_too_long",
    "sgi_rle_offset_in_header", "sun_depth_16", "sun_1_with_map", "sun_24_with_map",
    "sun_8_map_771_bytes", "sun_8_map_1024_bytes", "sun_type_6", "sun_map_type_2",
    "sun_map_1025_bytes", "icns_only_old_icons", "icns_rle_overrun", "icns_it32_no_zeros",
    "icns_mask_only", "icns_not_png", "icns_zero_entry", "icns_png_size_fits_none",
    "icns_header_short_total",
    "im_PA_image", "im_RLB_image", "im_RYB_image", "im_unknown_type", "im_bad_size",
    "msp_bad_checksum", "xbm_bad_header", "xpm_named_colour", "xpm_none_used", "xpm_no_c_key",
    "xpm_short",
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_read_matches_pil(case):
    blob = CASES[case]()
    try:
        ref = _pil_rgb(blob)
    except Exception:
        assert case in PIL_REFUSES
        with pytest.raises((NotImplementedError, ValueError)):
            tools.read(io.BytesIO(blob))
        return
    assert case not in PIL_REFUSES
    ours = tools.read(io.BytesIO(blob))
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["path", "buffer"])
@pytest.mark.parametrize("name", COMMITTED)
def test_fixture_matches_pil(name, variant):
    path = os.path.join(RASTERS, name)
    if variant == "path":
        ours = tools.read(path)
        np.testing.assert_array_equal(ours, jtools.read(path))
    else:
        with open(path, "rb") as f:
            ours = tools.read(io.BytesIO(f.read()))
    assert list(ours.shape) == HASHES[name]["shape"]
    assert _sha(ours) == HASHES[name]["decoded_sha256"]


def test_fixtures_are_the_scripts():
    """The committed files are what the script writes, and small."""
    files = mf.small_fixtures()
    assert sorted(files) == COMMITTED
    for name, blob in files.items():
        with open(os.path.join(RASTERS, name), "rb") as f:
            assert f.read() == blob, name
    assert sum(len(b) for b in files.values()) < 1_000_000


def test_large_files_written_from_the_ports_reads(tmp_path):
    """The large files, written as ``chip_smoke.py`` writes them (the
    sources read by the port), are the script's bytes and decode to PIL's
    pixels; the golden PSD and QOI scenes equal the PNG scenes."""
    paths = mf.write_large(str(tmp_path), read=tools.read)
    assert sorted(paths) == LARGE
    for name, path in paths.items():
        with open(path, "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == HASHES[name]["file_sha256"], name
        ours = tools.read(path)
        assert list(ours.shape) == HASHES[name]["shape"], name
        assert _sha(ours) == HASHES[name]["decoded_sha256"], name
    golden = os.path.join(HERE, "fixtures", "golden_offline", "scene_07.png")
    np.testing.assert_array_equal(tools.read(paths["scene_07.qoi"]), jtools.read(golden))
    np.testing.assert_array_equal(jtools.read(paths["scene_07.psd"]), jtools.read(golden))


@pytest.mark.parametrize("cut", ["half", "tail"])
@pytest.mark.parametrize("name", COMMITTED)
def test_cut_fixture_ends_as_pils(name, cut):
    """A fixture cut short: where PIL raises the port raises ``ValueError``
    (or ``NotImplementedError`` where the cut leaves a kind PIL does not
    read), where PIL still decodes the port decodes alike."""
    with open(os.path.join(RASTERS, name), "rb") as f:
        blob = f.read()
    blob = blob[: len(blob) // 2] if cut == "half" else blob[:-3]
    try:
        ref = _pil_rgb(blob)
    except Exception:
        with pytest.raises((ValueError, NotImplementedError)):
            tools.read(io.BytesIO(blob))
        return
    np.testing.assert_array_equal(tools.read(io.BytesIO(blob)), ref)


def _refused():
    rgb = mf.rgb_planes(RGB)
    psd = mf.write_psd(rgb, "RGB")
    return {
        "psb": (psd[:4] + b"\x00\x02" + psd[6:], "PSB"),
        "psd_16_bit": (psd[:22] + b"\x00\x10" + psd[24:], "16-bit RGB PSD"),
        "psd_32_bit_grey": (mf.write_psd(GREY[None], "grey", bits=32), "32-bit grey PSD"),
        "psd_zip": (mf.write_psd(rgb, "RGB", compression=0)[:-RGB.size - 2] + b"\x00\x02"
                    + bytes(RGB.size), "ZIP-compressed"),
        "psd_too_few_channels": (mf.write_psd(rgb[:2], "RGB"), "fewer than the mode needs"),
        "psd_cmyk_3_channels": (mf.write_psd(rgb, "CMYK"), "fewer than the mode needs"),
        "sgi_layout": (mf.write_sgi(GREY, dimension=3), "dimension 3 and 1 channels"),
        "sgi_compression": (mf.sgi_header(4, 4, 1, 1, 2) + bytes(16), "SGI compression 2"),
        "sun_depth": (mf.write_sun(GREY, 8, kind=1)[:12] + struct.pack(">I", 2)
                      + mf.write_sun(GREY, 8, kind=1)[16:], "2-bit Sun raster"),
        "sun_type": (mf.write_sun(GREY, 8, kind=7), "file type 7"),
        "sun_map_type": (mf.write_sun(GREY, 8, palette=PALETTE[:4], map_type=2), "map type 2"),
        "icns_old_icons": (mf.write_icns([(b"icl8", bytes(1024))]), "without a 32-bit icon"),
        "im_rlb": (mf.write_im("RLB image", 4, 4, bytes(48)), "'RLB'"),
        "im_pa": (mf.write_im("PA image", 4, 4, bytes(32)), "'PA;L'"),
        "xpm_colour_name": (mf.write_xpm(GREY % 2, [b"white", b"#000000"]), "b'white'"),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_refusals_name_the_kind(case):
    blob, what = _refused()[case]
    with pytest.raises(Exception):
        _pil_rgb(blob)
    with pytest.raises(NotImplementedError, match=what):
        tools.read(io.BytesIO(blob))


# ---------------------------------------------------------------------------
# Dispatch and the Lab conversion
# ---------------------------------------------------------------------------


def test_dispatch_follows_pils_order():
    """``tools._FORMATS`` lists the port's formats in the order of PIL's
    ``Image.ID`` after ``Image.init()``; a DIB, a DCX and a TGA each reach
    their own decoder (DIB's accept, before TGA's, takes no TGA)."""
    # A fresh process: the plugins a process imports early come first.
    order = subprocess.run([sys.executable, "-c", "from PIL import Image; Image.init(); "
                            "print(' '.join(Image.ID))"], check=True, capture_output=True,
                           text=True).stdout.split()
    names = {"JPEG 2000": "JPEG2000", "PNM (P1-P6)": "PPM", "Sun raster": "SUN", "WebP": "WEBP"}
    ours = [names.get(kind, kind) for kind, _, _ in tools._FORMATS]
    assert ours == [f for f in order if f in ours]
    tga, dib = CASES["tga_grey"](), CASES["dib_grey"]()
    accepted = {kind for kind, accepts, _ in tools._FORMATS if accepts(tga)}
    assert accepted == {"TGA"}
    assert [k for k, accepts, _ in tools._FORMATS if accepts(dib)][0] == "DIB"
    assert Image.open(io.BytesIO(dib)).format == "DIB"
    assert Image.open(io.BytesIO(tga)).format == "TGA"


def _pil_im_accepts(blob):
    try:
        ImImagePlugin.ImImageFile(io.BytesIO(blob))
        return True
    except SyntaxError:
        return False


def test_im_opener_is_pils():
    """``rasters.is_im`` takes what ``ImImagePlugin``'s opener takes, from
    JPEG, TGA, text and IM headers alike."""
    jpeg = _pil(Image.fromarray(RGB), "JPEG")
    blobs = {
        "jpeg": jpeg, "tga": CASES["tga_grey"](), "text": b"Dear reader,\nthis is text.\n",
        "text_with_colon": b"Note: not an image\nplain: text\n",
        "no_newline": b"Image type: L image" + bytes(200),
        "long_line": b"Comment: " + b"x" * 120 + b"\n\x1a",
        "tag_after_text": b"Name: x\nImage size (x*y): 2*2\n" + b"\x00" * 4 + b"\x1a" + bytes(4),
        "no_tag": b"Colour: blue\n\x1a" + bytes(8), "no_end": b"Image type: L image\n",
        "nul_then_end": b"Image type: L image\nImage size (x*y): 1*1\n\0\0\0\x1a\x07",
        "leading_cr": b"\r\rImage type: L image\r\n\x1a\x07",
        "bad_first_char": b"1mage type: L image\n\x1a\x07",
        "im": mf.write_im("RGB image", 3, 2, bytes(18)),
    }
    for label, blob in blobs.items():
        assert rasters.is_im(blob) == _pil_im_accepts(blob), label
    assert rasters.is_im(blobs["im"]) and not rasters.is_im(blobs["jpeg"])


def test_lab_conversion_is_pils():
    """``lab_to_rgb`` equals PIL's ``LAB`` -> ``RGB`` (LittleCMS) on 2^18
    random Lab triples and on every L with a, b at the grid's corners."""
    values = np.random.RandomState(9).randint(0, 256, (1 << 18, 3)).astype(np.uint8)
    corners = np.array([0, 1, 127, 128, 129, 255], np.uint8)
    grid = np.stack(np.meshgrid(np.arange(256, dtype=np.uint8), corners, corners,
                                indexing="ij"), -1).reshape(-1, 3)
    lab = np.concatenate([values, grid])[None]
    ref = np.array(Image.frombytes("LAB", (lab.shape[1], 1), lab.tobytes()).convert("RGB"))
    np.testing.assert_array_equal(rasters.lab_to_rgb(lab), ref)
