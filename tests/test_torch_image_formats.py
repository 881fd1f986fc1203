"""Port parity: ``tools.read`` of TIFF, BMP, PNM and 4-component JPEG files.

JAX's ``tools.read`` is PIL's ``Image.open(f).convert("RGB")``; the
port's decodes (``keras_ocr_tpu_torch/codecs.py`` and the CMYK / YCCK
path of ``tools.decode_jpeg``) must equal it bit for bit:

* every committed fixture of ``tests/fixtures/images`` (written by
  ``scripts/make_image_fixtures.py``), by path, by buffer and through
  ``read_and_fit``, at the sha256 of PIL's decode in ``hashes.json``;
* files written here by PIL's writers (libtiff's CCITT Group 3 1-D and
  2-D, Group 4 and modified Huffman coders on runs of every make-up code's
  length, LZW, Deflate, PackBits and JPEG; BMP, PNM, CMYK JPEG) and by
  the fixture script's writers (both byte orders, strips, tiles and
  planes, every compression, predictor 2 at 8 and 16 bits, 1-16-bit
  grey, WhiteIsZero, FillOrder 2, palettes, extra samples, CMYK, YCbCr
  JPEG at three samplings; every BMP header, depth, bit-field layout and
  RLE escape; P1-P6 at maxvals 1-65535 with comments);
* PIL's TIFF mode table, restricted to what the port reads, and
  Pillow's CMYK conversion on every (C, K) pair.

What is still refused raises ``NotImplementedError`` naming it, a
truncated file ``ValueError``; the slim golden pipeline reads the same
words and boxes from one scene as PNG, TIFF-LZW, BMP, PPM and lossless
WebP (``tests/test_torch_fonts.py``'s import guard reads a fixture of
each format with PIL and JAX unimportable).
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
from PIL import Image, TiffImagePlugin

from keras_ocr_tpu import tools as jtools
from keras_ocr_tpu_torch import codecs, tools

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from make_image_fixtures import (adobe_transform, dib_entry, fixture_files,  # noqa: E402
                                 rle4_rows, rle8_rows, scene, write_bmp, write_ico, write_pcx,
                                 write_pnm, write_tga, write_tiff)
from make_jpeg_fixtures import JFIF, lossless_jpeg  # noqa: E402
from make_raster_fixtures import write_dcx  # noqa: E402

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
IMAGES = os.path.join(HERE, "fixtures", "images")
with open(os.path.join(IMAGES, "hashes.json"), encoding="utf8") as _f:
    HASHES = json.load(_f)

RNG = np.random.RandomState(21)
RGB = scene(37, 45, seed=3)
GREY = np.asarray(Image.fromarray(RGB).convert("L"))
PALETTE = RNG.randint(0, 256, (256, 3)).astype(np.uint8)


def _pil_rgb(blob):
    return np.array(Image.open(io.BytesIO(blob)).convert("RGB"))


def _pil(image, fmt, **kwargs):
    out = io.BytesIO()
    image.save(out, fmt, **kwargs)
    return out.getvalue()


def _runs_bitmap():
    """Rows of alternating runs of every length class of T.4: terminating
    codes, each make-up code and the extended ones up to 2560 and past."""
    lengths = [0, 1, 2, 63, 64, 65, 127, 128, 1727, 1728, 1729, 1791, 1792, 1855, 2559, 2560,
               2561, 2623, 2650]
    width = 2700
    rows = []
    for start in range(len(lengths)):
        row = np.zeros(width, bool)
        x, colour = 0, start % 2 == 0
        for i in range(40):
            run = lengths[(start + 3 * i) % len(lengths)]
            row[x : x + run] = colour
            x += run
            colour = not colour
            if x >= width:
                break
        rows.append(row)
    return np.array(rows)


BILEVEL = {
    "noise": RNG.rand(29, 61) < 0.4,
    "runs": _runs_bitmap(),
    "scene": GREY < 120,
}


def _strips(blob):
    """(size, strips, tag values) of a PIL-written one-image TIFF."""
    image = Image.open(io.BytesIO(blob))
    tags = image.tag_v2
    strips = [blob[o : o + c] for o, c in zip(tags[273], tags[279])]
    return (image.size[1], image.size[0]), strips, dict(tags)


def _rewritten_fax(blob, photometric, fill_order=1):
    """A PIL CCITT TIFF's strips in a file of another photometric
    interpretation or fill order."""
    size, strips, tags = _strips(blob)
    extra = {292: (4, [tags[292]])} if 292 in tags else {}
    return write_tiff(photometric=photometric, bits=1, compression=tags[259], size=size,
                      strips=strips, rows_per_strip=tags.get(278, size[0]),
                      fill_order=fill_order, tags=extra)


def _ccitt_cases():
    cases = {}
    for label, bits in BILEVEL.items():
        image = Image.fromarray(~bits)
        for kind, kwargs in (("g3_1d", {"compression": "group3"}),
                             ("g3_2d", {"compression": "group3", "tiffinfo": {292: 1}}),
                             ("g3_2d_fill", {"compression": "group3", "tiffinfo": {292: 5}}),
                             ("g3_1d_fill", {"compression": "group3", "tiffinfo": {292: 4}}),
                             ("g4", {"compression": "group4"}),
                             ("mh", {"compression": "tiff_ccitt"})):
            cases[f"tiff_{kind}_{label}"] = (lambda i=image, k=kwargs: _pil(i, "TIFF", **k))
        cases[f"tiff_g4_strips_{label}"] = (
            lambda i=image: _pil(i, "TIFF", compression="group4", tiffinfo={278: 7}))
        cases[f"tiff_g3_2d_strips_{label}"] = (
            lambda i=image: _pil(i, "TIFF", compression="group3", tiffinfo={292: 1, 278: 5}))
    for kind in ("group3", "group4", "tiff_ccitt"):
        image = Image.fromarray(~BILEVEL["scene"])
        pil = (lambda i=image, k=kind: _pil(i, "TIFF", compression=k, tiffinfo={292: 1}
                                            if k == "group3" else {}))
        cases[f"tiff_{kind}_whiteiszero"] = (lambda p=pil: _rewritten_fax(p(), 0))
        cases[f"tiff_{kind}_fillorder2"] = (lambda p=pil: _rewritten_fax(p(), 1, 2))
    return cases


def _tiff_cases():
    cases = {}
    rgb = RGB
    for compression in (1, 5, 8, 32946, 32773):
        for order in ("<", ">"):
            for layout, kwargs in (("strips", {"rows_per_strip": 7}),
                                   ("tiles", {"tile": (16, 32)}),
                                   ("planar", {"planar": 2, "rows_per_strip": 10})):
                cases[f"tiff_rgb_{compression}_{'le' if order == '<' else 'be'}_{layout}"] = (
                    lambda c=compression, o=order, k=kwargs: write_tiff(
                        rgb, photometric=2, compression=c, order=o, **k))
    wide = (RGB.astype(np.uint16) * 257 + RNG.randint(0, 200, RGB.shape)).astype(np.uint16)
    for order in ("<", ">"):
        tag = "le" if order == "<" else "be"
        for compression in (5, 8):
            cases[f"tiff_predictor_rgb8_{compression}_{tag}"] = (
                lambda c=compression, o=order: write_tiff(rgb, photometric=2, compression=c,
                                                          order=o, predictor=2,
                                                          rows_per_strip=9))
            cases[f"tiff_predictor_rgb16_{compression}_{tag}"] = (
                lambda c=compression, o=order: write_tiff(wide, photometric=2, bits=16,
                                                          compression=c, order=o, predictor=2))
        cases[f"tiff_predictor_tiles_{tag}"] = (
            lambda o=order: write_tiff(rgb, photometric=2, compression=5, order=o, predictor=2,
                                       tile=(16, 16)))
        cases[f"tiff_predictor_planar_{tag}"] = (
            lambda o=order: write_tiff(wide, photometric=2, bits=16, compression=8, order=o,
                                       predictor=2, planar=2))
        cases[f"tiff_rgb16_raw_{tag}"] = (lambda o=order: write_tiff(wide, photometric=2,
                                                                     bits=16, order=o))
    grey16 = (GREY.astype(np.int64) * 3 - 100).clip(0, 65535)
    for photometric in (0, 1):
        for bits in (1, 2, 4, 8, 16):
            values = (GREY >> (8 - bits)) if bits < 8 else (GREY if bits == 8 else grey16)
            for order in ("<", ">"):
                for compression in (1, 5):
                    for fill in (1, 2):
                        if bits == 16 and (order == ">" and (photometric == 0 or fill == 2)):
                            continue  # PIL has no mode for these
                        name = (f"tiff_grey{bits}_photo{photometric}_"
                                f"{'le' if order == '<' else 'be'}_{compression}_fill{fill}")
                        cases[name] = (lambda v=values, p=photometric, b=bits, o=order,
                                       c=compression, f=fill: write_tiff(
                                           v, photometric=p, bits=b, order=o, compression=c,
                                           fill_order=f, rows_per_strip=11))
        cases[f"tiff_grey1_planar_raw_photo{photometric}"] = (
            lambda p=photometric: write_tiff(GREY < 100, photometric=p, bits=1, planar=2))
        cases[f"tiff_grey8_planar_raw_photo{photometric}"] = (
            lambda p=photometric: write_tiff(GREY, photometric=p, planar=2, fill_order=2))
    colormap = PALETTE.astype(np.int64) * 256 + RNG.randint(0, 256, PALETTE.shape)
    for bits in (1, 2, 4, 8):
        for compression, fill in ((1, 1), (5, 1), (1, 2), (32773, 2)):
            cases[f"tiff_palette{bits}_{compression}_fill{fill}"] = (
                lambda b=bits, c=compression, f=fill: write_tiff(
                    GREY >> (8 - b), photometric=3, bits=b, compression=c, fill_order=f,
                    colormap=colormap[: 1 << b]))
    alpha = RNG.randint(0, 256, GREY.shape + (1,)).astype(np.uint8)
    alpha[:3] = 0
    alpha[3:6] = 255
    premultiplied = (RGB.astype(np.int64) * alpha // 255).astype(np.uint8)
    rgba = np.concatenate([premultiplied, alpha], -1)
    for extra in ((), (0,), (1,), (2,), (999,)):
        for compression in (1, 8):
            cases[f"tiff_rgba_extra{''.join(map(str, extra))}_{compression}"] = (
                lambda e=extra, c=compression: write_tiff(rgba, photometric=2, extra_samples=e,
                                                          compression=c))
        cases[f"tiff_rgba_extra{''.join(map(str, extra))}_planar_deflate"] = (
            lambda e=extra: write_tiff(rgba, photometric=2, extra_samples=e, compression=8,
                                       planar=2))
    for extra in ((), (0,), (2,)):
        cases[f"tiff_rgba_extra{''.join(map(str, extra))}_planar_raw"] = (
            lambda e=extra: write_tiff(rgba, photometric=2, extra_samples=e, planar=2))
    six = np.concatenate([rgba, alpha, alpha // 3], -1)
    for extra in ((0, 0), (1, 0), (2, 0)):
        cases[f"tiff_rgb_5_samples_{extra[0]}"] = (
            lambda e=extra: write_tiff(six[..., :5], photometric=2, extra_samples=e))
        cases[f"tiff_rgb_6_samples_{extra[0]}"] = (
            lambda e=extra: write_tiff(six, photometric=2, extra_samples=e + (0,),
                                       compression=5))
    wide_alpha = np.concatenate([wide, alpha.astype(np.uint16) * 257], -1)
    for extra in ((), (0,), (1,), (2,)):
        for order in ("<", ">"):
            cases[f"tiff_rgba16_extra{''.join(map(str, extra))}_{order == '<'}"] = (
                lambda e=extra, o=order: write_tiff(wide_alpha, photometric=2, bits=16,
                                                    extra_samples=e, order=o, compression=5))
    cases["tiff_la"] = lambda: write_tiff(np.stack([GREY, alpha[..., 0]], -1), photometric=1,
                                          extra_samples=(2,), compression=8)
    for extra in ((0,), (2,)):
        cases[f"tiff_palette_extra{extra[0]}"] = (
            lambda e=extra: write_tiff(np.stack([GREY, alpha[..., 0]], -1), photometric=3,
                                       extra_samples=e, colormap=colormap))
    cmyk = np.asarray(Image.fromarray(RGB).convert("CMYK")).copy()
    cmyk[..., 3] = GREY // 3
    for compression in (1, 5, 32773):
        cases[f"tiff_cmyk_{compression}"] = (
            lambda c=compression: write_tiff(cmyk, photometric=5, compression=c,
                                              tags={332: (3, [1])}))
        cases[f"tiff_cmyk_planar_{compression}"] = (
            lambda c=compression: write_tiff(cmyk, photometric=5, compression=c, planar=2))
    cases["tiff_cmyk16_be"] = lambda: write_tiff(cmyk.astype(np.uint16) * 251, photometric=5,
                                                 bits=16, order=">", compression=8)
    cases["tiff_cmykx"] = lambda: write_tiff(np.concatenate([cmyk, alpha], -1), photometric=5,
                                             extra_samples=(0,))
    # PIL's own TIFF writers.
    image = Image.fromarray(RGB)
    for compression in ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits", "jpeg"):
        for mode in ("RGB", "L", "RGBA", "CMYK", "P", "1", "I;16"):
            if compression == "jpeg" and mode not in ("RGB", "L", "CMYK"):
                continue
            cases[f"tiff_pil_{compression}_{mode}"] = (
                lambda c=compression, m=mode: _pil(image.convert(m) if m != "I;16" else
                                                   Image.fromarray(GREY.astype(np.uint16) * 97),
                                                   "TIFF", compression=c, tiffinfo={278: 16}))
    cases["tiff_pil_jpeg_q95_strips"] = lambda: _pil(image, "TIFF", compression="jpeg",
                                                     quality=95, tiffinfo={278: 16})
    for sampling, (h, v) in (("4:2:0", (2, 2)), ("4:2:2", (2, 1)), ("4:4:4", (1, 1))):
        for rows in (8, 10, 37):
            cases[f"tiff_ycbcr_jpeg_{sampling}_{rows}"] = (
                lambda s=sampling, r=rows, hv=(h, v): write_tiff(
                    photometric=6, compression=7, bits=(8, 8, 8), size=RGB.shape[:2],
                    rows_per_strip=r, tags={530: (3, list(hv))},
                    strips=[_pil(Image.fromarray(RGB[y : y + r]), "JPEG", subsampling=s)
                            for y in range(0, RGB.shape[0], r)]))
    cases["tiff_ycbcr_jpeg_tiles"] = lambda: write_tiff(
        photometric=6, compression=7, bits=(8, 8, 8), size=RGB.shape[:2], tile=(16, 16),
        tags={530: (3, [2, 2])},
        strips=[_pil(Image.fromarray(np.pad(RGB, ((0, 11), (0, 3), (0, 0)))[y : y + 16,
                                                                           x : x + 16]),
                     "JPEG", subsampling="4:2:0")
                for y in range(0, 48, 16) for x in range(0, 48, 16)])
    cases["tiff_grey_jpeg_whiteiszero"] = lambda: write_tiff(
        photometric=0, compression=7, size=GREY.shape, bits=8,
        strips=[_pil(Image.fromarray(GREY), "JPEG")])
    return cases


def _bmp_cases():
    cases = {}
    image = Image.fromarray(RGB)
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        cases[f"bmp_pil_{mode}"] = lambda m=mode: _pil(image.convert(m), "BMP")
    index = {1: (GREY > 128).astype(np.int64), 4: GREY // 16, 8: GREY.astype(np.int64)}
    for bits in (1, 4, 8):
        for header in (12, 40, 52, 56, 108, 124):
            for colours in (1 << bits, max(2, (1 << bits) // 2 + 1)):
                palette = PALETTE[:colours]
                values = index[bits] % colours
                cases[f"bmp_{bits}bit_h{header}_palette{colours}"] = (
                    lambda v=values, b=bits, h=header, p=palette: write_bmp(v, b, header=h,
                                                                            palette=p))
        cases[f"bmp_{bits}bit_topdown"] = (lambda b=bits: write_bmp(
            index[b], b, top_down=True, palette=PALETTE[: 1 << b]))
    grey_ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    cases["bmp_grey_palette_8bit"] = lambda: write_bmp(GREY, 8, palette=grey_ramp)
    cases["bmp_black_white_palette_1bit"] = lambda: write_bmp(
        GREY > 90, 1, palette=np.array([[0, 0, 0], [255, 255, 255]]))
    cases["bmp_grey_palette_1bit_1x1"] = lambda: write_bmp(
        np.zeros((1, 1), np.uint8), 1, palette=np.zeros((1, 3)))
    for header in (12, 40, 124):
        cases[f"bmp_24bit_h{header}"] = lambda h=header: write_bmp(RGB, 24, header=h)
        cases[f"bmp_16bit_555_h{header}"] = lambda h=header: write_bmp(RGB, 16, header=h)
    cases["bmp_32bit_rgb"] = lambda: write_bmp(RGB, 32)
    every = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    cases["bmp_16bit_every_555"] = lambda: write_bmp(
        np.zeros((256, 256)), 16, data=every.astype("<u2").tobytes())
    for header in (40, 52, 108):
        for masks in ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)):
            cases[f"bmp_bitfields_{hex(masks[0])}_h{header}"] = (
                lambda h=header, m=masks: write_bmp(RGB, 16, header=h, compression=3, masks=m))
        cases[f"bmp_bitfields_every_565_h{header}"] = (
            lambda h=header: write_bmp(np.zeros((256, 256)), 16, header=h, compression=3,
                                       masks=(0xF800, 0x7E0, 0x1F),
                                       data=every.astype("<u2").tobytes()))
        cases[f"bmp_bitfields_24_h{header}"] = lambda h=header: write_bmp(
            RGB, 24, header=h, compression=3, masks=(0xFF0000, 0xFF00, 0xFF))
    raw32 = RNG.randint(0, 256, (23, 19, 4)).astype(np.uint8)
    for masks in ((0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
                  (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                  (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                  (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)):
        cases[f"bmp_bitfields32_{'_'.join(hex(m) for m in masks)}"] = (
            lambda m=masks: write_bmp(raw32[..., :3], 32, header=56, compression=3, masks=m,
                                      data=raw32.tobytes()))
    cases["bmp_bitfields32_h40"] = lambda: write_bmp(
        raw32[..., :3], 32, header=40, compression=3, masks=(0xFF000000, 0xFF0000, 0xFF00),
        data=raw32.tobytes())
    smooth = (GREY // 40).astype(np.uint8)
    for topdown in (False, True):
        cases[f"bmp_rle8_{topdown}"] = lambda t=topdown: write_bmp(
            GREY, 8, compression=1, palette=PALETTE, top_down=t,
            data=rle8_rows(GREY[::-1] if t else GREY))
        cases[f"bmp_rle4_{topdown}"] = lambda t=topdown: write_bmp(
            smooth, 4, compression=2, palette=PALETTE[:16], top_down=t,
            data=rle4_rows(smooth[::-1] if t else smooth))
    cases["bmp_rle8_short_palette"] = lambda: write_bmp(
        smooth, 8, compression=1, palette=PALETTE[:5], data=rle8_rows(smooth))
    cases["bmp_rle8_delta"] = lambda: write_bmp(
        smooth, 8, compression=1, palette=PALETTE, data=rle8_rows(smooth, delta_after=(4, 9)))
    # An odd absolute run in RLE4, a run past the row's end in RLE8, and
    # an end-of-line in mid row: PIL's reading of each.
    cases["bmp_rle4_odd_absolute"] = lambda: write_bmp(
        np.zeros((2, 8)), 4, compression=2, palette=PALETTE[:16],
        data=bytes([0, 5, 0x12, 0x34, 0x50, 0, 3, 0x67, 0, 0]) + bytes([8, 0x9A, 0, 0, 0, 1]))
    cases["bmp_rle8_overlong_and_early_eol"] = lambda: write_bmp(
        np.zeros((3, 6)), 8, compression=1, palette=PALETTE,
        data=bytes([9, 7, 2, 3, 0, 0, 4, 9, 0, 3, 1, 2, 3, 0, 0, 0, 0, 0, 1]))
    cases["bmp_grey_l_data_offset_0"] = lambda: _zero_offset(write_bmp(GREY, 8,
                                                                       palette=PALETTE))
    return cases


def _zero_offset(bmp):
    """A BMP whose pixel-data offset field is 0: PIL reads the data after
    the palette."""
    return bmp[:10] + b"\x00" * 4 + bmp[14:]


def _pnm_cases():
    cases = {}
    image = Image.fromarray(RGB)
    for mode in ("1", "L", "RGB", "I;16"):
        source = image.convert(mode) if mode != "I;16" else Image.fromarray(
            GREY.astype(np.uint16) * 200)
        cases[f"pnm_pil_{mode}"] = lambda s=source: _pil(s, "PPM")
    small = RGB[:9, :13].astype(np.int64)
    grey = GREY[:9, :13].astype(np.int64)
    for maxval in (1, 2, 15, 100, 255, 256, 1023, 4095, 65534, 65535):
        scaled = small * maxval // 255
        gscaled = grey * maxval // 255
        for kind, values in ((2, gscaled), (3, scaled), (5, gscaled), (6, scaled)):
            cases[f"pnm_p{kind}_maxval{maxval}"] = (
                lambda v=values, k=kind, m=maxval: write_pnm(v, k, maxval=m,
                                                             comment=b"made here"))
    overflow = small.copy()
    overflow[0, 0] = 255
    cases["pnm_p6_sample_above_maxval"] = lambda: write_pnm(overflow, 6, maxval=200)
    bits = GREY[:11, :21] > 99
    for kind in (1, 4):
        cases[f"pnm_p{kind}"] = lambda k=kind: write_pnm(bits, k, comment=b"bitmap")
    cases["pnm_p1_packed_digits"] = lambda: b"P1 5 2 0110010 #c\n011"
    cases["pnm_comments_everywhere"] = lambda: (
        b"P2\n#a\n 3#b\n 2 # c\n#d\n25#e\r5\n 0 1 2\n#f\n 3 4 255")
    cases["pnm_comment_in_a_token"] = lambda: b"P5 1#x\n2 1 255\n" + bytes(range(12))
    cases["pnm_tabs_and_crs"] = lambda: b"P3\t2\r1\x0b255\x0c1 2 3 4 5 6"
    cases["pnm_two_images"] = lambda: write_pnm(small, 6) + write_pnm(small[::-1], 6)
    return cases


def _jpeg_cases():
    cases = {}
    image = Image.fromarray(RGB).convert("CMYK")
    for subsampling in (0, 1, 2):
        for progressive in (False, True):
            def cmyk(s=subsampling, p=progressive):
                return _pil(image, "JPEG", subsampling=s, progressive=p, quality=85)
            cases[f"jpeg_cmyk_{subsampling}_{progressive}"] = cmyk
            cases[f"jpeg_ycck_{subsampling}_{progressive}"] = (
                lambda c=cmyk: adobe_transform(c(), 2))
    cases["jpeg_cmyk_other_transform"] = lambda: adobe_transform(_pil(image, "JPEG"), 1)

    def without_adobe():
        blob = _pil(image, "JPEG", subsampling=2)
        at = blob.index(b"\xff\xee")
        (length,) = struct.unpack(">H", blob[at + 2 : at + 4])
        return blob[:at] + blob[at + 2 + length :]
    cases["jpeg_cmyk_no_adobe_marker"] = without_adobe
    return cases


def _tga_cases():
    cases = {}
    rgba = np.concatenate([RGB, GREY[..., None]], -1)
    words = (RGB[..., 0].astype(np.int64) >> 3) << 10 | (RGB[..., 1] >> 3) << 5 | RGB[..., 2] >> 3
    index = GREY // 32
    kinds = {
        "rgb15": (2, 16, words | (GREY > 99) << 15, {}), "rgb24": (2, 24, RGB, {}),
        "rgba32": (2, 32, rgba, {}), "grey8": (3, 8, GREY, {}),
        "grey_alpha16": (3, 16, np.stack([GREY, RGB[..., 0]], -1), {}),
        "map24": (1, 8, index, {"colormap": PALETTE[:8]}),
        "map16_from_5": (1, 8, index, {"colormap": PALETTE[:8], "map_depth": 16,
                                       "map_start": 5}),
        "map24_short": (1, 8, GREY // 8, {"colormap": PALETTE[:20]}),
        "grey8_with_map": (3, 8, GREY // 8, {"colormap": PALETTE[:20]}),
        "grey_alpha_with_map": (3, 16, np.stack([GREY // 8, GREY], -1),
                                {"colormap": PALETTE[:30], "map_depth": 16}),
    }
    for kind, (image_type, depth, values, kwargs) in kinds.items():
        for rle in (0, 8):
            for top in (False, True):
                for right in (False, True):
                    name = f"tga_{kind}_{'rle' if rle else 'raw'}_{'top' if top else 'bottom'}"
                    cases[name + ("_right" if right else "")] = (
                        lambda t=image_type + rle, d=depth, v=values, k=kwargs, o=top, r=right:
                        write_tga(v, t, d, top=o, right=r, **k))
    for right in (False, True):
        cases[f"tga_bilevel_raw_{right}"] = lambda r=right: write_tga(GREY > 99, 3, 1, right=r)
    noise = RNG.randint(0, 256, (9, 13, 3)).astype(np.uint8)
    cases["tga_literals_across_rows"] = lambda: write_tga(noise, 10, 24, span_rows=True)
    cases["tga_id_section"] = lambda: write_tga(RGB, 10, 24, id_section=b"id" * 60)
    cases["tga_every_16_bit_word"] = lambda: write_tga(
        np.arange(65536).reshape(256, 256), 2, 16)
    image = Image.fromarray(RGB)
    for mode in ("1", "L", "LA", "P", "RGB", "RGBA"):
        for rle in (False, True):
            cases[f"tga_pil_{mode}_{rle}"] = lambda m=mode, r=rle: _pil(
                image.convert(m), "TGA", rle=r, orientation=1 if r else -1)
    # What PIL does not read: a run past a row's end, a 1-bit run-length
    # image, depths the image type has no raw mode for, a colour map of
    # 32-bit entries or beside true colour or 1-bit grey, a colour-mapped
    # type without its map.
    cases["tga_run_across_rows"] = lambda: write_tga(np.zeros((6, 9), np.uint8), 11, 8,
                                                      span_rows=True)
    cases["tga_bilevel_rle"] = lambda: write_tga(GREY > 99, 11, 1)
    cases["tga_rgb_depth8"] = lambda: write_tga(GREY, 2, 8)
    cases["tga_map_depth16"] = lambda: write_tga(GREY, 1, 16, colormap=PALETTE[:8])
    cases["tga_grey_depth24"] = lambda: write_tga(RGB, 3, 24)
    cases["tga_map32"] = lambda: write_tga(index, 1, 8, colormap=np.concatenate(
        [PALETTE[:8], PALETTE[:8, :1]], 1), map_depth=32)
    cases["tga_rgb_with_map"] = lambda: write_tga(RGB, 2, 24, colormap=PALETTE[:8])
    cases["tga_bilevel_with_map"] = lambda: write_tga(GREY > 99, 3, 1, colormap=PALETTE[:2])
    cases["tga_no_map"] = lambda: write_tga(index, 1, 8)
    return cases


def _pcx_cases():
    cases = {}
    palette16 = PALETTE[:16]
    for width in (37, 40, 45, 3, 1):
        rgb, grey = RGB[:, :width], GREY[:, :width]
        kinds = {"bilevel": (1, 1, (grey > 99).astype(np.int64), None),
                 "planes2": (1, 2, grey // 64, palette16),
                 "planes4": (1, 4, grey // 16, palette16),
                 "grey": (8, 1, grey, None), "palette": (8, 1, grey, PALETTE),
                 "rgb": (8, 3, rgb, None)}
        for kind, (bits, planes, values, palette) in kinds.items():
            need = (width * bits + 7) // 8
            for label, stride in (("even", need + need % 2), ("exact", need),
                                  ("wide", need + 2)):
                cases[f"pcx_{kind}_w{width}_{label}"] = (
                    lambda b=bits, p=planes, v=values, pal=palette, st=stride: write_pcx(
                        v, b, p, palette=pal, stride=st))
    cases["pcx_grey_ramp_palette"] = lambda: write_pcx(GREY, 8, 1, palette=np.repeat(
        np.arange(256)[:, None], 3, 1))
    cases["pcx_origin"] = lambda: write_pcx(GREY, 8, 1, origin=(7, 300))
    image = Image.fromarray(RGB)
    for mode in ("1", "L", "P", "RGB"):
        cases[f"pcx_pil_{mode}"] = lambda m=mode: _pil(image.convert(m), "PCX")
    # What PIL does not read: 2- and 4-bit pixels, 1 bit over 3 planes,
    # 8 bits over 2, 8-bit before version 5, a run past a row's end.
    cases["pcx_2_bit"] = lambda: write_pcx(GREY // 64, 2, 1)
    cases["pcx_4_bit"] = lambda: write_pcx(GREY // 16, 4, 1)
    cases["pcx_planes3_1_bit"] = lambda: write_pcx(GREY // 32, 1, 3)
    cases["pcx_planes2_8_bit"] = lambda: write_pcx(GREY, 8, 2)
    cases["pcx_version3_8_bit"] = lambda: write_pcx(GREY, 8, 1, version=3)
    cases["pcx_run_across_rows"] = lambda: write_pcx(np.zeros((5, 9), np.int64), 8, 1,
                                                     span_rows=True)
    return cases


def _ico_cases():
    cases = {}
    big, small = scene(32, 32, seed=6), scene(16, 16, seed=7)
    grey = big[..., 1]
    entries = {
        "dib1": (16, 16, 2, 1, 1, dib_entry(small[..., 0] > 99, 1, palette=PALETTE[:2])),
        "dib4": (16, 16, 16, 1, 4, dib_entry(small[..., 0] // 16, 4, palette=PALETTE[:16])),
        "dib8": (32, 32, 0, 1, 8, dib_entry(grey // 4, 8, palette=PALETTE[:64],
                                             and_mask=grey > 120)),
        "dib8_grey": (32, 32, 0, 1, 8, dib_entry(grey, 8, palette=np.repeat(
            np.arange(256)[:, None], 3, 1))),
        "dib24": (32, 32, 0, 1, 24, dib_entry(big, 24)),
        "dib32": (32, 32, 0, 1, 32, dib_entry(big, 32, alpha=grey)),
        "dib24_colours_7": (32, 32, 7, 1, 0, dib_entry(big, 24)),
    }
    for name, entry in entries.items():
        cases[f"ico_{name}"] = lambda e=entry: write_ico([e])
    # PIL shows the largest entry; of equal sizes, the lowest colour depth.
    cases["ico_largest_wins"] = lambda: write_ico([entries["dib4"], entries["dib24"],
                                                   entries["dib1"]])
    cases["ico_tie_by_depth"] = lambda: write_ico([entries["dib32"], entries["dib24"],
                                                   entries["dib8"]])
    cases["ico_tie_by_colour_count"] = lambda: write_ico([entries["dib24"],
                                                          entries["dib24_colours_7"]])
    cases["ico_256_by_0"] = lambda: write_ico([entries["dib24"], (0, 0, 0, 1, 4, entries[
        "dib4"][5])])
    png = _pil(Image.fromarray(big).convert("P"), "PNG")
    cases["ico_png_beside_dib"] = lambda: write_ico([entries["dib4"], (32, 32, 0, 1, 8, png)])
    image = Image.fromarray(big)
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        for fmt in ("png", "bmp"):
            cases[f"ico_pil_{mode}_{fmt}"] = lambda m=mode, f=fmt: _pil(
                image.convert(m), "ICO", sizes=[(16, 16), (24, 24), (32, 32)], bitmap_format=f)
    # A cursor shows its first entry, or a later one wider and taller.
    cases["cur_first"] = lambda: write_ico([entries["dib24"], entries["dib4"]], kind=2)
    cases["cur_later_larger"] = lambda: write_ico([entries["dib4"], entries["dib8"]], kind=2)
    cases["cur_later_wider_only"] = lambda: write_ico(
        [entries["dib4"], (32, 16, 0, 1, 1, entries["dib24"][5])], kind=2)
    cases["cur_32_bit_at_22"] = lambda: write_ico([entries["dib32"]], kind=2)
    return cases


def _dib_cases():
    """BMPs without their file header, as PIL's ``DibImageFile`` reads
    them (the data right after the header, masks and palette)."""
    cases = {}
    image = Image.fromarray(RGB)
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        cases[f"dib_pil_{mode}"] = lambda m=mode: _pil(image.convert(m), "DIB")
    index = {1: (GREY > 128).astype(np.int64), 4: GREY // 16, 8: GREY.astype(np.int64)}
    for bits in (1, 4, 8):
        for header in (12, 40, 124):
            cases[f"dib_{bits}bit_h{header}"] = lambda b=bits, h=header: write_bmp(
                index[b], b, header=h, palette=PALETTE[: 1 << b])[14:]
    for bits in (16, 24, 32):
        cases[f"dib_{bits}bit_topdown"] = lambda b=bits: write_bmp(RGB, b, top_down=True)[14:]
    cases["dib_bitfields_565_h40"] = lambda: write_bmp(RGB, 16, compression=3,
                                                       masks=(0xF800, 0x7E0, 0x1F))[14:]
    cases["dib_rle8"] = lambda: write_bmp(GREY, 8, compression=1, palette=PALETTE,
                                          data=rle8_rows(GREY))[14:]
    smooth = (GREY // 40).astype(np.uint8)
    cases["dib_rle4"] = lambda: write_bmp(smooth, 4, compression=2, palette=PALETTE[:16],
                                          data=rle4_rows(smooth))[14:]
    cases["dib_grey_palette"] = lambda: write_bmp(GREY, 8, palette=np.repeat(
        np.arange(256)[:, None], 3, 1))[14:]
    return cases


def _dcx_cases():
    """DCX files: PIL shows the first page; an 8-bit page's palette is the
    last 769 bytes of the whole file."""
    pages = {"bilevel": write_pcx((GREY > 99).astype(np.int64), 1, 1),
             "planes4": write_pcx(GREY // 16, 1, 4, palette=PALETTE[:16]),
             "grey": write_pcx(GREY, 8, 1), "palette": write_pcx(GREY, 8, 1, palette=PALETTE),
             "rgb": write_pcx(RGB, 8, 3)}
    cases = {f"dcx_{kind}": lambda p=page: write_dcx([p]) for kind, page in pages.items()}
    cases["dcx_rgb_then_palette"] = lambda: write_dcx([pages["rgb"], pages["palette"]])
    cases["dcx_palette_then_grey"] = lambda: write_dcx([pages["palette"], pages["grey"]])
    cases["dcx_grey_then_palette"] = lambda: write_dcx([pages["grey"], pages["palette"]])
    cases["dcx_pil_pcx_page"] = lambda: write_dcx([_pil(Image.fromarray(RGB).convert("P"),
                                                         "PCX")])
    return cases


CASES = {**_ccitt_cases(), **_tiff_cases(), **_bmp_cases(), **_pnm_cases(), **_jpeg_cases(),
         **_tga_cases(), **_pcx_cases(), **_ico_cases(), **_dib_cases(), **_dcx_cases()}


# Layouts PIL refuses (no mode for 16-bit WhiteIsZero with FillOrder 2,
# no unpacker for uncompressed ``L;IR`` / ``P;nR``, libtiff's planar data
# of more planes than the mode has bands): the port refuses them too.
PIL_REFUSES = {
    "tiff_grey16_photo0_le_1_fill2", "tiff_grey16_photo0_le_5_fill2",
    "tiff_grey8_photo0_be_1_fill2", "tiff_grey8_photo0_le_1_fill2",
    "tiff_palette1_1_fill2", "tiff_palette2_1_fill2", "tiff_palette4_1_fill2",
    "tiff_rgba_extra0_planar_deflate", "tiff_rgba_extra0_planar_raw",
    "tga_run_across_rows", "tga_bilevel_rle", "tga_rgb_depth8", "tga_map_depth16",
    "tga_grey_depth24", "tga_map32", "tga_rgb_with_map", "tga_bilevel_with_map", "tga_no_map",
    "tga_pil_1_True",
    "pcx_2_bit", "pcx_4_bit", "pcx_planes3_1_bit", "pcx_planes2_8_bit", "pcx_version3_8_bit",
    "pcx_run_across_rows",
} | {name for name in CASES if name.startswith("pcx_") and name.endswith("_wide")
     # (the runs of the 1-pixel RGB file happen to fit PIL's stride)
     and name != "pcx_rgb_w1_wide"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_read_matches_pil(case):
    blob = CASES[case]()
    try:
        ref = _pil_rgb(blob)
    except (OSError, ValueError, SyntaxError):
        assert case in PIL_REFUSES
        with pytest.raises(NotImplementedError, match="PIL"):
            tools.read(io.BytesIO(blob))
        return
    assert case not in PIL_REFUSES
    ours = tools.read(io.BytesIO(blob))
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


# The Group 4 page (0.5 s a decode) is read by path only.
FIXTURE_READS = [(name, variant) for name in sorted(HASHES)
                 for variant in ("path", "buffer", "read_and_fit")
                 if name != "page_g4.tif" or variant == "path"]


@pytest.mark.parametrize("name,variant", FIXTURE_READS)
def test_fixture_matches_pil(name, variant):
    path = os.path.join(IMAGES, name)
    if variant == "read_and_fit":
        np.testing.assert_array_equal(tools.read_and_fit(path, 96, 80),
                                      jtools.read_and_fit(path, 96, 80))
        return
    if variant == "path":
        ours = tools.read(path)
    else:
        with open(path, "rb") as f:
            ours = tools.read(io.BytesIO(f.read()))
    expected = HASHES[name]
    assert list(ours.shape) == expected["shape"]
    assert hashlib.sha256(ours.tobytes()).hexdigest() == expected["decoded_sha256"]
    np.testing.assert_array_equal(ours, jtools.read(path))


def test_fixtures_are_the_scripts():
    """The committed files are what the script writes, and small."""
    files = fixture_files()
    assert sorted(files) == sorted(HASHES)
    for name, blob in files.items():
        with open(os.path.join(IMAGES, name), "rb") as f:
            assert f.read() == blob, name
    sizes = {name: len(blob) for name, blob in files.items()}
    assert sizes["page_g4.tif"] <= 200_000 and sum(sizes.values()) <= 400_000
    assert HASHES["page_g4.tif"]["shape"] == [3300, 2550, 3]


def test_tiff_mode_table_is_pils():
    """``codecs._tiff_mode`` is PIL's ``OPEN_INFO`` on every unsigned
    layout the port reads, and names no layout PIL lacks."""
    supported = 0
    for (prefix, photo, sample_format, fill, bps, extra), modes in TiffImagePlugin.OPEN_INFO.items():
        if sample_format != (1,) or max(bps) > 16 or photo not in (0, 1, 2, 3, 5, 6) \
                or 12 in bps:
            continue
        order = "<" if prefix == b"II" else ">"
        assert codecs._tiff_mode(order, photo, fill, bps, extra) == modes
        supported += 1
    assert supported > 100
    for order, prefix in (("<", b"II"), (">", b"MM")):
        for photo in (0, 1, 2, 3, 5, 6):
            for fill in (1, 2):
                for bps in [(b,) * n for b in (1, 2, 4, 8, 16) for n in range(1, 7)]:
                    for extra in ((), (0,), (1,), (2,), (0, 0), (1, 0), (2, 0), (0, 0, 0)):
                        modes = codecs._tiff_mode(order, photo, fill, bps, extra)
                        key = (prefix, photo, (1,), fill, bps, extra)
                        assert modes is None or TiffImagePlugin.OPEN_INFO[key] == modes, key


def test_cmyk_to_rgb_is_pillows():
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    cmyk = np.stack([c, c[::-1], (c * 7) % 256, k], -1).astype(np.uint8)
    ref = np.array(Image.frombytes("CMYK", (256, 256), cmyk.tobytes()).convert("RGB"))
    np.testing.assert_array_equal(codecs.cmyk_to_rgb(cmyk), ref)
    assert codecs.cmyk_to_rgb(np.array([[100, 0, 0, 50]], np.uint8)).tolist() == [
        [125, 205, 205]]


def _tiff_with(blob, tag, kind, values):
    """A writer-made TIFF (IFD at offset 8) with one entry's value
    replaced in place (one value that fits the entry)."""
    order = "<" if blob[:2] == b"II" else ">"
    (count,) = struct.unpack_from(order + "H", blob, 8)
    data = bytearray(blob)
    for i in range(count):
        at = 10 + 12 * i
        if struct.unpack_from(order + "H", blob, at)[0] == tag:
            fmt = {3: "H", 4: "I"}[kind]
            data[at + 2 : at + 12] = struct.pack(order + "HI", kind, len(values)) + struct.pack(
                order + fmt * len(values), *values).ljust(4, b"\x00")
            return bytes(data)
    raise KeyError(tag)


def _refused():
    grey = write_tiff(GREY, photometric=1)
    rgb = write_tiff(RGB, photometric=2)
    cmyk = _pil(Image.fromarray(RGB).convert("CMYK"), "JPEG")
    return {
        "BigTIFF": (b"II+\x00" + grey[4:], "BigTIFF"),
        "old_style_jpeg": (_tiff_with(grey, 259, 3, [6]), "old-style JPEG"),
        "lzma": (_tiff_with(grey, 259, 3, [34925]), "LZMA"),
        "zstd": (_tiff_with(grey, 259, 3, [50000]), "ZSTD"),
        "webp": (_tiff_with(grey, 259, 3, [50001]), "WebP"),
        "float_samples": (write_tiff(GREY.astype(np.uint16), photometric=1, bits=16,
                                     tags={339: (3, [3])}), "floating-point"),
        "signed_samples": (write_tiff(GREY, photometric=1, tags={339: (3, [2])}),
                           "signed integer"),
        "32_bit": (_tiff_with(write_tiff(np.zeros((4, 4), np.uint16), photometric=1, bits=16),
                              258, 3, [32]), "bits per sample"),
        "ycbcr_uncompressed": (_tiff_with(rgb, 262, 3, [6]), "YCbCr"),
        "lab": (_tiff_with(rgb, 262, 3, [8]), "L\\*a\\*b\\*"),
        "rgb_2_bit": (write_tiff(RGB >> 6, photometric=2, bits=2), "PIL does not open"),
        "predictor_3": (write_tiff(GREY, photometric=1, compression=5,
                                   tags={317: (3, [3])}), "Predictor 3"),
        "old_style_lzw": (write_tiff(GREY, photometric=1, compression=5,
                                     strips=[b"\x00\x01" + bytes(20)], size=GREY.shape),
                          "old-style"),
        "transposed": (write_tiff(GREY, photometric=1, tags={274: (3, [6])}), "Orientation"),
        "g3_uncompressed_mode": (write_tiff(photometric=0, bits=1, compression=3,
                                            size=(2, 8), strips=[b"\x00\x10" * 4],
                                            tags={292: (4, [2])}), "uncompressed mode"),
        "bmp_2_bit": (write_bmp(np.zeros((2, 2)), 2, palette=PALETTE[:4],
                                data=bytes(8)), "2-bit BMP"),
        "bmp_png": (write_bmp(np.zeros((2, 2)), 24, compression=5, data=bytes(16)), "BI_PNG"),
        "bmp_jpeg": (write_bmp(np.zeros((2, 2)), 24, compression=4, data=bytes(16)), "BI_JPEG"),
        "bmp_bitfields_layout": (write_bmp(RGB, 16, compression=3, masks=(0xF00, 0xF0, 0xF)),
                                 "bit-field layout"),
        "bmp_header_size": (b"BM" + bytes(8) + struct.pack("<II", 80, 20) + bytes(80),
                            "header of 20 bytes"),
        "pnm_pf": (b"Pf\n2 1\n-1.0\n" + bytes(8), "Pf"),
        "pnm_p0cmyk": (b"P0CMYK\n1 1\n255\n" + bytes(4), "P0CMYK"),
        "jpeg_12_bit": (cmyk.replace(b"\xff\xc0\x00\x14\x08", b"\xff\xc0\x00\x14\x0c", 1),
                        "12-bit"),
        "jpeg_lossless": (lossless_jpeg([RGB[..., k] for k in range(3)], markers=JFIF),
                          "lossless JPEG with a JFIF marker"),
    }


@pytest.mark.parametrize("case", sorted(_refused()))
def test_refusals_name_the_feature(case):
    blob, what = _refused()[case]
    with pytest.raises(NotImplementedError, match=what):
        tools.read(io.BytesIO(blob))


@pytest.mark.parametrize("cut", ["half", "tail"])
@pytest.mark.parametrize("name", sorted(n for n in HASHES if n != "page_g4.tif"))
def test_truncated_fixture_raises_value_error(name, cut):
    with open(os.path.join(IMAGES, name), "rb") as f:
        blob = f.read()
    end = len(blob) // 2 if cut == "half" else len(blob) - _TAIL.get(name[-3:], 8)
    with pytest.raises(ValueError):
        tools.read(io.BytesIO(blob[:end]))


# Bytes cut from the end of a file for the "tail" case: a plain PNM's
# last sample and its newline, a BMP's last row; past PIL's 26-byte TGA
# footer, a PCX's 769-byte palette, a PNG's IEND and checksums, and the
# AND mask that a cursor holds but PIL does not read.
_TAIL = {"pbm": 2, "pgm": 4, "ppm": 16, "bmp": 300, "tga": 40, "pcx": 800, "ico": 40,
         "cur": 136}


def test_short_icon_entries_raise_value_error():
    """An icon entry without room for the alpha (a 32-bit entry) or AND mask
    PIL reads, and a cursor or icon whose data is cut: ``ValueError``, where
    PIL raises too."""
    big = scene(32, 32, seed=6)
    dib24 = dib_entry(big, 24)
    blobs = [write_ico([(32, 32, 0, 1, 32, dib24)]),
             write_ico([(32, 32, 0, 1, 24, dib24)])[:-40],
             write_ico([(32, 32, 0, 1, 24, dib24)], kind=2)[:-400]]
    for blob in blobs:
        with pytest.raises(Exception):
            jtools.read(io.BytesIO(blob))
        with pytest.raises(ValueError):
            tools.read(io.BytesIO(blob))


@pytest.mark.parametrize("pages", ["none", "not_pcx", "directory_cut"])
def test_dcx_without_a_pcx_page_is_a_value_error(pages):
    """A DCX file with no page, whose first page is not a PCX file, or whose
    directory runs off the file's end: PIL fails, the port raises
    ``ValueError``."""
    page = write_pcx(GREY, 8, 1)
    blob = {"none": write_dcx([], offsets=[]), "not_pcx": write_dcx([b"\x0b" + page[1:]]),
            "directory_cut": write_dcx([page])[:8]}[pages]
    with pytest.raises(Exception):
        _pil_rgb(blob)
    with pytest.raises(ValueError):
        tools.read(io.BytesIO(blob))


def test_unknown_format_is_a_value_error():
    with pytest.raises(ValueError, match=r"none of the formats tools.read decodes: AVIF, BMP, "
                                         r"DIB, CUR, PCX, DCX, GIF, PNG, JPEG 2000, ICNS, ICO, IM, "
                                         r"JPEG, TIFF, MSP, PNM \(P1-P6\), PSD, QOI, SGI, Sun "
                                         r"raster, TGA, WebP, XBM, XPM"):
        tools.read(io.BytesIO(b"P7\nWIDTH 1\n"))


def test_golden_scene_reads_alike_in_every_format(tmp_path):
    """One golden scene through the slim golden pipeline (CPU) from PNG,
    TIFF-LZW, BMP, PPM and lossless WebP: the same words and boxes each
    time."""
    from keras_ocr_tpu_torch.utils import golden

    artifact = os.path.join(HERE, "fixtures", "golden_offline")
    pipeline = golden.load_golden_pipeline(artifact, device="cpu")[0]
    png = os.path.join(artifact, "scene_03.png")
    image = Image.open(png).convert("RGB")
    paths = [png]
    for suffix, kwargs in ((".tif", {"compression": "tiff_lzw"}), (".bmp", {}), (".ppm", {}),
                           (".webp", {"lossless": True})):
        path = str(tmp_path / ("scene" + suffix))
        image.save(path, **kwargs)
        paths.append(path)
    results = pipeline.recognize(paths)
    words = [[word for word, _ in result] for result in results]
    assert words[0] and all(w == words[0] for w in words), words
    for result in results[1:]:
        for (_, box), (_, ref) in zip(result, results[0]):
            np.testing.assert_array_equal(box, ref)
