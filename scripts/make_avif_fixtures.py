"""Write the AVIF fixtures that ``tests/test_torch_avif.py``,
``tests/test_torch_avif_lossy.py`` and ``chip_smoke.py`` read, with the
sha256 of PIL's decodes as their hashes.

    python scripts/make_avif_fixtures.py [--out tests/fixtures/avif]

PIL's writer (libavif 1.3.0 over aom 3.12.1, ``quality=100``, which asks
aom for lossless coding) makes the files: every subsampling at either
range, aom's speeds 0-10 on a photo and on text, screen content (palette),
128x128 superblocks (aom's ``sb-size`` option), RGBA (an alpha item),
an ICC profile beside the ``nclx`` box, ``irot`` / ``imir`` (PIL writes an
EXIF orientation as those), an ``avis``
sequence, premultiplied RGBA, and the 12 golden scenes of ``tests/fixtures/golden_offline``
at 4:2:0 in 2x2 tiles (scene 3 also at 4:4:4). What PIL cannot ask for is made here from its
files: other ``colr`` matrices (the box rewritten in place), and a
container writer (``heif``) for ``iloc`` versions 1 and 2 with
construction method 1 (``idat``), several extents, ``infe`` version 3,
no ``colr`` box, and a ``grid`` item. Each file is decoded by PIL as it is
written, so a file PIL cannot read stops the script.

The lossy files (``lossy_*``, PIL's writer below ``quality=100``, 64x64 or
smaller unless named) cover qualities 97 to 5 (every coefficient q
context, and the last base_q_idx of each of the first three), 4:0:0 / 4:2:2 / 4:4:4, aom's speeds 5, 8 and 10 on a photo and on
text and speed 2 on a text image whose frame uses no loop restoration, a
37x63 image, a 64x64 ramp at quality 20 (64-point transforms), the
rectangular transforms aom writes only at its slowest speed (with loop
restoration turned off; some 128x128), 128x128 superblocks, 2x2 tiles
(128x128), CDEF (aom's ``enable-cdef``) at qualities 50 and 20 on 4:2:0
and 4:4:4 photo and text and with two strength sets (128x128), chroma
delta q, deblocking sharpness 4 and 7, RGBA, screen content with palette, and
scene 3 at 4:2:0 and 4:4:4. For ``chip_smoke.py`` only:
the 12 golden scenes at PIL's default quality (``scene_NN_q75.avif``) and
``tests/fixtures/test_image.jpg`` as ``photo_640x480_q75.avif``.

``hashes.json`` holds each file's shape and the sha256 of
``np.array(PIL.Image.open(f).convert("RGB"))``; ``lossy`` marks the lossy
files and ``chip`` the ones only ``chip_smoke.py`` reads; for the files the
port refuses, ``refused`` holds the words its ``NotImplementedError`` names
(film grain, a grid, loop restoration at aom's speed 0, quantiser
matrices).
Scene 3 is also written at 4:4:4, for the timings. The script needs PIL;
the files do not.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from make_image_fixtures import scene  # noqa: E402

GOLDEN = os.path.join(HERE, "..", "tests", "fixtures", "golden_offline")
OUT = os.path.join(HERE, "..", "tests", "fixtures", "avif")


def pil_avif(image, **options) -> bytes:
    from PIL import Image

    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)
    options.setdefault("quality", 100)
    options.setdefault("max_threads", 1)
    buf = io.BytesIO()
    image.save(buf, "AVIF", **options)
    return buf.getvalue()


def text_image(height, width, seed=0, background=(250, 250, 245)) -> np.ndarray:
    """Dark words on a light page, drawn with PIL's default font."""
    from PIL import Image, ImageDraw

    rng = np.random.RandomState(seed)
    image = Image.new("RGB", (width, height), background)
    draw = ImageDraw.Draw(image)
    for k in range(max(2, height * width // 500)):
        colour = tuple(int(v) for v in rng.randint(0, 160, 3))
        draw.text((int(rng.randint(-4, width - 8)), int(rng.randint(-4, height - 8))),
                  "Ab%d" % k, fill=colour)
    return np.array(image)


# ---------------------------------------------------------------------------
# Boxes
# ---------------------------------------------------------------------------

def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(body), kind) + body


def full_box(kind: bytes, version: int, flags: int, body: bytes) -> bytes:
    return box(kind, bytes([version]) + flags.to_bytes(3, "big") + body)


def find_box(blob: bytes, path) -> tuple:
    """(start, end) of the box at ``path`` (types from the top), whole box."""
    start, end = 0, len(blob)
    for depth, kind in enumerate(path):
        pos = start
        found = None
        while pos < end:
            size, k = struct.unpack(">I4s", blob[pos:pos + 8])
            if k == kind:
                found = (pos, pos + size)
                break
            pos += size
        if found is None:
            raise LookupError(f"no {kind!r} box")
        start, end = found
        if depth + 1 < len(path):
            start += 12 if kind == b"meta" else 8
    return found


def set_nclx(blob: bytes, matrix: int, full_range: int, primaries: int = 1,
             transfer: int = 13) -> bytes:
    """The file with its colr nclx box's values replaced."""
    at = blob.index(b"colrnclx") + 4
    new = b"nclx" + struct.pack(">HHHB", primaries, transfer, matrix, full_range << 7)
    return blob[:at] + new + blob[at + len(new):]


def item_payload(blob: bytes) -> tuple:
    """(AV1 data, av1C body, ispe body, pixi body) of a one-item PIL file."""
    from keras_ocr_tpu_torch import avif

    data, props, _ = avif._parse(blob)
    bodies = {k: blob[s:e] for k, (s, e) in props.items()}
    return data, bodies[b"av1C"], bodies[b"ispe"], bodies[b"pixi"]


def heif(items, primary, properties, associations, refs=(), iloc_version=0, infe_version=2,
         ipma_version=0, ipma_flags=0, split=1, brands=(b"avif", b"mif1", b"miaf")) -> bytes:
    """An AVIF file. ``items``: (id, type, data, construction method);
    ``properties``: property boxes; ``associations``: item -> [(index,
    essential)], 1-based; ``refs``: (type, from, [to]); ``split``: the
    extents each item's data is cut into."""
    ids = 2 if iloc_version < 2 else 4
    idat = b"".join(data for _, _, data, method in items if method == 1)

    def build(mdat_offset):
        hdlr = full_box(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 12 + b"\0")
        pitm = full_box(b"pitm", 0 if ids == 2 else 1, 0, primary.to_bytes(ids, "big"))
        rows = b""
        file_pos, idat_pos = mdat_offset, 0
        for item, _, data, method in items:
            cuts = [len(data) * k // split for k in range(split + 1)]
            extents = b""
            for a, b in zip(cuts, cuts[1:]):
                offset = (file_pos if method == 0 else idat_pos) + a
                extents += struct.pack(">II", offset, b - a)
            rows += item.to_bytes(ids, "big")
            if iloc_version:
                rows += struct.pack(">H", method)
            rows += struct.pack(">HH", 0, split) + extents
            if method == 0:
                file_pos += len(data)
            else:
                idat_pos += len(data)
        sizes = struct.pack(">BB", 0x44, 0x00)
        count = len(items).to_bytes(2 if iloc_version < 2 else 4, "big")
        iloc = full_box(b"iloc", iloc_version, 0, sizes + count + rows)
        entries = b""
        for item, kind, _, _ in items:
            head = item.to_bytes(2 if infe_version == 2 else 4, "big")
            entries += full_box(b"infe", infe_version, 0, head + b"\0\0" + kind + b"\0")
        iinf = full_box(b"iinf", 0, 0, struct.pack(">H", len(items)) + entries)
        iref = b""
        if refs:
            body = b""
            for kind, source, targets in refs:
                body += box(kind, source.to_bytes(2, "big") + struct.pack(">H", len(targets))
                            + b"".join(t.to_bytes(2, "big") for t in targets))
            iref = full_box(b"iref", 0, 0, body)
        ipco = box(b"ipco", b"".join(properties))
        rows = b""
        for item, assoc in associations.items():
            rows += item.to_bytes(2 if ipma_version == 0 else 4, "big") + bytes([len(assoc)])
            for index, essential in assoc:
                if ipma_flags & 1:
                    rows += struct.pack(">H", (essential << 15) | index)
                else:
                    rows += bytes([(essential << 7) | index])
        ipma = full_box(b"ipma", ipma_version, ipma_flags,
                        struct.pack(">I", len(associations)) + rows)
        iprp = box(b"iprp", ipco + ipma)
        meta = full_box(b"meta", 0, 0, hdlr + pitm + iloc + iinf + iref + iprp
                        + (box(b"idat", idat) if idat else b""))
        ftyp = box(b"ftyp", brands[0] + b"\0\0\0\0" + b"".join(brands))
        mdat_data = b"".join(data for _, _, data, method in items if method == 0)
        return ftyp + meta, box(b"mdat", mdat_data)

    head, _ = build(0)
    head, mdat = build(len(head) + 8)
    return head + mdat


def rebuilt(blob: bytes, grid=False, colr=True, extra=(), **layout) -> bytes:
    """A PIL file's image in a container written here; ``extra``: more
    property boxes of the image item."""
    data, av1c, ispe, pixi = item_payload(blob)
    nclx_start, nclx_end = find_box(blob, (b"meta", b"iprp", b"ipco", b"colr"))
    properties = [box(b"ispe", ispe), box(b"pixi", pixi), box(b"av1C", av1c)]
    if colr:
        properties.append(blob[nclx_start:nclx_end])
    properties += list(extra)
    # av1C and the transformative properties are marked essential.
    image_props = [(k + 1, int(prop[4:8] in (b"av1C", b"clap", b"irot", b"imir")))
                   for k, prop in enumerate(properties)]
    method = 1 if layout.get("iloc_version") else 0
    if not grid:
        return heif([(1, b"av01", data, method)], 1, properties, {1: image_props}, **layout)
    width, height = struct.unpack(">II", ispe[4:12])
    grid_body = bytes([0, 0, 0, 0]) + struct.pack(">HH", width, height)
    items = [(1, b"av01", data, 0), (2, b"grid", grid_body, 1)]
    grid_props = [(1, 0)] + ([(4, 0)] if colr else [])
    return heif(items, 2, properties, {1: image_props, 2: grid_props},
                refs=[(b"dimg", 2, [1])], iloc_version=1, **layout)


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

def _exif(orientation: int) -> bytes:
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = orientation
    return exif.tobytes()


def small_fixtures() -> dict:
    """name -> (bytes, refused kind or None). Each 64x64 or smaller."""
    from PIL import Image

    photo = scene(37, 63, seed=3)
    photo48 = scene(48, 64, seed=5)
    noisy = np.random.RandomState(6)
    text48 = text_image(48, 64, seed=1)
    out = {}
    for sub in ("4:4:4", "4:2:2", "4:2:0", "4:0:0"):
        for rng in ("full", "limited"):
            out[f"sub{sub.replace(':', '')}_{rng}.avif"] = pil_avif(photo, subsampling=sub,
                                                                   range=rng)
    for speed in (0, 4, 6, 8, 10):
        out[f"speed{speed}_photo420.avif"] = pil_avif(photo48, speed=speed)
        out[f"speed{speed}_text444.avif"] = pil_avif(text48, speed=speed, subsampling="4:4:4")
    screen = text_image(64, 64, seed=2)
    out["screen_palette444.avif"] = pil_avif(screen, subsampling="4:4:4",
                                             advanced={"tune-content": "screen"})
    out["screen_palette420.avif"] = pil_avif(text_image(40, 56, seed=4),
                                             advanced={"tune-content": "screen"})
    out["screen_palette_speed0.avif"] = pil_avif(screen, subsampling="4:4:4", speed=0,
                                                 advanced={"tune-content": "screen"})
    out["screen_speed3_partitions.avif"] = pil_avif(text_image(64, 64, seed=3), speed=3,
                                                    subsampling="4:4:4",
                                                    advanced={"tune-content": "screen"})
    ramp = np.tile(np.linspace(0, 255, 64).astype(np.uint8)[None, :, None], (64, 1, 3))
    out["ramp_block64.avif"] = pil_avif(ramp, speed=0)
    out["sb128.avif"] = pil_avif(scene(64, 64, seed=7), advanced={"sb-size": "128"})
    out["sb128_444.avif"] = pil_avif(text_image(64, 60, seed=8), subsampling="4:4:4",
                                     advanced={"sb-size": "128"})
    rgba = np.dstack([photo48, (np.arange(64)[None, :] * 4 + np.zeros((48, 1))).astype(np.uint8)])
    out["rgba.avif"] = pil_avif(Image.fromarray(rgba, "RGBA"))
    out["rgba_premultiplied.avif"] = pil_avif(Image.fromarray(rgba, "RGBA"),
                                              alpha_premultiplied=True)
    out["rgba_premultiplied444.avif"] = pil_avif(
        Image.fromarray(noisy.randint(0, 256, (24, 32, 4)).astype(np.uint8), "RGBA"),
        alpha_premultiplied=True, subsampling="4:4:4")
    out["grey_L.avif"] = pil_avif(Image.fromarray(photo48[:, :, 1], "L"))
    from PIL import ImageCms

    icc = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
    # The nclx box, after the ICC profile's, says BT.709; the AV1 stream
    # keeps aom's BT.601.
    out["colr_icc_and_nclx709.avif"] = set_nclx(pil_avif(photo48, icc_profile=icc), 1, 1)
    out["irot_orientation6.avif"] = pil_avif(photo48, exif=_exif(6))
    out["imir_orientation2.avif"] = pil_avif(photo48, exif=_exif(2))
    out["irot_imir_orientation5.avif"] = pil_avif(photo48, exif=_exif(5))
    frames = [Image.fromarray(photo48), Image.fromarray(255 - photo48)]
    out["sequence_avis.avif"] = _save_all(frames)
    rgba_frames = [Image.fromarray(noisy.randint(0, 256, (24, 32, 4)).astype(np.uint8), "RGBA")
                   for _ in range(2)]
    out["sequence_avis_premultiplied.avif"] = _save_all(rgba_frames, alpha_premultiplied=True)
    source444 = pil_avif(photo, subsampling="4:4:4")
    source420 = pil_avif(photo)
    for matrix, label in ((1, "bt709"), (9, "bt2020"), (5, "bt470bg"), (2, "unspecified")):
        for full in (1, 0):
            rng = "full" if full else "limited"
            out[f"matrix_{label}_{rng}.avif"] = set_nclx(source420, matrix, full)
    out["matrix_bt709_full444.avif"] = set_nclx(source444, 1, 1)
    out["matrix_identity444.avif"] = set_nclx(source444, 0, 1)
    out["container_iloc1_idat.avif"] = rebuilt(source420, iloc_version=1)
    out["container_iloc2_infe3.avif"] = rebuilt(source420, iloc_version=2, infe_version=3,
                                                ipma_version=1, ipma_flags=1)
    out["container_three_extents.avif"] = rebuilt(source420, split=3)
    out["container_no_colr.avif"] = rebuilt(source420, colr=False)
    # A clean aperture (the centred 61x35 of 63x37), a pixel aspect ratio,
    # a rotation and a mirror: libavif crops, scales and turns nothing.
    clap = box(b"clap", struct.pack(">8i", 61, 1, 35, 1, 0, 1, 0, 1))
    out["container_clap_pasp_irot_imir.avif"] = rebuilt(
        source420, extra=[clap, box(b"pasp", struct.pack(">II", 1, 1)), box(b"irot", b"\x01"),
                          box(b"imir", b"\x00")])
    refused = {
        "refused_film_grain.avif": (pil_avif(text48, subsampling="4:4:4",
                                             advanced={"film-grain-test": "1"}), "film grain"),
        # libavif takes grid cells of 64x64 and up only.
        "refused_grid.avif": (rebuilt(pil_avif(scene(64, 64, seed=9)), grid=True), "grid"),

    }
    return {**{name: (blob, None) for name, blob in out.items()}, **refused}


def lossy_fixtures() -> dict:
    """name -> (bytes, refused kind or None): PIL's lossy files."""
    from PIL import Image

    photo48 = scene(48, 64, seed=5)
    text48 = text_image(48, 64, seed=1)
    out = {}
    # Qualities 92, 76 and 53 give base_q_idx 20, 60 and 120: the last of
    # q contexts 0, 1 and 2.
    for quality in (97, 92, 90, 76, 75, 53, 50, 20, 5):
        out[f"lossy_photo48_q{quality}.avif"] = pil_avif(photo48, quality=quality)
    out["lossy_sub400_q75.avif"] = pil_avif(Image.fromarray(photo48[:, :, 1], "L"), quality=75)
    for sub in ("4:2:2", "4:4:4"):
        out[f"lossy_sub{sub.replace(':', '')}_q75.avif"] = pil_avif(photo48, quality=75,
                                                                    subsampling=sub)
    for speed in (5, 8, 10):
        out[f"lossy_speed{speed}_photo420.avif"] = pil_avif(photo48, quality=75, speed=speed)
        out[f"lossy_speed{speed}_text444.avif"] = pil_avif(text48, quality=75, speed=speed,
                                                           subsampling="4:4:4")
    # aom sets enable_restoration in the sequence header, and no plane of
    # this frame uses it.
    out["lossy_speed2_text420.avif"] = pil_avif(text_image(48, 64, seed=3), quality=75, speed=2)
    out["lossy_shape37x63_q75.avif"] = pil_avif(scene(37, 63, seed=3), quality=75)
    ramp = np.tile(np.linspace(0, 255, 64).astype(np.uint8)[None, :, None], (64, 1, 3))
    out["lossy_ramp64_q20.avif"] = pil_avif(ramp, quality=20, speed=4)
    out["lossy_sb128_q75.avif"] = pil_avif(scene(64, 64, seed=7), quality=75,
                                           advanced={"sb-size": "128"})
    out["lossy_tiles2x2_128x128.avif"] = pil_avif(scene(128, 128, seed=7), quality=75,
                                                  tile_rows=1, tile_cols=1)
    for quality in (50, 20):
        for sub in ("4:2:0", "4:4:4"):
            label = sub.replace(":", "")
            out[f"lossy_cdef_photo{label}_q{quality}.avif"] = pil_avif(
                photo48, quality=quality, subsampling=sub, advanced={"enable-cdef": "1"})
            out[f"lossy_cdef_text{label}_q{quality}.avif"] = pil_avif(
                text48, quality=quality, subsampling=sub, advanced={"enable-cdef": "1"})
    photo = np.array(Image.open(os.path.join(HERE, "..", "tests", "fixtures", "test_image.jpg"))
                     .convert("RGB"))
    # aom's slower speeds, with loop restoration off, reach the transform
    # sizes the default speed does not: 4x16 / 16x4 and a tx_depth of 2,
    # 32x64, 64x32, 8x32, 16x64, 64x16, and 32x8 with two CDEF strength sets.
    slow = {"enable-restoration": "0", "enable-cdef": "1"}
    crop64, crop128 = photo[150:214, 250:314], photo[100:228, 200:328]
    out["lossy_tx4x16_speed0.avif"] = pil_avif(scene(64, 64, seed=5), quality=75, speed=0,
                                               advanced=slow)
    out["lossy_tx32x64_speed0.avif"] = pil_avif(crop64, quality=20, speed=0, advanced=slow)
    out["lossy_tx64x32_speed0.avif"] = pil_avif(crop64.transpose(1, 0, 2).copy(), quality=20,
                                                speed=0, advanced=slow)
    out["lossy_tx8x32_speed0_128x128.avif"] = pil_avif(crop128, quality=20, speed=0,
                                                       advanced=slow)
    stripes = np.tile((np.arange(128)[None, :, None] // 16 % 2 * 120 + 60).astype(np.uint8),
                      (128, 1, 3))
    out["lossy_tx16x64_stripes_128x128.avif"] = pil_avif(stripes, quality=20, speed=0,
                                                         advanced=slow)
    out["lossy_tx64x16_stripes_128x128.avif"] = pil_avif(stripes.transpose(1, 0, 2).copy(),
                                                         quality=20, speed=0, advanced=slow)
    out["lossy_cdef_strengths_128x128.avif"] = pil_avif(crop128, quality=50, speed=2,
                                                        advanced=slow)
    out["lossy_chroma_deltaq_q75.avif"] = pil_avif(photo48, quality=75,
                                                   advanced={"enable-chroma-deltaq": "1"})
    for sharpness, quality in ((4, 75), (4, 20), (7, 20)):
        out[f"lossy_sharpness{sharpness}_q{quality}.avif"] = pil_avif(
            photo48, quality=quality, advanced={"sharpness": str(sharpness)})
    rgba = np.dstack([photo48, (np.arange(64)[None, :] * 4 + np.zeros((48, 1))).astype(np.uint8)])
    out["lossy_rgba_q75.avif"] = pil_avif(Image.fromarray(rgba, "RGBA"), quality=75)
    out["lossy_screen_palette_q75.avif"] = pil_avif(text_image(64, 64, seed=2), quality=75,
                                                    subsampling="4:4:4",
                                                    advanced={"tune-content": "screen"})
    with open(os.path.join(GOLDEN, "expected.json"), encoding="utf8") as f:
        names = [entry["image"] for entry in json.load(f)["scenes"]]
    scene3 = np.array(Image.open(os.path.join(GOLDEN, "scene_03.png")).convert("RGB"))
    out["lossy_scene_03_q75_444.avif"] = pil_avif(scene3, quality=75, subsampling="4:4:4")
    refused = {
        "refused_lossy_speed0_restoration.avif": (pil_avif(photo48, quality=75, speed=0),
                                                  "loop restoration"),
        "refused_lossy_qm.avif": (pil_avif(photo48, quality=75, advanced={"enable-qm": "1"}),
                                  "using_qmatrix"),
    }
    chip = {}
    for name in names:
        rgb = np.array(Image.open(os.path.join(GOLDEN, name)).convert("RGB"))
        chip[name.replace(".png", "_q75.avif")] = pil_avif(rgb, quality=75)
    chip["photo_640x480_q75.avif"] = pil_avif(photo, quality=75)
    return {**{name: (blob, None) for name, blob in out.items()}, **refused,
            **{name: (blob, "chip") for name, blob in chip.items()}}


def _save_all(frames, **options) -> bytes:
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:], quality=100,
                   max_threads=1, duration=100, **options)
    return buf.getvalue()


def golden_fixtures() -> dict:
    """The 12 golden scenes at 4:2:0 in 2x2 tiles, named as their PNGs,
    and scene 3 at 4:4:4."""
    from PIL import Image

    with open(os.path.join(GOLDEN, "expected.json"), encoding="utf8") as f:
        scenes = [entry["image"] for entry in json.load(f)["scenes"]]
    out = {}
    for name in scenes:
        rgb = np.array(Image.open(os.path.join(GOLDEN, name)).convert("RGB"))
        out[name.replace(".png", ".avif")] = (pil_avif(rgb, tile_rows=1, tile_cols=1), None)
        if name == "scene_03.png":
            out["scene_03_444.avif"] = (pil_avif(rgb, subsampling="4:4:4", tile_rows=1,
                                                 tile_cols=1), None)
    return out


def pil_decode(blob: bytes) -> np.ndarray:
    from PIL import Image

    return np.array(Image.open(io.BytesIO(blob)).convert("RGB"))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=OUT)
    args = parser.parse_args()
    sys.path.insert(0, os.path.join(HERE, ".."))
    os.makedirs(args.out, exist_ok=True)
    hashes = {}
    lossy = lossy_fixtures()
    for name, (blob, refused) in {**small_fixtures(), **golden_fixtures(), **lossy}.items():
        rgb = pil_decode(blob)
        hashes[name] = {"shape": list(rgb.shape),
                        "decoded_sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
        if name in lossy:
            hashes[name]["lossy"] = True
        if refused == "chip":
            hashes[name]["chip"] = True
        elif refused:
            hashes[name]["refused"] = refused
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(blob)
        print(name, len(blob), "bytes", hashes[name]["shape"], refused or "")
    with open(os.path.join(args.out, "hashes.json"), "w", encoding="utf8") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
