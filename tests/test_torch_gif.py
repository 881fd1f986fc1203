"""Port parity: GIF reading and the JPEG writer of the ICDAR 2019 loader.

``tools.read`` / ``tools.decode_gif`` against PIL's
``Image.open(f).convert("RGB")``, pixel for pixel, on GIFs written here:
by ``scripts/make_gif_fixtures.py:write_gif`` (global and local colour
tables, interlaced frames, a transparent index, a first frame smaller
than the logical screen or reaching past it, grey ramps that PIL opens in
mode ``L``, LZW code sizes 2-8, streams past 4096 codes with a clear code
and with the table left full) and by PIL's own writer; the committed
fixtures against the hashes PIL gave (``tests/fixtures/gif/hashes.json``);
corrupt files raise ``ValueError``. The private JPEG encoder against
``PIL.Image.save``: the same bytes, so the same pixels by PIL's decoder and
by the port's. The ICDAR 2019 loader's conversion against JAX's on two
copies of one cache, both packages' download helpers patched to no-ops.
"""

import hashlib
import io
import json
import os
import shutil
import sys
import urllib.request

import numpy as np
import pytest
from PIL import Image

from keras_ocr_tpu import tools as jtools
from keras_ocr_tpu.data import datasets as jdatasets
from keras_ocr_tpu_torch import tools
from keras_ocr_tpu_torch.data import datasets

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from make_gif_fixtures import (fixture_gifs, lzw_codes, pack_codes,  # noqa: E402
                               write_gif)

GIF_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "gif")
RNG = np.random.RandomState(7)
COLOURS = RNG.randint(0, 256, (256, 3)).astype(np.uint8)
GREY = np.arange(256, dtype=np.uint8)[:, None].repeat(3, 1)
SMOOTH = ((np.mgrid[:45, :53].sum(0) // 5) % 16).astype(np.uint8)
NOISE = RNG.randint(0, 256, (70, 90)).astype(np.uint8)


def _pil_written(mode, **kwargs):
    rgb = RNG.randint(0, 200, (29, 41, 3)).astype(np.uint8)
    rgb[10:20, 5:30] = (250, 10, 10)
    image = Image.fromarray(rgb) if mode == "RGB" else Image.fromarray(rgb).convert(mode)
    out = io.BytesIO()
    image.save(out, format="GIF", **kwargs)
    return out.getvalue()


CASES = {
    "global_palette": lambda: write_gif(SMOOTH, global_palette=COLOURS[:16]),
    "local_palette": lambda: write_gif(SMOOTH, global_palette=COLOURS[:16],
                                       local_palette=COLOURS[100:116]),
    "local_only": lambda: write_gif(SMOOTH, local_palette=COLOURS[:16]),
    "interlaced": lambda: write_gif(SMOOTH, global_palette=COLOURS[:16], interlace=True),
    "interlaced_short": lambda: write_gif(SMOOTH[:3], global_palette=COLOURS[:16],
                                          interlace=True),
    "transparent": lambda: write_gif(SMOOTH, global_palette=COLOURS[:16], transparency=4),
    "partial_first_frame": lambda: write_gif(SMOOTH[:20, :30], screen=(53, 45), offset=(9, 11),
                                             global_palette=COLOURS[:16], background=3),
    "partial_transparent": lambda: write_gif(SMOOTH[:20, :30], screen=(53, 45), offset=(9, 11),
                                             global_palette=COLOURS[:16], background=3,
                                             transparency=7),
    "past_the_screen": lambda: write_gif(SMOOTH[:20, :30], screen=(25, 15), offset=(4, 6),
                                         global_palette=COLOURS[:16]),
    "grey_palette": lambda: write_gif(NOISE, global_palette=GREY, min_size=8),
    "grey_partial_transparent": lambda: write_gif(SMOOTH[:9, :9], screen=(20, 20), offset=(3, 3),
                                                  global_palette=GREY[:16], transparency=12),
    "grey_local_colour_global": lambda: write_gif(SMOOTH, global_palette=COLOURS[:16],
                                                  local_palette=GREY[:16]),
    "no_palette": lambda: write_gif(NOISE, min_size=8),
    "index_past_the_palette": lambda: write_gif(SMOOTH, global_palette=COLOURS[:4], min_size=4),
    "code_size_2": lambda: write_gif(SMOOTH % 4, global_palette=COLOURS[:4], min_size=2),
    "code_size_8": lambda: write_gif(SMOOTH, global_palette=COLOURS[:16], min_size=8),
    "past_4096_codes_clear": lambda: write_gif(NOISE, global_palette=COLOURS, min_size=8),
    "past_4096_codes_deferred": lambda: write_gif(NOISE, global_palette=COLOURS, min_size=8,
                                                  clear_when_full=False),
    "deferred_small_codes": lambda: write_gif(RNG.randint(0, 4, (150, 160)), min_size=2,
                                              global_palette=COLOURS[:4],
                                              clear_when_full=False),
    "gif87a_second_frame": lambda: write_gif(SMOOTH, global_palette=COLOURS[:16],
                                             version=b"GIF87a",
                                             frames=[(SMOOTH[:5, :5] + 1, (2, 2))]),
    "pil_p": lambda: _pil_written("P"),
    "pil_l": lambda: _pil_written("L"),
    "pil_rgb_interlaced": lambda: _pil_written("RGB", interlace=True),
    "pil_p_transparency": lambda: _pil_written("P", transparency=3),
}


def _pil_rgb(blob):
    return np.array(Image.open(io.BytesIO(blob)).convert("RGB"))


@pytest.mark.parametrize("case", CASES)
def test_gif_decodes_as_pil(case):
    blob = CASES[case]()
    ours = tools.read(io.BytesIO(blob))
    ref = _pil_rgb(blob)
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def test_lzw_stream_cases_reach_the_decoder():
    """The writer's streams hold what the cases claim: a KwKwK code, a
    clear code past 4096 codes, and 12-bit codes past a full table."""
    codes = lzw_codes(bytes(NOISE.ravel()), 8)
    assert sum(code == 256 for code, _ in codes) >= 2
    deferred = lzw_codes(bytes(NOISE.ravel()), 8, clear_when_full=False)
    assert sum(code == 256 for code, _ in deferred) == 1
    assert sum(width == 12 for _, width in deferred) > 1000
    # 0, 00, 000: each of the last two is the next free code when read.
    runs = lzw_codes(bytes(6), 2)
    assert [code for code, _ in runs] == [4, 0, 6, 7, 5]
    np.testing.assert_array_equal(
        tools.read(io.BytesIO(write_gif(np.zeros((2, 3)), global_palette=COLOURS[:4]))),
        np.broadcast_to(COLOURS[0], (2, 3, 3)))


def test_fixtures_match_pil_hashes():
    with open(os.path.join(GIF_DIR, "hashes.json")) as f:
        hashes = json.load(f)
    assert sorted(hashes) == sorted(fixture_gifs())
    assert sum(os.path.getsize(os.path.join(GIF_DIR, n)) for n in hashes) < 50_000
    for name, expected in hashes.items():
        path = os.path.join(GIF_DIR, name)
        with open(path, "rb") as f:
            assert f.read() == fixture_gifs()[name], name
        ours = tools.read(path)
        assert list(ours.shape) == expected["shape"]
        assert hashlib.sha256(ours.tobytes()).hexdigest() == expected["decoded_sha256"], name
        np.testing.assert_array_equal(ours, _pil_rgb(fixture_gifs()[name]))
        encoded = tools._encode_jpeg(ours)
        assert hashlib.sha256(encoded).hexdigest() == expected["jpeg_sha256"], name


def _corrupt():
    good = write_gif(SMOOTH[:6, :8], global_palette=COLOURS[:4], min_size=4)
    image = good.index(b"\x2c", 13 + 12)  # after the 4-entry table
    head = good[: image + 10]
    body = lzw_codes(bytes((SMOOTH[:6, :8] % 4).ravel()), 4)
    return {
        "not_a_gif": b"GIF90a" + good[6:],
        "no_image": good[:13 + 12] + b"\x3b",
        "truncated_screen": good[:15],
        "truncated_data": good[:-12],
        "early_end_code": head + bytes([4]) + pack_codes(body[:4] + [(17, 5)]) + b"\x3b",
        "code_past_the_table": head + bytes([4]) + pack_codes([(16, 5), (1, 5), (30, 5)]) + b"\x3b",
        "code_size_12": head + bytes([12]) + good[image + 11:],
        "short_control_block": good[:13 + 12] + b"\x21\xf9\x02\x01\x00\x00" + good[13 + 12:],
    }


@pytest.mark.parametrize("case", sorted(_corrupt()))
def test_corrupt_gif_raises_value_error(case):
    with pytest.raises(ValueError):
        tools.read(io.BytesIO(_corrupt()[case]))


def test_read_takes_a_gif_path(tmp_path):
    path = tmp_path / "image.gif"
    path.write_bytes(CASES["interlaced"]())
    np.testing.assert_array_equal(tools.read(str(path)), jtools.read(str(path)))


ENCODER_SHAPES = [(1, 1), (7, 9), (8, 8), (15, 17), (16, 16), (33, 31), (64, 96), (121, 203)]


def _encoder_image(shape, kind):
    if kind == "noise":
        return np.random.RandomState(shape[0] * 1000 + shape[1]).randint(
            0, 256, shape + (3,)).astype(np.uint8)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    return np.stack([(xx * 3 + yy) % 256, (yy * 7) % 256, ((xx ^ yy) * 5) % 256],
                    -1).astype(np.uint8)


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("shape", ENCODER_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_encoder_writes_pils_bytes(shape, kind):
    image = _encoder_image(shape, kind)
    ref = io.BytesIO()
    Image.fromarray(image).save(ref, format="JPEG")
    ours = tools._encode_jpeg(image)
    pil_pixels = np.array(Image.open(io.BytesIO(ref.getvalue())).convert("RGB"))
    np.testing.assert_array_equal(np.array(Image.open(io.BytesIO(ours)).convert("RGB")),
                                  pil_pixels)
    np.testing.assert_array_equal(tools.read(io.BytesIO(ours)), pil_pixels)
    assert ours == ref.getvalue()


def test_jpeg_encoder_on_the_photo_fixture():
    image = tools.read(os.path.join(os.path.dirname(__file__), "fixtures", "test_image.jpg"))
    ref = io.BytesIO()
    Image.fromarray(image).save(ref, format="JPEG")
    assert tools._encode_jpeg(image) == ref.getvalue()


def test_jpeg_encoder_refuses_other_arrays():
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 3), np.float32), np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises(ValueError):
            tools._encode_jpeg(bad)


def _icdar_2019_cache(root):
    """An ICDAR 2019 cache with 2 JPEGs and the GIF fixtures (5000 files in
    neither part, so both loaders call the patched download helpers)."""
    main = root / "icdar2019"
    entries = []
    for part in ("ImagesPart1", "ImagesPart2"):
        (main / part).mkdir(parents=True)
    names = sorted(fixture_gifs())
    for i, name in enumerate(names):
        part = "ImagesPart1" if i % 2 else "ImagesPart2"
        shutil.copyfile(os.path.join(GIF_DIR, name), main / part / f"tr_img_{i:05d}.gif")
        entries.append({"filepath": f"{part}/tr_img_{i:05d}.jpg", "percent_complete": 0.6 + i / 20,
                        "lines": [{"line": [[[1, -2], [9, 0], [9, 7], [-1, 7]]]}]})
    Image.fromarray(_encoder_image((20, 30), "smooth")).save(main / "ImagesPart1" / "a.jpg")
    entries.append({"filepath": "ImagesPart1/a.jpg", "percent_complete": 0.4, "lines": []})
    (main / "mlt2019_dataset.json").write_text(json.dumps({"dataset": entries}))
    return main


def test_icdar_2019_conversion_matches_jax(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise OSError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    for module in (tools, jtools):
        monkeypatch.setattr(module, "download_and_extract", lambda *args, **kwargs: None)
    ours_main = _icdar_2019_cache(tmp_path / "ours")
    theirs_main = _icdar_2019_cache(tmp_path / "theirs")
    with pytest.warns(UserWarning):
        ours = datasets.get_icdar_2019_semisupervised_dataset(cache_dir=str(tmp_path / "ours"))
    with pytest.warns(UserWarning):
        theirs = jdatasets.get_icdar_2019_semisupervised_dataset(
            cache_dir=str(tmp_path / "theirs"))
    assert len(ours) == len(theirs) == len(fixture_gifs())
    for (path, lines, percent), (ref_path, ref_lines, ref_percent) in zip(ours, theirs):
        assert os.path.relpath(path, ours_main) == os.path.relpath(ref_path, theirs_main)
        assert percent == ref_percent
        assert len(lines) == len(ref_lines)
        for line, ref_line in zip(lines, ref_lines):
            for (box, char), (ref_box, ref_char) in zip(line, ref_line):
                np.testing.assert_array_equal(box, ref_box)
                assert char is ref_char is None
    for main in (ours_main, theirs_main):
        assert not list(main.glob("*/*.gif"))
    for path in sorted(theirs_main.glob("*/*.jpg")):
        mine = ours_main / path.relative_to(theirs_main)
        assert mine.read_bytes() == path.read_bytes(), path.name
        np.testing.assert_array_equal(tools.read(str(mine)), jtools.read(str(path)))
