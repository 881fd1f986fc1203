"""The port's TrueType reader and glyph rasteriser
(``keras_ocr_tpu_torch/data/fonts.py``, ``data/raster.py``) against
fontTools and PIL, and ``font_supports_alphabet`` / ``get_fonts`` against
the JAX package's, on the CPU.

Fonts: the port's default font (the Aileron face PIL's ``load_default``
embeds), the DejaVu Sans / Serif / Mono files of the system, and a font
written here with fontTools' ``FontBuilder`` that holds a composite glyph
with a 2x2 transform, a point-matched composite, a glyph of contours of
off-curve points only, and a format-12 cmap entry above U+FFFF.

Bars:
- outline points, contour ends and on-curve flags equal fontTools'
  ``getCoordinates`` exactly; the unicode cmap equals ``getBestCmap``;
- the coverage of the flattened polygons is within 1/255 of an exact
  per-pixel polygon-clip reference written here (Sutherland-Hodgman);
- ``getsize`` is within 1 px of PIL's ``font.font.getsize`` on every number
  and equal on at least 90% of them, pooled over the four fonts at
  10/14/18/24/40 px over letters and digits (PIL hints, the port does not;
  measured: Aileron 84.2%, DejaVu Sans 95.6%, Serif 90.7%, Mono 95.6%);
- each glyph's summed coverage is within 30% of PIL's mask's (measured
  0.70-1.26 on Aileron, 0.72-1.13 on DejaVu);
- ``getmetrics`` equals PIL's at every size from 6 to 64;
- ``draw_bitmap`` given PIL's own mask equals ``ImageDraw.text``'s RGBA
  result bit for bit;
- ``font_supports_alphabet`` and ``get_fonts`` (downloads monkeypatched
  away in both packages) give JAX's results exactly;
- the render of one fixed string with the default font has the sha256
  that ``chip_smoke.py`` holds the card's render to.
"""

import hashlib
import io
import math
import os
import string
import subprocess
import sys

import numpy as np
import PIL.Image
import PIL.ImageDraw
import PIL.ImageFont
import pytest
from fontTools.fontBuilder import FontBuilder
from fontTools.pens.ttGlyphPen import TTGlyphPen
from fontTools.ttLib import TTFont

from keras_ocr_tpu import tools as jtools
from keras_ocr_tpu.data import generation as jgen
from keras_ocr_tpu_torch import tools
from keras_ocr_tpu_torch.data import fonts, generation, raster

DEJAVU = "/usr/share/fonts/truetype/dejavu"
DEJAVU_FILES = [os.path.join(DEJAVU, f"{name}.ttf")
                for name in ("DejaVuSans", "DejaVuSerif", "DejaVuSansMono")]
LETTERS_DIGITS = string.ascii_letters + string.digits
SIZES = (10, 14, 18, 24, 40)

# sha256 of ``render_reference_string()``: the same constant is in
# chip_smoke.py, so that the card's numpy rasterises bit for bit as here.
REFERENCE_RENDER_SHA256 = "80b4dc795d8746d0cbbcd152dd2d0a1d9a292df104670e7244b1b49761171275"


def render_reference_string():
    """The default font at 40 px drawn into a 96 x 640 RGBA canvas, as
    chip_smoke.py draws it."""
    font = fonts.load_default(40)
    canvas = np.zeros((96, 640, 4), dtype=np.uint8)
    canvas[..., :3] = 255
    x = 8.0
    for character in "Synthetic fi text 0123 @&Q":
        mask, (dx, dy) = font.getmask2(character)
        raster.draw_bitmap(canvas, mask, (20, 30, 40, 255), (int(x) + dx, 20 + dy))
        x += font.getsize(character)[0][0] + font.getsize(character)[1][0]
    return canvas


@pytest.fixture(scope="module")
def built_font(tmp_path_factory):
    """A TrueType font with composites, an all-off-curve contour and a
    format-12 cmap."""
    fb = FontBuilder(1000, isTTF=True)
    names = [".notdef", "square", "ring", "composite", "matched", "smile"]
    fb.setupGlyphOrder(names)
    fb.setupCharacterMap({ord("A"): "square", ord("B"): "ring", ord("C"): "composite",
                          ord("D"): "matched", 0x1F600: "smile"})
    glyphs = {}

    def polygon(pen, points):
        pen.moveTo(points[0])
        for point in points[1:]:
            pen.lineTo(point)
        pen.closePath()

    pen = TTGlyphPen(None)
    polygon(pen, [(50, 0), (50, 700), (450, 700), (450, 0)])
    glyphs[".notdef"] = pen.glyph()
    pen = TTGlyphPen(None)
    polygon(pen, [(100, 0), (100, 600), (500, 600), (500, 0)])
    polygon(pen, [(200, 100), (400, 100), (400, 500), (200, 500)])
    glyphs["square"] = pen.glyph()
    pen = TTGlyphPen(None)
    # Four off-curve points only: the contour starts at an implied point.
    pen.qCurveTo((300, 0), (600, 300), (300, 600), (0, 300), None)
    pen.closePath()
    glyphs["ring"] = pen.glyph()
    pen = TTGlyphPen(glyphs)
    pen.addComponent("square", (0.75, 0.25, -0.125, 0.5, 30, -40))
    pen.addComponent("ring", (1, 0, 0, 1, 350, 200))
    glyphs["composite"] = pen.glyph()
    glyphs["matched"] = TTGlyphPen(None).glyph()
    pen = TTGlyphPen(None)
    pen.moveTo((0, 0))
    pen.qCurveTo((250, 500), (500, 0))
    pen.closePath()
    glyphs["smile"] = pen.glyph()
    fb.setupGlyf(glyphs)
    # A point-matched component: the ring's point 1 lands on the square's
    # point 6, written by hand since the pen writes offsets only.
    from fontTools.ttLib.tables._g_l_y_f import Glyph, GlyphComponent
    matched = Glyph()
    matched.numberOfContours = -1
    first = GlyphComponent()
    first.glyphName, first.flags, first.x, first.y = "square", 0, 0, 0
    second = GlyphComponent()
    second.glyphName, second.flags = "ring", 0
    second.firstPt, second.secondPt = 6, 1
    matched.components = [first, second]
    fb.font["glyf"]["matched"] = matched
    metrics = {name: (600, 0) for name in names}
    fb.setupHorizontalMetrics(metrics)
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "PortTest", "styleName": "Regular"})
    fb.setupOS2(sTypoAscender=800, sTypoDescender=-200, usWinAscent=800, usWinDescent=200)
    fb.setupPost()
    path = tmp_path_factory.mktemp("fonts") / "porttest.ttf"
    fb.save(str(path))
    return str(path)


@pytest.fixture(scope="module")
def default_font_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("default") / "aileron.ttf"
    path.write_bytes(fonts.default_font_bytes())
    return str(path)


def _pil_font(path, size):
    if path == "default":
        return PIL.ImageFont.truetype(io.BytesIO(fonts.default_font_bytes()), size,
                                      layout_engine=PIL.ImageFont.Layout.BASIC)
    return PIL.ImageFont.truetype(path, size)


def _port_font(path, size):
    if path == "default":
        return fonts.load_default(size)
    return fonts.truetype(path, size)


# ---------------------------------------------------------------------------
# The reader
# ---------------------------------------------------------------------------


def test_default_font_is_pils_embedded_aileron():
    """``load_default`` opens the bytes PIL's ``load_default`` embeds, at
    10 px."""
    pil = PIL.ImageFont.load_default()
    assert isinstance(pil, PIL.ImageFont.FreeTypeFont)
    font = fonts.load_default()
    assert font.size == 10 == pil.size
    blob = fonts.default_font_bytes()
    assert hashlib.sha256(blob).hexdigest() == "69853909b940023570964e29cffe30da95aea8de3627736b5cd15ab30143169f"
    assert pil.getname() == PIL.ImageFont.truetype(io.BytesIO(blob), 10).getname()
    for character in "Hello 0123":
        assert pil.font.getsize(character) == _pil_font("default", 10).font.getsize(character)


@pytest.mark.parametrize("which", ["default", "sans", "serif", "mono", "built"])
def test_outlines_equal_fonttools(which, built_font):
    path = {"sans": DEJAVU_FILES[0], "serif": DEJAVU_FILES[1], "mono": DEJAVU_FILES[2],
            "built": built_font}.get(which)
    ref = TTFont(io.BytesIO(fonts.default_font_bytes()) if which == "default" else path)
    face = fonts.open_face(path) if path else fonts.Face(fonts.default_font_bytes())
    order = ref.getGlyphOrder()
    glyf = ref["glyf"]
    # Every glyph of the small fonts; every 7th of DejaVu's thousands plus
    # every composite among the first 1500.
    if len(order) > 200:
        picked = sorted(set(range(0, len(order), 7))
                        | {i for i in range(1500) if glyf[order[i]].isComposite()})
    else:
        picked = range(len(order))
    composites = 0
    for index in picked:
        glyph = glyf[order[index]]
        coords, ends, flags = glyph.getCoordinates(glyf)
        outline = face.outline(index)
        np.testing.assert_array_equal(outline.points,
                                      np.array(coords, dtype=np.float64).reshape(-1, 2))
        assert list(outline.end_points) == list(ends)
        np.testing.assert_array_equal(outline.on_curve,
                                      (np.frombuffer(bytes(flags), dtype=np.uint8) & 1) == 1)
        composites += glyph.isComposite()
    assert composites > 0 or which == "default"
    best = ref.getBestCmap()
    assert face.cmap == {code: ref.getGlyphID(name) for code, name in best.items()}
    assert face.units_per_em == ref["head"].unitsPerEm
    np.testing.assert_array_equal(face.advances,
                                  [ref["hmtx"][name][0] for name in order])


def test_cmap_format_12_and_all_subtables(built_font):
    face = fonts.open_face(built_font)
    ref = TTFont(built_font)
    assert {t.format for t in ref["cmap"].tables} >= {4, 12}
    assert face.glyph_index("\U0001F600") == ref.getGlyphID("smile")
    assert face.glyph_index("Z") == 0
    assert face.all_codepoints == [frozenset(t.cmap) for t in ref["cmap"].tables]
    for path in DEJAVU_FILES:
        ref = TTFont(path)
        assert fonts.open_face(path).all_codepoints == [frozenset(t.cmap)
                                                        for t in ref["cmap"].tables]


def test_reader_refuses_what_it_cannot_read(tmp_path, built_font):
    """CFF outlines, font collections and missing tables raise
    ``ValueError`` naming them."""
    fb = FontBuilder(1000, isTTF=False)
    fb.setupGlyphOrder([".notdef"])
    fb.setupCharacterMap({})
    from fontTools.pens.t2CharStringPen import T2CharStringPen

    pen = T2CharStringPen(500, None)
    pen.moveTo((0, 0))
    pen.lineTo((0, 500))
    pen.lineTo((500, 0))
    pen.closePath()
    fb.setupCFF("Test", {"FullName": "Test"}, {".notdef": pen.getCharString()}, {})
    fb.setupHorizontalMetrics({".notdef": (500, 0)})
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": "CFFTest", "styleName": "Regular"})
    fb.setupOS2()
    fb.setupPost()
    cff = tmp_path / "cff.otf"
    fb.save(str(cff))
    with pytest.raises(ValueError, match="CFF"):
        fonts.Face(str(cff))
    with pytest.raises(ValueError, match="collections"):
        fonts.Face(b"ttcf" + bytes(64))
    broken = TTFont(built_font)
    del broken["hmtx"]
    path = tmp_path / "nohmtx.ttf"
    broken.save(str(path))
    with pytest.raises(ValueError, match="missing table 'hmtx'"):
        fonts.Face(str(path))
    assert not generation.font_supports_alphabet(str(cff), "A")


# ---------------------------------------------------------------------------
# The rasteriser
# ---------------------------------------------------------------------------


def _clip(polygon, inside, cross):
    """Sutherland-Hodgman against one half-plane: ``inside(p)`` and
    ``cross(p, q)`` its intersection with the boundary."""
    out = []
    for i in range(len(polygon)):
        p, q = polygon[i - 1], polygon[i]
        if inside(q):
            if not inside(p):
                out.append(cross(p, q))
            out.append(q)
        elif inside(p):
            out.append(cross(p, q))
    return out


def _clip_axis(polygon, axis, value, keep_above):
    def inside(p):
        return p[axis] >= value if keep_above else p[axis] <= value

    def cross(p, q):
        t = (value - p[axis]) / (q[axis] - p[axis])
        return tuple(p[k] + t * (q[k] - p[k]) for k in range(2))

    return _clip(polygon, inside, cross)


def _area(polygon):
    return 0.5 * sum(polygon[i - 1][0] * polygon[i][1] - polygon[i][0] * polygon[i - 1][1]
                     for i in range(len(polygon)))


def _reference_coverage(polygons, height, width):
    """|sum of the signed areas of each polygon clipped to each pixel|,
    clamped to 1: the nonzero-winding coverage the rasteriser computes."""
    total = np.zeros((height, width))
    for polygon in polygons:
        vertices = [tuple(v) for v in polygon]
        for row in range(height):
            band = _clip_axis(_clip_axis(vertices, 1, row, True), 1, row + 1, False)
            if len(band) < 3:
                continue
            for col in range(width):
                cell = _clip_axis(_clip_axis(band, 0, col, True), 0, col + 1, False)
                if len(cell) >= 3:
                    total[row, col] += _area(cell)
    return np.minimum(np.abs(total), 1.0)


@pytest.mark.parametrize("case", ["serif-g", "sans-amp", "default-e", "built-composite",
                                  "built-ring"])
def test_coverage_is_exact_area_of_the_flattened_polygons(case, built_font):
    source, character, size = {
        "serif-g": (DEJAVU_FILES[1], "g", 24), "sans-amp": (DEJAVU_FILES[0], "&", 20),
        "default-e": ("default", "e", 30), "built-composite": (built_font, "C", 22),
        "built-ring": (built_font, "B", 17)}[case]
    font = _port_font(source, size)
    points, ends, on_curve, _, box = font._glyph(font.face.glyph_index(character))
    coverage, (left, top) = raster.render_outline(points, ends, on_curve)
    polygons = [p / 4096.0 - np.array([left, top]) for p in
                raster.flatten_outline(points, ends, on_curve)]
    reference = _reference_coverage(polygons, *coverage.shape)
    assert coverage.shape == (((points[:, 1].max() + 63) >> 6) - (points[:, 1].min() >> 6),
                              ((points[:, 0].max() + 63) >> 6) - (points[:, 0].min() >> 6))
    assert coverage.max() == 255
    np.testing.assert_array_less(np.abs(coverage / 255.0 - reference), 1 / 255 + 1e-12)


def test_flattening_follows_the_conics_within_a_thirty_second_of_a_pixel():
    """Each flattened vertex lies on its conic; each chord strays at most
    1/32 px from it (checked at the chord midpoints of the ring glyph)."""
    p0, p1, p2 = (np.array(p, dtype=np.int64) * 4096 for p in ([0, 0], [20, 40], [40, 0]))
    vertices = np.array(raster._flatten_conic(p0, p1, p2)) / 4096.0
    t = np.linspace(0, 1, 2001)[:, None]
    curve = (1 - t) ** 2 * [0, 0] + 2 * t * (1 - t) * [20, 40] + t * t * [40, 0]
    mids = (vertices[1:] + vertices[:-1]) / 2
    distance = np.sqrt(((mids[:, None, :] - curve[None]) ** 2).sum(-1)).min(axis=1)
    assert distance.max() <= 1 / 32 + 1e-6


# ---------------------------------------------------------------------------
# Against PIL
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def metric_table():
    rows = {}
    for source in ["default"] + DEJAVU_FILES:
        for size in SIZES:
            pil, port = _pil_font(source, size), _port_font(source, size)
            for character in LETTERS_DIGITS:
                (w, h), (x, y) = pil.font.getsize(character)
                (pw, ph), (px, py) = port.getsize(character)
                rows[(source, size, character)] = ((w, h, x, y), (pw, ph, px, py))
    return rows


def test_getsize_within_a_pixel_and_mostly_equal(metric_table):
    theirs = np.array([t for t, _ in metric_table.values()])
    ours = np.array([o for _, o in metric_table.values()])
    assert np.abs(theirs - ours).max() <= 1
    assert (theirs == ours).mean() >= 0.90
    for source in ["default"] + DEJAVU_FILES:
        rows = [v for k, v in metric_table.items() if k[0] == source]
        equal = np.mean([np.array(t) == np.array(o) for t, o in rows])
        assert equal >= (0.80 if source == "default" else 0.90), (source, equal)
    # getbbox is getsize's box.
    font = _port_font(DEJAVU_FILES[0], 24)
    (w, h), (x, y) = font.getsize("g")
    assert font.getbbox("g") == (x, y, x + w, y + h)


def test_getmetrics_equal_pil():
    for source in ["default", DEJAVU_FILES[1]]:
        for size in range(6, 65):
            assert _port_font(source, size).getmetrics() == _pil_font(source, size).getmetrics()


@pytest.mark.parametrize("source", ["default"] + DEJAVU_FILES,
                         ids=["default", "sans", "serif", "mono"])
def test_ink_within_thirty_percent_of_pil(source):
    ratios = []
    for size in SIZES:
        pil, port = _pil_font(source, size), _port_font(source, size)
        for character in LETTERS_DIGITS:
            theirs = np.asarray(pil.getmask(character), dtype=np.float64).sum()
            ours = port.getmask2(character)[0].astype(np.float64).sum()
            ratios.append(ours / theirs)
    ratios = np.array(ratios)
    assert ratios.min() >= 0.7 and ratios.max() <= 1.3, (ratios.min(), ratios.max())


def test_mask_lands_where_pil_puts_its_ink():
    """Drawn at the same point, the port's ink and PIL's overlap: their
    centres of mass lie within a pixel."""
    font, pil = _port_font(DEJAVU_FILES[0], 40), _pil_font(DEJAVU_FILES[0], 40)
    for character, xy in [("g", (10, 5)), ("W", (3.6, 7.2)), ("@", (20.5, 0.99))]:
        ours = np.zeros((80, 80, 4), dtype=np.uint8)
        generation._draw_text(ours, xy, character, (0, 0, 0, 255), font)
        image = PIL.Image.new("RGBA", (80, 80), (255, 255, 255, 0))
        PIL.ImageDraw.Draw(image).text(xy, character, fill=(0, 0, 0, 255), font=pil)
        theirs = np.asarray(image)[..., 3].astype(np.float64)
        mine = ours[..., 3].astype(np.float64)
        rows, cols = np.mgrid[:80, :80]
        for weights in (theirs, mine):
            assert weights.sum() > 0
        centre = lambda w: np.array([(w * rows).sum(), (w * cols).sum()]) / w.sum()  # noqa: E731
        assert np.abs(centre(theirs) - centre(mine)).max() < 1.0


def test_draw_bitmap_equals_pil_text_bit_for_bit():
    """PIL's own mask through ``draw_bitmap`` gives ``ImageDraw.text``'s
    RGBA result: transparent, translucent and opaque canvases, positions
    partly outside, fractional positions."""
    rng = np.random.default_rng(0)
    pil = _pil_font(DEJAVU_FILES[1], 30)
    for trial in range(24):
        base = rng.integers(0, 256, (60, 80, 4)).astype(np.uint8)
        base[..., 3] = rng.choice([0, 0, 1, 128, 255], (60, 80)).astype(np.uint8)
        if trial % 3 == 0:
            base[...] = (255, 255, 255, 0)
        ink = tuple(int(v) for v in rng.integers(0, 256, 3)) + (255,)
        xy = (float(rng.uniform(-10, 60)), float(rng.uniform(-10, 40)))
        character = "agQ@W"[trial % 5]
        image = PIL.Image.fromarray(base.copy(), "RGBA")
        PIL.ImageDraw.Draw(image).text(xy, character, fill=ink, font=pil)
        start = (math.modf(xy[0])[0], math.modf(xy[1])[0])
        mask, offset = pil.getmask2(character, "L", start=start)
        mask = np.asarray(mask).reshape(mask.size[1], mask.size[0])
        ours = base.copy()
        raster.draw_bitmap(ours, mask, ink, (int(xy[0]) + offset[0], int(xy[1]) + offset[1]))
        np.testing.assert_array_equal(ours, np.asarray(image))


def test_missing_character_takes_notdef_as_pil_does():
    """The ligature probe's codepoints: PIL raises nothing for a character
    the cmap lacks, so the JAX package appends them to every group's
    coverage; the port measures glyph 0 and does the same."""
    font = fonts.load_default(20)
    assert font.face.glyph_index("Ж") == 0
    assert font.getsize("Ж") == font.getsize(chr(0x10FFFF))
    _ = PIL.ImageFont.load_default().font.getsize("Ж")
    for package in (jgen, generation):
        glyphs = package._resolve_glyphs("fix", {"fix": None}, 20, use_ligatures=True)
        assert [g.char for g in glyphs] == ["ﬁ", "x"]
        assert glyphs[0].pieces == "fi"


def test_mask_cache_renders_each_glyph_once():
    font = fonts.truetype(DEJAVU_FILES[0], 18)
    for character in "banana":
        font.getmask2(character)
    assert (font.misses, font.hits) == (3, 3)
    again = font.getmask2("a", start=(0.7, 0.2))
    assert font.hits == 4 and again[1] == (font.getmask2("a")[1][0] + 1,
                                           font.getmask2("a")[1][1])


def test_reference_render_hash():
    digest = hashlib.sha256(render_reference_string().tobytes()).hexdigest()
    assert digest == REFERENCE_RENDER_SHA256


# ---------------------------------------------------------------------------
# font_supports_alphabet and get_fonts against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alphabet", ["", LETTERS_DIGITS, "ABCD", "éü", "Ж",
                                      "A\U0001F600", "ﬁﬂ"])
def test_font_supports_alphabet_matches_jax(alphabet, built_font, default_font_path):
    for path in DEJAVU_FILES + [built_font, default_font_path]:
        assert (generation.font_supports_alphabet(path, alphabet)
                == jgen.font_supports_alphabet(path, alphabet)), (path, alphabet)


@pytest.mark.parametrize("exclude_smallcaps", [False, True])
def test_get_fonts_matches_jax(tmp_path, monkeypatch, built_font, default_font_path,
                               exclude_smallcaps):
    """Both packages' ``get_fonts`` on a cache their patched downloads fill
    with six fonts; the small-caps list names one of them."""
    sources = DEJAVU_FILES + [built_font, default_font_path]

    def fake_extract(url, destination, **kwargs):
        assert url.endswith("fonts.zip")
        for i, source in enumerate(sources):
            folder = os.path.join(destination, f"family{i % 2}")
            os.makedirs(folder, exist_ok=True)
            with open(source, "rb") as f, open(os.path.join(folder, f"font{i}.ttf"), "wb") as g:
                g.write(f.read())
        return destination

    def fake_verify(url, **kwargs):
        assert url.endswith("fonts_smallcaps.txt")
        path = tmp_path / "smallcaps.txt"
        path.write_text("family1/font1.ttf\nfamily0/font4.ttf", encoding="utf8")
        return str(path)

    def refuse(*args, **kwargs):
        raise AssertionError("network")

    monkeypatch.setattr("urllib.request.urlopen", refuse)
    for module in (tools, jtools):
        monkeypatch.setattr(module, "download_and_extract", fake_extract)
        monkeypatch.setattr(module, "download_and_verify", fake_verify)
    results = []
    for package, cache in ((generation, tmp_path / "port"), (jgen, tmp_path / "jax")):
        for alphabet in (LETTERS_DIGITS, "é", "ABCD"):
            found = package.get_fonts(cache_dir=str(cache), alphabet=alphabet,
                                      exclude_smallcaps=exclude_smallcaps)
            results.append(sorted(os.path.relpath(p, str(cache)) for p in found))
    assert results[:3] == results[3:]
    assert results[0]


def test_new_modules_import_without_pil_fonttools_matplotlib_or_jax(tmp_path):
    """The reader, the rasteriser, the generation module, the drawing
    functions and the image codecs (``tools.read`` of a TIFF, BMP, PNM and
    YCCK JPEG fixture, of a lossy, a lossless and an ``ALPH`` WebP
    fixture, of an arithmetic-coded, a lossless and a 4:1:1 JPEG fixture
    and of a TGA, a PCX and an ICO fixture, to the sha256 of PIL's decode)
    import and run with
    PIL, fontTools, matplotlib, h5py, jax, flax and the JAX package
    unimportable, as on the card's machine; ``drawAnnotations`` raises
    ``ImportError`` there."""
    code = (
        "import sys\n"
        "for name in ('PIL', 'matplotlib', 'fontTools', 'h5py', 'jax', 'jaxlib', 'flax',\n"
        "             'keras_ocr_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from keras_ocr_tpu_torch import data_generation, tools\n"
        "from keras_ocr_tpu_torch.data import fonts, raster\n"
        "image, lines = data_generation.draw_text_image('hello world', 16, 60, 160,"
        " {'helowrd ': None})\n"
        "assert image.shape == (60, 160, 4) and lines, lines\n"
        "boxed = tools.drawBoxes(np.zeros((60, 160, 3), np.uint8), [lines[0][0][0]])\n"
        "assert boxed.any()\n"
        "try:\n"
        "    tools.drawAnnotations(boxed, [('a', lines[0][0][0])])\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    raise AssertionError('drawAnnotations ran without matplotlib')\n"
        "import hashlib, json, os\n"
        "from keras_ocr_tpu_torch import codecs\n"
        "images = os.path.join('tests', 'fixtures', 'images')\n"
        "hashes = json.load(open(os.path.join(images, 'hashes.json')))\n"
        "for name in ('g4.tif', 'rle4.bmp', 'plain.pgm', 'ycck.jpg', 'rgb15_rle_right.tga',\n"
        "             'planes4.pcx', 'dib_depths.ico'):\n"
        "    out = tools.read(os.path.join(images, name))\n"
        "    assert hashlib.sha256(out.tobytes()).hexdigest() == hashes[name]['decoded_sha256']\n"
        "webp_dir = os.path.join('tests', 'fixtures', 'webp')\n"
        "webp_hashes = json.load(open(os.path.join(webp_dir, 'hashes.json')))\n"
        "for name in ('filter_100.webp', 'lossless_predictors.webp',\n"
        "             'alpha_lossless_gradient.webp'):\n"
        "    out = tools.read(os.path.join(webp_dir, name))\n"
        "    digest = hashlib.sha256(out.tobytes()).hexdigest()\n"
        "    assert digest == webp_hashes[name]['decoded_sha256'], name\n"
        "jpeg_dir = os.path.join('tests', 'fixtures', 'jpeg')\n"
        "jpeg_hashes = json.load(open(os.path.join(jpeg_dir, 'hashes.json')))\n"
        "for name in ('grey_arith_dac_restart.jpg', 'lossless_rgb_p4_restart.jpg',\n"
        "             'ycc411.jpg'):\n"
        "    out = tools.read(os.path.join(jpeg_dir, name))\n"
        "    digest = hashlib.sha256(out.tobytes()).hexdigest()\n"
        "    assert digest == jpeg_hashes[name]['decoded_sha256'], name\n"
        "assert 'keras_ocr_tpu_torch.jpeg_modes' in sys.modules\n"
        "assert not any(m.split('.')[0] in ('PIL', 'matplotlib', 'fontTools', 'h5py', 'jax',"
        " 'flax', 'keras_ocr_tpu') for m in sys.modules if sys.modules[m] is not None)\n"
        "print('fonts ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "fonts ok" in proc.stdout
