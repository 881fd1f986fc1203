"""Port parity: ``tools.read`` of the JPEG kinds PIL's libjpeg-turbo reads
beyond Huffman-coded DCT frames (``keras_ocr_tpu_torch/jpeg_modes.py``)
and of every sampling layout it accepts.

JAX's ``tools.read`` is PIL's ``Image.open(f).convert("RGB")``; the
port's decode must equal it bit for bit:

* every fixture of ``tests/fixtures/jpeg`` (written by
  ``scripts/make_jpeg_fixtures.py``, whose encoders share no code with the
  decoder), by path and by buffer, at the sha256 of PIL's decode in
  ``hashes.json``;
* files written here by that script for each row of the layout table:
  arithmetic-coded sequential (SOF9) and progressive (SOF10) frames of 1,
  3 and 4 components at every sampling kind, with and without ``DAC``
  conditioning and restart intervals; lossless (SOF3) frames with
  predictors 1-7, point transforms 0 and 3, restart intervals, sampled
  and CMYK components; Huffman-coded frames at sampling factors 3 and 4;
  and the layouts both refuse (SOF11, fractional ratios, more than 10
  blocks or lossless samples in an MCU, a lossless frame to colour-convert,
  hierarchical frames, 12-bit frames and lossless precisions below 8),
  where the port names the kind in
  ``NotImplementedError``.

Truncated and corrupt streams raise ``ValueError``; the QM coder pair
round-trips random decisions.
"""

import hashlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from keras_ocr_tpu import tools as jtools
from keras_ocr_tpu_torch import jpeg_modes, tools

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import make_jpeg_fixtures as mj  # noqa: E402

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
JPEGS = os.path.join(HERE, "fixtures", "jpeg")
with open(os.path.join(JPEGS, "hashes.json"), encoding="utf8") as _f:
    HASHES = json.load(_f)

RGB = mj.scene(21, 38, seed=5)
PLANES = [RGB[..., k] for k in range(3)]
GREY = PLANES[1]
CMYK = np.asarray(Image.fromarray(RGB).convert("CMYK"))
DAC = {(0, 0): (1, 6), (1, 0): 2, (0, 1): (0, 0), (1, 1): 30}

# (components, sampling) by name; the three-component kinds are YCbCr
# under a JFIF marker, the four-component ones CMYK (Adobe 0) or YCCK
# (Adobe 2).
SAMPLINGS = {
    "grey_1x1": [(1, 1)], "grey_2x2": [(2, 2)], "grey_4x3": [(4, 3)],
    "444": [(1, 1)] * 3, "422": [(2, 1), (1, 1), (1, 1)], "420": [(2, 2), (1, 1), (1, 1)],
    "440": [(1, 2), (1, 1), (1, 1)], "411": [(4, 1), (1, 1), (1, 1)],
    "4x2": [(4, 2), (1, 1), (1, 1)], "3x1": [(3, 1), (1, 1), (1, 1)],
    "1x4": [(1, 4), (1, 1), (1, 1)], "41_21": [(4, 1), (2, 1), (2, 1)],
    "chroma_2x2": [(1, 1), (2, 2), (1, 1)],
    "cmyk": [(1, 1)] * 4, "ycck_2211": [(2, 2), (1, 1), (1, 1), (2, 2)],
}
EXTRAS = {"plain": {}, "dac": {"dac": DAC}, "restart": {"restart": 2},
          "dac_restart": {"dac": DAC, "restart": 3}}


def _frame(sampling):
    if len(sampling) == 1:
        return mj.make_frame([GREY], sampling)
    if len(sampling) == 3:
        return mj.make_frame(mj.ycc(RGB), sampling)
    if sampling == SAMPLINGS["cmyk"]:
        return mj.make_frame([CMYK[..., k] for k in range(4)], sampling, markers=mj.adobe(0))
    return mj.make_frame(mj.ycc(RGB) + [GREY], sampling, markers=mj.adobe(2))


def _arithmetic_cases():
    cases = {}
    for kind in SAMPLINGS:
        for extra, kwargs in EXTRAS.items():
            for progressive in (False, True):
                cases[f"sof{10 if progressive else 9}_{kind}_{extra}"] = (
                    lambda k=kind, kw=kwargs, p=progressive: mj.arith_jpeg(
                        _frame(SAMPLINGS[k]), progressive=p, **kw))
        cases[f"huffman_{kind}"] = lambda k=kind: mj.huffman_jpeg(_frame(SAMPLINGS[k]),
                                                                  restart=4)
    # A progression of several refinement bits, each band alone.
    cases["sof10_deep_refinement"] = lambda: mj.arith_jpeg(
        _frame(SAMPLINGS["420"]), progressive=True, restart=5,
        scans=((0, 0, 0, 2), (0, 0, 2, 1), (1, 2, 0, 3), (3, 63, 0, 3), (1, 63, 3, 2),
               (1, 63, 2, 1), (0, 0, 1, 0), (1, 63, 1, 0)))
    return cases


def _lossless_cases():
    cases = {}
    for predictor in range(1, 8):
        for pt in (0, 3):
            for restart in (0, 2):
                tag = f"p{predictor}_pt{pt}_r{restart}"
                cases[f"sof3_grey_{tag}"] = (
                    lambda p=predictor, t=pt, r=restart: mj.lossless_jpeg(
                        [GREY], predictor=p, pt=t, restart_rows=r, markers=mj.JFIF))
                cases[f"sof3_rgb_{tag}"] = (
                    lambda p=predictor, t=pt, r=restart: mj.lossless_jpeg(
                        PLANES, predictor=p, pt=t, restart_rows=r))
    for kind in ("420", "411", "3x1", "1x4", "chroma_2x2"):
        cases[f"sof3_{kind}"] = lambda k=kind: mj.lossless_jpeg(
            PLANES, sampling=SAMPLINGS[k], predictor=6, restart_rows=1)
    cases["sof3_cmyk"] = lambda: mj.lossless_jpeg([CMYK[..., k] for k in range(4)],
                                                  predictor=5)
    cases["sof3_cmyk_adobe0"] = lambda: mj.lossless_jpeg([CMYK[..., k] for k in range(4)],
                                                         predictor=2, markers=mj.adobe(0))
    cases["sof3_rgb_adobe0"] = lambda: mj.lossless_jpeg(PLANES, predictor=1,
                                                        markers=mj.adobe(0))
    cases["sof3_rgb_ids_rgb"] = lambda: mj.lossless_jpeg(PLANES, predictor=3,
                                                         ids=[82, 71, 66])
    # A lone component of 2 rows an iMCU row, restarts every 3 rows.
    cases["sof3_grey_2x2"] = lambda: mj.lossless_jpeg([GREY], sampling=[(2, 2)],
                                                      predictor=4, restart_rows=3)
    cases["sof3_grey_1x3_restart_rows"] = lambda: mj.lossless_jpeg(
        [GREY], sampling=[(1, 3)], predictor=7, restart_rows=1)
    return cases


def _sof11_flat():
    """A well-formed arithmetic-coded lossless file: a 16x16 image of
    128s, predictor 1, whose every difference is a 0 decision in one
    statistics bin (whatever the context layout)."""
    encoder, bins = mj.QMEncoder(), [0]
    for _ in range(256):
        encoder.encode(bins, 0, 0)
    frame = mj.segment(0xCB, bytes([8, 0, 16, 0, 16, 1, 1, 0x11, 0]))
    scan = mj.segment(0xDA, bytes([1, 1, 0x00, 1, 0, 0]))
    return b"\xff\xd8" + frame + scan + encoder.flush() + b"\xff\xd9"


def _with_marker(blob, old, new):
    at = blob.index(bytes([0xFF, old]))
    return blob[:at + 1] + bytes([new]) + blob[at + 2:]


def _refused():
    """Both PIL and the port refuse these: name -> (bytes, the kind the
    port's ``NotImplementedError`` names)."""
    baseline = mj.huffman_jpeg(_frame(SAMPLINGS["420"]))
    lossless = mj.lossless_jpeg(PLANES, predictor=1)
    sof = baseline.index(b"\xff\xc0")
    cases = {
        "sof11": (_sof11_flat(), "arithmetic-coded lossless"),
        "fractional_3_2": (mj.huffman_jpeg(_frame([(3, 1), (2, 1), (1, 1)])), "fractional"),
        "fractional_4_3_arith": (mj.arith_jpeg(_frame([(4, 1), (3, 1), (1, 1)])),
                                 "fractional"),
        "mcu_18_blocks": (mj.huffman_jpeg(_frame([(4, 4), (1, 1), (1, 1)])),
                          "more than 10 blocks"),
        "mcu_11_blocks_arith": (mj.arith_jpeg(_frame([(3, 3), (1, 1), (1, 1)])),
                                "more than 10 blocks"),
        "sampling_5": (mj.huffman_jpeg(_frame([(5, 1), (1, 1), (1, 1)])),
                       "sampling factors"),
        "lossless_jfif": (mj.lossless_jpeg(PLANES, markers=mj.JFIF), "JFIF"),
        "lossless_adobe1": (mj.lossless_jpeg(PLANES, markers=mj.adobe(1)),
                            "Adobe transform 1"),
        "lossless_ycck": (mj.lossless_jpeg([CMYK[..., k] for k in range(4)],
                                           markers=mj.adobe(2)), "Adobe transform 2"),
        "lossless_restart_mid_row": (
            lossless.replace(b"\xff\xda", mj.segment(0xDD, b"\x00\x05") + b"\xff\xda", 1),
            "restart interval"),
        "lossless_mcu_14_samples": (
            mj.lossless_jpeg(PLANES, sampling=[(4, 3), (1, 1), (1, 1)]), "more than 10 blocks"),
        "lossless_12_bit": (mj.lossless_jpeg([GREY], precision=12), "12-bit"),
        "lossless_6_bit": (mj.lossless_jpeg([GREY >> 2], precision=6), "6-bit"),
        "lossless_2_components": (mj.lossless_jpeg(PLANES[:2]), "2-component"),
        "sof1_12_bit": (baseline[:sof + 4] + b"\x0c" + baseline[sof + 5:], "12-bit"),
        "dnl_height": (baseline[:sof + 5] + b"\x00\x00" + baseline[sof + 7:], "DNL"),
    }
    for marker in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
        cases[f"sof{marker - 0xC0}"] = (_with_marker(baseline, 0xC0, marker), "hierarchical")
    return cases


CASES = {**_arithmetic_cases(), **_lossless_cases()}
REFUSED = _refused()


def _jax_read(blob):
    return jtools.read(io.BytesIO(blob))


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_matches_pil(case):
    blob = CASES[case]()
    ref = _jax_read(blob)
    ours = tools.read(io.BytesIO(blob))
    assert ours.dtype == np.uint8 and ours.shape == ref.shape == RGB.shape
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_name_the_kind(case):
    blob, kind = REFUSED[case]
    with pytest.raises(Exception):
        _jax_read(blob)
    with pytest.raises(NotImplementedError, match=kind):
        tools.read(io.BytesIO(blob))


@pytest.mark.parametrize("variant", ["path", "buffer"])
@pytest.mark.parametrize("name", sorted(HASHES))
def test_fixture_matches_pil(name, variant):
    path = os.path.join(JPEGS, name)
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
    files = mj.fixture_files()
    assert sorted(files) == sorted(HASHES)
    for name, blob in files.items():
        with open(os.path.join(JPEGS, name), "rb") as f:
            assert f.read() == blob, name
    assert sum(len(blob) for blob in files.values()) <= 300_000
    assert sum(name.startswith("scene_") for name in files) == 13


def _scan_replaced(blob, index, fill):
    """``blob`` with the data of its ``index``-th scan replaced by ``fill``."""
    starts = [i for i in range(len(blob) - 1) if blob[i : i + 2] == b"\xff\xda"]
    at = starts[index]
    header_end = at + 2 + int.from_bytes(blob[at + 2 : at + 4], "big")
    end = starts[index + 1] if index + 1 < len(starts) else blob.rindex(b"\xff\xd9")
    return blob[:header_end] + fill + blob[end:]


def _scan_header_patched(blob, offset, value):
    """``blob`` with one byte of its first scan header, counted from the
    header's end, set to ``value``."""
    at = blob.index(b"\xff\xda")
    end = at + 2 + int.from_bytes(blob[at + 2 : at + 4], "big")
    return blob[: end + offset] + bytes([value]) + blob[end + offset + 1 :]


def _broken():
    sequential = mj.arith_jpeg(_frame(SAMPLINGS["420"]))
    progressive = mj.arith_jpeg(_frame(SAMPLINGS["420"]), progressive=True)
    lossless = mj.lossless_jpeg(PLANES, predictor=4, restart_rows=2)
    dac = mj.arith_jpeg(_frame(SAMPLINGS["420"]), dac={(0, 0): (1, 1)})
    at = dac.index(b"\xff\xcc")
    return {
        "sof9_cut_half": (sequential[: len(sequential) // 2], "truncated"),
        "sof9_cut_tail": (sequential[:-2], "truncated"),
        "sof10_cut_half": (progressive[: len(progressive) // 2], "truncated"),
        "sof3_cut_half": (lossless[: len(lossless) // 2], "truncated"),
        "sof3_cut_tail": (lossless[:-2], "truncated"),
        "sof9_magnitude_overflow": (_scan_replaced(sequential, 0, b"\xff\x00" * 40),
                                    "magnitude overflow"),
        "sof10_spectral_overflow": (_scan_replaced(progressive, 1, b"\xff\x00" * 40),
                                    "spectral overflow"),
        "sof3_bad_code": (_scan_replaced(mj.lossless_jpeg(PLANES, predictor=4), 0,
                                         b"\xff\x00" * 40), "Huffman code"),
        "dac_l_above_u": (dac[: at + 5] + b"\x12" + dac[at + 6 :], "L > U"),
        "dac_index": (dac[: at + 4] + b"\x20" + dac[at + 5 :], "DAC table index"),
        "sof3_predictor_0": (_scan_header_patched(lossless, -3, 0), "lossless scan"),
        "sof3_point_transform_8": (_scan_header_patched(lossless, -1, 8), "lossless scan"),
    }


@pytest.mark.parametrize("case", sorted(_broken()))
def test_truncated_and_corrupt_streams_raise_value_error(case):
    blob, what = _broken()[case]
    with pytest.raises(ValueError, match=what):
        tools.read(io.BytesIO(blob))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_qm_coder_round_trip(seed):
    """The script's QM encoder and the port's decoder agree on skewed
    random decisions over several bins (every ``Qe`` state is reached),
    and the fixed bin of index 113 never adapts."""
    rng = np.random.RandomState(seed)
    bins, skew = rng.randint(0, 6, 4000), rng.rand(6) ** 3
    bits = (rng.rand(4000) < skew[bins]).astype(int)
    encoder, stats = mj.QMEncoder(), [0] * 6
    for b, bit in zip(bins, bits):
        encoder.encode(stats, b, bit)
    data = encoder.flush().replace(b"\xff\x00", b"\xff")  # unstuffed, as a scan's
    decode, states = jpeg_modes._qm_decoder(data), [0] * 6
    assert [decode(states, b) for b in bins] == bits.tolist()
    assert states == stats
    fixed = [jpeg_modes._FIXED]
    decode = jpeg_modes._qm_decoder(bytes(rng.randint(0, 255, 64).tolist()))
    for _ in range(100):
        decode(fixed, 0)
    assert fixed == [jpeg_modes._FIXED]
