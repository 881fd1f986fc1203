"""Port parity: ``data/datasets.py`` vs the JAX package, offline.

Both label parsers on the strings of ``tests/test_datasets.py``; the COCO-Text,
BornDigital, ICDAR 2013 (detector and recognizer) and ICDAR 2019 loaders on
cache directories filled here, with ``urllib.request.urlopen`` made to raise
(any call fails the test) and the download helpers patched in both packages
as ``tests/test_datasets.py`` patches them: equal records. Both image
generators from one ``random`` / ``np.random`` seed, over the committed
fixtures (a baseline and a progressive JPEG, an interlaced PNG), with and
without an augmenter and with the focused crop: the first 4 samples give
equal arrays, boxes (within 1e-9) and text.
"""

import json
import os
import random
import shutil
import subprocess
import sys
import urllib.request
import warnings
import zipfile

import numpy as np
import pytest
import torch

from keras_ocr_tpu import tools as jtools
from keras_ocr_tpu.data import augmentation as jaug
from keras_ocr_tpu.data import datasets as jdatasets
from keras_ocr_tpu_torch import datasets as alias
from keras_ocr_tpu_torch import tools
from keras_ocr_tpu_torch.data import augmentation as taug
from keras_ocr_tpu_torch.data import datasets

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
IMAGES = {name: os.path.join(FIXTURES, name)
          for name in ("test_image.jpg", "progressive.jpg", "interlaced.png")}
BOX_BAR = 1e-9


@pytest.fixture
def offline(monkeypatch):
    """``urlopen`` refused; returns the list of URLs that were asked for."""
    urls = []

    def refuse(url, *args, **kwargs):
        urls.append(url)
        raise OSError("no network in the tests")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    yield urls
    assert not urls, urls


def test_born_digital_labels_parsing(tmp_path):
    gt = tmp_path / "gt.txt"
    gt.write_bytes("﻿".encode("utf8")
                   + b'word_1.png, "Alpha"\nword_2.png, "with, comma"\nword_3.png, ""\n')
    labels = datasets._read_born_digital_labels_file(str(gt), "/imgs")
    assert labels == jdatasets._read_born_digital_labels_file(str(gt), "/imgs")
    assert labels[1] == ("/imgs/word_2.png", None, "with, comma")


@pytest.mark.parametrize("skip_illegible", [False, True])
def test_icdar_2013_gt_parsing(skip_illegible):
    text = ('1 2 3 10 10 0 0 5 9 "h"\n1 2 3 10 10 6 0 11 9 "i"\n\n'
            '1 2 3 10 10 0 20 5 29 ""\n1 2 3 10 10 6 20 11 29 "x"\n\n'
            '1 2 3 10 10 0 40 5 49 ""\n\n')
    ours = datasets._parse_icdar_2013_gt(text, skip_illegible=skip_illegible)
    theirs = jdatasets._parse_icdar_2013_gt(text, skip_illegible=skip_illegible)
    _assert_lines_equal(ours, theirs)
    assert [c for _, c in ours[1]] == (["x"] if skip_illegible else ["", "x"])


def _assert_lines_equal(ours, theirs):
    assert [[c for _, c in line] for line in ours] == [[c for _, c in line] for line in theirs]
    for line, want in zip(ours, theirs):
        for (box, _), (want_box, _) in zip(line, want):
            np.testing.assert_allclose(box, want_box, rtol=0, atol=BOX_BAR)


def _assert_records_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a[0] == b[0] and a[2] == b[2]
        if isinstance(a[1], list):
            _assert_lines_equal(a[1], b[1])
        elif a[1] is None:
            assert b[1] is None
        else:
            np.testing.assert_array_equal(a[1], b[1])


def _patch_downloads(monkeypatch, verify=None, extract=None):
    """The same stand-ins for the download helpers in both packages."""
    for module in (tools, jtools):
        if verify is not None:
            monkeypatch.setattr(module, "download_and_verify", verify)
        if extract is not None:
            monkeypatch.setattr(module, "download_and_extract", extract)


def _link(source, target):
    try:
        os.link(source, target)
    except OSError:
        shutil.copyfile(source, target)


def _icdar_gt(rng, width, height):
    """ICDAR 2013 character rows: 1-3 lines of 2-6 boxes inside the image,
    an illegible glyph among them."""
    rows = []
    for _ in range(rng.randint(1, 4)):
        x, y = rng.randint(0, width // 2), rng.randint(0, height - 20)
        for i in range(rng.randint(2, 7)):
            x1, x2 = x + 9 * i, x + 9 * i + 7
            char = "" if rng.rand() < 0.1 else "abcdefgh"[rng.randint(8)]
            rows.append(f'0 0 0 {x1 + 3} {y + 6} {x1} {y} {x2} {y + 12} "{char}"')
        rows.append("")
    return "\n".join(rows) + "\n"


def _icdar_2013_cache(root, count=229):
    rng = np.random.RandomState(0)
    images = os.path.join(root, "icdar2013", "Challenge2_Training_Task12_Images")
    gts = os.path.join(root, "icdar2013", "Challenge2_Training_Task2_GT")
    os.makedirs(images)
    os.makedirs(gts)
    for i in range(count):
        source = IMAGES["test_image.jpg" if i % 2 else "progressive.jpg"]
        _link(source, os.path.join(images, f"{100 + i}.jpg"))
        width, height = (640, 480) if i % 2 else (320, 240)
        with open(os.path.join(gts, f"{100 + i}_GT.txt"), "w", encoding="utf8") as f:
            f.write(_icdar_gt(rng, width, height))


def _born_digital_cache(root):
    train = os.path.join(root, "borndigital", "train")
    os.makedirs(train)
    words = ["Eventdock", "word, with comma", "béta", "12"]
    with open(os.path.join(train, "gt.txt"), "w", encoding="utf-8-sig") as f:
        for i in range(3567):
            _link(IMAGES["interlaced.png"], os.path.join(train, f"word_{i + 1}.png"))
            f.write(f'word_{i + 1}.png, "{words[i % len(words)]}"\n')


def test_icdar_2013_loaders_match_jax(tmp_path, offline):
    _icdar_2013_cache(str(tmp_path))
    for skip in (False, True):
        ours = datasets.get_icdar_2013_detector_dataset(cache_dir=str(tmp_path),
                                                        skip_illegible=skip)
        theirs = jdatasets.get_icdar_2013_detector_dataset(cache_dir=str(tmp_path),
                                                           skip_illegible=skip)
        assert len(ours) == 229
        _assert_records_equal(ours, theirs)
    ours = alias.get_icdar_2013_recognizer_dataset(cache_dir=str(tmp_path))
    _assert_records_equal(ours, jdatasets.get_icdar_2013_recognizer_dataset(
        cache_dir=str(tmp_path)))
    assert ours and all(box.shape == (4, 2) for _, box, _ in ours)


def test_born_digital_loader_matches_jax(tmp_path, offline, monkeypatch):
    _born_digital_cache(str(tmp_path))
    ours = datasets.get_born_digital_recognizer_dataset(cache_dir=str(tmp_path))
    assert len(ours) == 3567 and ours[1][2] == "word, with comma"
    _assert_records_equal(ours, jdatasets.get_born_digital_recognizer_dataset(
        cache_dir=str(tmp_path)))
    # The test split: images by the archive, labels by a verified download.
    test_dir = os.path.join(str(tmp_path), "borndigital", "test")
    gt_path = os.path.join(str(tmp_path), "test_gt.txt")
    with open(gt_path, "w", encoding="utf-8-sig") as f:
        f.write('word_1.png, "One"\nword_2.png, "Two"\n')

    def extract(url, destination, **kwargs):
        os.makedirs(destination, exist_ok=True)
        for i in range(1439):
            _link(IMAGES["interlaced.png"], os.path.join(destination, f"word_{i + 1}.png"))

    def verify(url, sha256=None, cache_dir=None, verbose=True, filename=None, **kwargs):
        return gt_path

    _patch_downloads(monkeypatch, verify=verify, extract=extract)
    ours = datasets.get_born_digital_recognizer_dataset(split="traintest",
                                                        cache_dir=str(tmp_path))
    assert len(os.listdir(test_dir)) == 1439 and len(ours) == 3567 + 2
    _assert_records_equal(ours, jdatasets.get_born_digital_recognizer_dataset(
        split="traintest", cache_dir=str(tmp_path)))


def test_cocotext_loader_matches_jax(tmp_path, offline, monkeypatch):
    imgs = {str(100 + i): {"file_name": f"COCO_train2014_{i:012d}.jpg",
                           "set": "val" if i < 3 else "train"} for i in range(4)}
    anns, img_to_anns = {}, {}
    for i, cocoid in enumerate(imgs):
        anns[str(500 + i)] = {"mask": [0, 0, 10, 0, 10, 5, 0, 5], "utf8_string": f"word{i}",
                              "legibility": "legible" if i % 2 == 0 else "illegible",
                              "language": "english" if i != 2 else "german"}
        img_to_anns[cocoid] = [500 + i]
    zip_path = tmp_path / "cocotext.v2.zip"
    with zipfile.ZipFile(zip_path, "w") as z:
        z.writestr("cocotext.v2.json",
                   json.dumps({"imgs": imgs, "anns": anns, "imgToAnns": img_to_anns}))

    def verify(url, sha256=None, cache_dir=None, verbose=True, **kwargs):
        if url.endswith(".zip"):
            return str(zip_path)
        if url.endswith("000001.jpg"):
            raise OSError("simulated 404")
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, url.rsplit("/", 1)[-1])
        if not os.path.exists(path):
            _link(IMAGES["progressive.jpg"], path)
        return path

    _patch_downloads(monkeypatch, verify=verify)
    for kwargs in (dict(split="val"), dict(split="trainval", legible_only=True),
                   dict(split="trainval", english_only=True), dict(split="train", limit=1),
                   dict(split="val", return_raw_labels=True)):
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            ours = datasets.get_cocotext_recognizer_dataset(cache_dir=str(tmp_path), **kwargs)
            theirs = jdatasets.get_cocotext_recognizer_dataset(cache_dir=str(tmp_path),
                                                               **kwargs)
        skipped = [str(w.message) for w in warned]
        assert len(skipped) == (2 if "val" in kwargs["split"] else 0)
        assert skipped[: len(skipped) // 2] == skipped[len(skipped) // 2 :]
        if kwargs.get("return_raw_labels"):
            assert ours[1] == theirs[1]
            ours, theirs = ours[0], theirs[0]
        _assert_records_equal(ours, theirs)


def test_icdar_2019_loader(tmp_path, offline, monkeypatch):
    """Equal to JAX's on a converted cache; a GIF in the cache becomes a
    ``.jpg`` of the same stem and goes, and a corrupt one raises and stays
    (``tests/test_torch_gif.py`` holds the conversion to JAX's)."""
    main = tmp_path / "icdar2019"
    (main / "ImagesPart1").mkdir(parents=True)
    entries = [{"filepath": f"ImagesPart1/tr_img_{i:05d}.jpg", "percent_complete": p,
                "lines": [{"line": [[[0, -2], [5, 0], [5, 9], [-1, 9]]]}, {"line": []}]}
               for i, p in enumerate((1.0, 0.4, 0.75))]
    (main / "mlt2019_dataset.json").write_text(json.dumps({"dataset": entries}))
    _patch_downloads(monkeypatch, extract=lambda *args, **kwargs: None)
    with pytest.warns(UserWarning):
        ours = datasets.get_icdar_2019_semisupervised_dataset(cache_dir=str(tmp_path))
    with pytest.warns(UserWarning):
        theirs = jdatasets.get_icdar_2019_semisupervised_dataset(cache_dir=str(tmp_path))
    assert len(ours) == 2
    _assert_records_equal(ours, theirs)
    shutil.copyfile(os.path.join(FIXTURES, "gif", "code_size_2.gif"),
                    main / "ImagesPart1" / "tr_img_00008.gif")
    with pytest.warns(UserWarning):
        again = datasets.get_icdar_2019_semisupervised_dataset(cache_dir=str(tmp_path))
    _assert_records_equal(again, theirs)
    assert not (main / "ImagesPart1" / "tr_img_00008.gif").exists()
    assert tools.read(str(main / "ImagesPart1" / "tr_img_00008.jpg")).shape == (64, 64, 3)
    (main / "ImagesPart1" / "tr_img_00009.gif").write_bytes(b"GIF89a")
    with pytest.warns(UserWarning), pytest.raises(ValueError, match="GIF"):
        datasets.get_icdar_2019_semisupervised_dataset(cache_dir=str(tmp_path))
    assert (main / "ImagesPart1" / "tr_img_00009.gif").exists()


def _detector_labels():
    rng = np.random.RandomState(4)
    labels = []
    for i, name in enumerate(("test_image.jpg", "progressive.jpg", "interlaced.png")):
        height, width = tools.read(IMAGES[name]).shape[:2]
        text = _icdar_gt(rng, width, height) if width > 100 else '0 0 0 9 9 3 2 60 30 "E"\n\n'
        labels.append((IMAGES[name], datasets._parse_icdar_2013_gt(text), 1 - 0.1 * i))
    return labels


def _take(generator, count=4):
    return [next(generator) for _ in range(count)]


def _both(make, count=4, seed=0):
    """``count`` samples of the port's generator and of JAX's, each after
    seeding ``random`` and ``np.random`` with ``seed``."""
    out = []
    for package in ("port", "jax"):
        random.seed(seed)
        np.random.seed(seed)
        out.append(_take(make(package), count))
    return out


DETECTOR_CASES = {
    "plain": dict(),
    "augmented": dict(augmenter=lambda a: a.Sequential([
        a.Affine(rotate=(-10, 10), scale=(0.9, 1.1)), a.GaussianBlur((0, 0.5)),
        a.Multiply((0.9, 1.1))])),
    "focused": dict(focused=True, min_area=20,
                    augmenter=lambda a: a.Affine(rotate=(-5, 5), scale=(0.9, 1.1))),
}


@pytest.mark.parametrize("case", list(DETECTOR_CASES))
def test_detector_image_generator_matches_jax(case):
    labels = _detector_labels()
    options = dict(DETECTOR_CASES[case])

    def make(package):
        module, aug = (datasets, taug) if package == "port" else (jdatasets, jaug)
        kwargs = dict(options)
        if "augmenter" in kwargs:
            kwargs["augmenter"] = kwargs["augmenter"](aug)
            kwargs["augmenter"]._rng = np.random.RandomState(21)
        return module.get_detector_image_generator(labels, width=256, height=192, **kwargs)

    ours, theirs = _both(make)
    for (image, lines, confidence), (want_image, want_lines, want_confidence) in zip(ours,
                                                                                      theirs):
        assert image.shape == (192, 256, 3)
        np.testing.assert_array_equal(image, want_image)
        _assert_lines_equal(lines, want_lines)
        assert confidence == want_confidence


@pytest.mark.parametrize("augmented", [False, True], ids=["plain", "augmented"])
def test_recognizer_image_generator_matches_jax(augmented, capsys):
    labels = [(IMAGES["interlaced.png"], None, "Eventdock"),
              (IMAGES["test_image.jpg"],
               np.array([[165, 222], [590, 222], [590, 292], [165, 292]]), "Eventdock!"),
              (IMAGES["progressive.jpg"], None, "@@"),
              (IMAGES["progressive.jpg"], [[80, 110], [300, 110], [300, 150], [80, 150]], "dock")]
    alphabet = "abcdefghijklmnopqrstuvwxyzEv"

    def make(package):
        module, aug = (datasets, taug) if package == "port" else (jdatasets, jaug)
        augmenter = None
        if augmented:
            augmenter = aug.Sequential([aug.GaussianBlur((0, 1.0)), aug.Multiply((0.8, 1.2)),
                                        aug.Invert(p=0.5)], seed=5)
        return module.get_recognizer_image_generator(labels, height=31, width=200,
                                                     alphabet=alphabet, augmenter=augmenter)

    ours, theirs = _both(make, count=5)
    assert "2 / 4 instances have illegal characters" in capsys.readouterr().out
    for (image, text), (want_image, want_text) in zip(ours, theirs):
        assert image.shape == (31, 200, 3)
        np.testing.assert_array_equal(image, want_image)
        assert text == want_text


def test_data_path_runs_with_pil_matplotlib_and_jax_blocked(tmp_path):
    """The loaders, augmenters, both generators, the committed progressive
    JPEG and interlaced PNG and the font-free generation helpers import and
    run with PIL, matplotlib, fontTools, h5py, jax, flax and the JAX package
    unimportable, as on the card's machine."""
    code = (
        "import sys\n"
        "for name in ('PIL', 'matplotlib', 'fontTools', 'h5py', 'jax', 'jaxlib', 'flax',\n"
        "             'keras_ocr_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from keras_ocr_tpu_torch import data_generation, datasets, tools\n"
        "from keras_ocr_tpu_torch.data import augmentation\n"
        "fixtures = sys.argv[1]\n"
        "labels = [(fixtures + '/progressive.jpg', [[(np.array([[10, 10], [40, 10], [40, 30],"
        " [10, 30]]), 'a')]], 1)]\n"
        "aug = augmentation.Sequential([augmentation.Affine(rotate=(-10, 10)),"
        " augmentation.GaussianBlur((0, 0.5)), augmentation.Multiply((0.9, 1.1))])\n"
        "image, lines, _ = next(datasets.get_detector_image_generator(labels, 64, 48, aug))\n"
        "assert image.shape == (48, 64, 3), image.shape\n"
        "crop, text = next(datasets.get_recognizer_image_generator("
        "[(fixtures + '/interlaced.png', None, 'ab')], 31, 200, 'ab', aug))\n"
        "assert crop.shape == (31, 200, 3) and text == 'ab'\n"
        "assert next(data_generation.get_text_generator())\n"
        "assert data_generation.get_maximum_uniform_contour(image, 2)[0] is not None\n"
        "assert not any(m.split('.')[0] in ('PIL', 'matplotlib', 'fontTools', 'h5py', 'jax',"
        " 'flax', 'keras_ocr_tpu') for m in sys.modules if sys.modules[m] is not None)\n"
        "print('data path ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, FIXTURES],
                          cwd=os.path.dirname(os.path.dirname(FIXTURES)), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "data path ok" in proc.stdout
