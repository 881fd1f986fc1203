"""Public dataset loaders and training image generators.

The port's copy of ``keras_ocr_tpu/data/datasets.py``: COCO-Text v2,
BornDigital, ICDAR 2013 (detector and recognizer), the experimental ICDAR
2019 semi-supervised set, and the detector and recognizer image
generators, with :mod:`keras_ocr_tpu_torch.data.augmentation` for imgaug
and :func:`keras_ocr_tpu_torch.tools.read` for image IO. Host code: the
loaders fetch through ``tools.download_and_verify`` /
``download_and_extract`` (a filled cache needs no network) and the
generators draw from the module-level ``random`` and ``np.random`` in the
JAX package's order, so that one seed gives the same samples in both
packages. The ICDAR 2019 loader converts the set's GIF images to JPEG
files as JAX's does through PIL (:func:`..tools.decode_gif`, then the
bytes PIL's ``save`` writes).
"""

from __future__ import annotations

import concurrent.futures
import glob
import itertools
import json
import os
import random
import typing
import warnings
import zipfile

import numpy as np

from .. import tools
from . import augmentation


def _read_born_digital_labels_file(labels_filepath, image_folder):
    """(filepath, None, label) tuples from a BornDigital gt file. (:20-37.)"""
    with open(labels_filepath, encoding="utf-8-sig") as f:
        labels_raw = [line.strip().split(",") for line in f.readlines()]
        labels = [
            (
                os.path.join(image_folder, segments[0]),
                None,
                ",".join(segments[1:]).strip()[1:-1],
            )
            for segments in labels_raw
        ]
    return labels


def get_cocotext_recognizer_dataset(
    split="train",
    cache_dir=None,
    limit=None,
    legible_only=False,
    english_only=False,
    return_raw_labels=False,
):
    """(filepath, mask(-1,2), word) tuples from COCO-Text v2. (:40-125.)"""
    assert split in ["train", "val", "trainval"], f"Unsupported split: {split}"
    if cache_dir is None:
        cache_dir = tools.get_default_cache_dir()
    main_dir = os.path.join(cache_dir, "coco-text")
    images_dir = os.path.join(main_dir, "images")
    labels_zip = tools.download_and_verify(
        url="https://github.com/bgshih/cocotext/releases/download/dl/cocotext.v2.zip",
        cache_dir=main_dir,
        sha256="1444893ce7dbcd8419b2ec9be6beb0dba9cf8a43bf36cab4293d5ba6cecb7fb1",
    )
    with zipfile.ZipFile(labels_zip) as z:
        with z.open("cocotext.v2.json") as f:
            labels = json.loads(f.read())
    selected_ids = [
        cocoid for cocoid, data in labels["imgs"].items() if data["set"] in split
    ]
    if limit:
        selected_ids = selected_ids[:limit]
        selected_set = set(selected_ids)
        labels["imgToAnns"] = {
            k: v for k, v in labels["imgToAnns"].items() if k in selected_set
        }
        labels["imgs"] = {
            k: v for k, v in labels["imgs"].items() if k in selected_set
        }
        kept_anns = set(
            itertools.chain.from_iterable(labels["imgToAnns"].values())
        )
        labels["anns"] = {
            k: v for k, v in labels["anns"].items() if int(k) in kept_anns
        }
    selected_filenames = [labels["imgs"][cocoid]["file_name"] for cocoid in selected_ids]
    # Retry each image once, then drop it: one flaky URL out of a thousand
    # must not kill the whole dataset build (the caller sees the true
    # image count via the pruned labels).
    failed = set()
    with concurrent.futures.ThreadPoolExecutor() as executor:

        def fetch(filename):
            url = f"http://images.cocodataset.org/train2014/{filename}"
            for attempt in range(2):
                try:
                    tools.download_and_verify(
                        url=url, cache_dir=images_dir, verbose=False
                    )
                    return None
                except Exception as exc:  # noqa: BLE001 - any transport error
                    last = exc
            return filename, last

        for result in executor.map(fetch, selected_filenames):
            if result is not None:
                filename, exc = result
                warnings.warn(f"skipping {filename}: {type(exc).__name__}: {exc}")
                failed.add(filename)
    if failed:
        kept = [
            (cocoid, filename)
            for cocoid, filename in zip(selected_ids, selected_filenames)
            if filename not in failed
        ]
        selected_ids = [cocoid for cocoid, _ in kept]
        selected_filenames = [filename for _, filename in kept]
        kept_ids = set(selected_ids)
        labels["imgs"] = {k: v for k, v in labels["imgs"].items() if k in kept_ids}
        labels["imgToAnns"] = {
            k: v for k, v in labels["imgToAnns"].items() if k in kept_ids
        }
        kept_anns = set(
            itertools.chain.from_iterable(labels["imgToAnns"].values())
        )
        labels["anns"] = {
            k: v for k, v in labels["anns"].items() if int(k) in kept_anns
        }
    dataset = []
    for selected_id, filename in zip(selected_ids, selected_filenames):
        filepath = os.path.join(images_dir, filename)
        for ann_index in labels["imgToAnns"][selected_id]:
            ann = labels["anns"][str(ann_index)]
            if english_only and ann["language"] != "english":
                continue
            if legible_only and ann["legibility"] != "legible":
                continue
            dataset.append(
                (filepath, np.array(ann["mask"]).reshape(-1, 2), ann["utf8_string"])
            )
    if return_raw_labels:
        return dataset, (labels, images_dir)
    return dataset


def get_born_digital_recognizer_dataset(split="train", cache_dir=None):
    """Pre-cropped word images: (filepath, None, word). (:128-191.)"""
    data = []
    if cache_dir is None:
        cache_dir = tools.get_default_cache_dir()
    main_dir = os.path.join(cache_dir, "borndigital")
    assert split in ["train", "traintest", "test"], f"Unsupported split: {split}"
    if split in ["train", "traintest"]:
        train_dir = os.path.join(main_dir, "train")
        if (
            len(
                glob.glob(os.path.join(train_dir, "*.png"))
                + glob.glob(os.path.join(train_dir, "*.txt"))
            )
            != 3568
        ):
            tools.download_and_extract(
                url="https://github.com/faustomorales/keras-ocr/releases/download/v0.8.4/Challenge1_Training_Task3_Images_GT.zip",
                filename="Challenge1_Training_Task3_Images_GT.zip",
                cache_dir=main_dir,
                sha256="8ede0639f5a8031d584afd98cee893d1c5275d7f17863afc2cba24b13c932b07",
                destination=train_dir,
            )
        data.extend(
            _read_born_digital_labels_file(
                labels_filepath=os.path.join(train_dir, "gt.txt"),
                image_folder=train_dir,
            )
        )
    if split in ["test", "traintest"]:
        test_dir = os.path.join(main_dir, "test")
        if len(glob.glob(os.path.join(test_dir, "*.png"))) != 1439:
            tools.download_and_extract(
                url="https://github.com/faustomorales/keras-ocr/releases/download/v0.8.4/Challenge1_Test_Task3_Images.zip",
                filename="Challenge1_Test_Task3_Images.zip",
                cache_dir=main_dir,
                sha256="8f781b0140fd0bac3750530f0924bce5db3341fd314a2fcbe9e0b6ca409a77f0",
                destination=test_dir,
            )
        test_gt_path = tools.download_and_verify(
            url="https://github.com/faustomorales/keras-ocr/releases/download/v0.8.4/Challenge1_Test_Task3_GT.txt",
            cache_dir=test_dir,
            filename="Challenge1_Test_Task3_GT.txt",
            sha256="fce7f1228b7c4c26a59f13f562085148acf063d6690ce51afc395e0a1aabf8be",
        )
        data.extend(
            _read_born_digital_labels_file(
                labels_filepath=test_gt_path, image_folder=test_dir
            )
        )
    return data


def get_icdar_2013_recognizer_dataset(cache_dir=None):
    """(filepath, box, word) triples via combine_line. (:194-212.)"""
    dataset = []
    for image_path, lines, _ in get_icdar_2013_detector_dataset(
        cache_dir=cache_dir, skip_illegible=True
    ):
        for line in lines:
            box, text = tools.combine_line(line)
            dataset.append((image_path, box, text))
    return dataset


def get_icdar_2013_detector_dataset(cache_dir=None, skip_illegible=False):
    """Character-level GT: (image_path, lines, confidence=1). (:215-278.)"""
    if cache_dir is None:
        cache_dir = tools.get_default_cache_dir()
    main_dir = os.path.join(cache_dir, "icdar2013")
    training_images_dir = os.path.join(main_dir, "Challenge2_Training_Task12_Images")
    if len(glob.glob(os.path.join(training_images_dir, "*.jpg"))) != 229:
        tools.download_and_extract(
            url="https://github.com/faustomorales/keras-ocr/releases/download/v0.8.4/Challenge2_Training_Task12_Images.zip",
            cache_dir=main_dir,
            filename="Challenge2_Training_Task12_Images.zip",
            sha256="7a57d1699fbb92db3ad82c930202938562edaf72e1c422ddd923860d8ace8ded",
            destination=training_images_dir,
        )
    training_gt_dir = os.path.join(main_dir, "Challenge2_Training_Task2_GT")
    if len(glob.glob(os.path.join(training_gt_dir, "*.txt"))) != 229:
        tools.download_and_extract(
            url="https://github.com/faustomorales/keras-ocr/releases/download/v0.8.4/Challenge2_Training_Task2_GT.zip",
            cache_dir=main_dir,
            filename="Challenge2_Training_Task2_GT.zip",
            sha256="4cedd5b1e33dc4354058f5967221ac85dbdf91a99b30f3ab1ecdf42786a9d027",
            destination=training_gt_dir,
        )

    dataset = []
    for gt_filepath in glob.glob(os.path.join(training_gt_dir, "*.txt")):
        image_id = os.path.split(gt_filepath)[1].split("_")[0]
        image_path = os.path.join(training_images_dir, image_id + ".jpg")
        with open(gt_filepath, "r", encoding="utf8") as f:
            lines = _parse_icdar_2013_gt(f.read(), skip_illegible=skip_illegible)
        dataset.append((image_path, lines, 1))
    return dataset


def _parse_icdar_2013_gt(text, skip_illegible=False):
    """Character rows -> [[(char box(4,2), char), ...] per line].

    Format (reference datasets.py:260-277): space-separated rows of
    ``r g b cx cy x1 y1 x2 y2 "c"``; a blank row ends the current line;
    an empty quoted character marks an illegible glyph.
    """
    lines = []
    current_line: typing.List[typing.Tuple[np.ndarray, str]] = []
    for raw_row in text.split("\n"):
        if raw_row == "":
            lines.append(current_line)
            current_line = []
            continue
        row = raw_row.split(" ")[5:]
        character = row[-1][1:-1]
        if character == "" and skip_illegible:
            continue
        x1, y1, x2, y2 = map(int, row[:4])
        current_line.append(
            (np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]]), character)
        )
    # Lines that held only illegible characters end up empty; drop them.
    return [line for line in lines if line]


def get_icdar_2019_semisupervised_dataset(cache_dir=None):
    """EXPERIMENTAL semi-supervised ICDAR 2019 MLT set. (:281-347.)"""
    warnings.warn(
        "You may need to get this dataset manually in-browser by downloading "
        "https://www.mediafire.com/file/snekaezeextc3ee/ImagesPart1.zip/file "
        "and https://www.mediafire.com/file/i2snljkfm4t2ojm/ImagesPart2.zip/file "
        "and putting them in ~/.keras-ocr/icdar2019.",
        UserWarning,
    )
    if cache_dir is None:
        cache_dir = tools.get_default_cache_dir()
    main_dir = os.path.join(cache_dir, "icdar2019")
    training_dir_1 = os.path.join(main_dir, "ImagesPart1")
    training_dir_2 = os.path.join(main_dir, "ImagesPart2")
    if len(glob.glob(os.path.join(training_dir_1, "*"))) != 5000:
        tools.download_and_extract(
            url="https://www.mediafire.com/file/snekaezeextc3ee/ImagesPart1.zip/file",
            cache_dir=main_dir,
            filename="ImagesPart1.zip",
            sha256="1968894ef93b97f3ef4c97880b6dce85b1851f4d778e253f4e7265b152a4986f",
            destination=main_dir,
        )
    if len(glob.glob(os.path.join(training_dir_2, "*"))) != 5000:
        tools.download_and_extract(
            url="https://www.mediafire.com/file/i2snljkfm4t2ojm/ImagesPart2.zip/file",
            cache_dir=main_dir,
            filename="ImagesPart2.zip",
            sha256="5651b9137e877f731bfebb2a8b75042e26baa389d2fb1cfdbb9e3da343757241",
            destination=main_dir,
        )
    ground_truth = tools.download_and_verify(
        url="https://github.com/faustomorales/keras-ocr/releases/download/v0.8.4/mlt2019_dataset.json",
        cache_dir=main_dir,
        filename="mlt2019_dataset.json",
    )
    with open(ground_truth, "r", encoding="utf8") as f:
        character_level_dataset = json.loads(f.read())["dataset"]
    for gif_filepath in glob.glob(os.path.join(main_dir, "**", "*.gif")):
        # JAX's loader saves PIL's RGB conversion as a .jpg of the same stem;
        # the port decodes the GIF and writes the bytes PIL writes.
        with open(os.path.splitext(gif_filepath)[0] + ".jpg", "wb") as f:
            f.write(tools._encode_jpeg(tools.read(gif_filepath)))
        os.remove(gif_filepath)
    return [
        (
            os.path.join(main_dir, entry["filepath"]),
            [
                [(np.array(box).clip(0, np.inf), None) for box in line["line"]]
                for line in entry["lines"]
                if line["line"]
            ],
            entry["percent_complete"],
        )
        for entry in character_level_dataset
        if entry["percent_complete"] > 0.5
    ]


def get_detector_image_generator(
    labels,
    width,
    height,
    augmenter=None,
    area_threshold=0.5,
    focused=False,
    min_area=None,
    shuffle=True,
):
    """Augmented (image, lines, confidence) tuples for detector training.

    (:350-421, with the imgaug "focused" pre-crop replaced by our
    augmentation.Crop + CropToFixedSize.)
    """
    labels = labels.copy()
    for index in itertools.cycle(range(len(labels))):
        if index == 0 and shuffle:
            random.shuffle(labels)
        image_filepath, lines, confidence = labels[index]
        image = tools.read(image_filepath)
        if augmenter is not None:
            image, lines = tools.augment(
                boxes=lines,
                boxes_format="lines",
                image=image,
                area_threshold=area_threshold,
                min_area=min_area,
                augmenter=augmenter,
            )
        if focused:
            boxes = [tools.combine_line(line)[0] for line in lines]
            if boxes:
                selected = np.array(boxes[np.random.choice(len(boxes))])
                left, top = selected.min(axis=0).clip(0, np.inf).astype("int")
                if left > 0:
                    left -= np.random.randint(0, min(left, width / 2))
                if top > 0:
                    top -= np.random.randint(0, min(top, height / 2))
                image, lines = tools.augment(
                    boxes=lines,
                    augmenter=augmentation.Sequential(
                        [
                            augmentation.Crop(px=(int(top), 0, 0, int(left))),
                            augmentation.CropToFixedSize(
                                width=width, height=height, position="right-bottom"
                            ),
                        ]
                    ),
                    boxes_format="lines",
                    image=image,
                    min_area=min_area,
                    area_threshold=area_threshold,
                )
        image, scale = tools.fit(
            image, width=width, height=height, mode="letterbox", return_scale=True
        )
        lines = tools.adjust_boxes(boxes=lines, boxes_format="lines", scale=scale)
        yield image, lines, confidence


def get_recognizer_image_generator(
    labels, height, width, alphabet, augmenter=None, shuffle=True
):
    """Augmented (image, text) tuples for recognizer training. (:424-470.)"""
    n_with_illegal_characters = sum(
        any(c not in alphabet for c in text) for _, _, text in labels
    )
    if n_with_illegal_characters > 0:
        print(
            f"{n_with_illegal_characters} / {len(labels)} instances have illegal characters."
        )
    labels = labels.copy()
    for index in itertools.cycle(range(len(labels))):
        if index == 0 and shuffle:
            random.shuffle(labels)
        filepath, box, text = labels[index]
        cval = np.random.randint(low=0, high=255, size=3).astype("uint8")
        if box is not None:
            image = tools.warpBox(
                image=tools.read(filepath),
                box=np.asarray(box).astype("float32"),
                target_height=height,
                target_width=width,
                cval=cval,
            )
        else:
            image = tools.read_and_fit(
                filepath_or_array=filepath, width=width, height=height, cval=cval
            )
        text = "".join([c for c in text if c in alphabet])
        if not text:
            continue
        if augmenter:
            image = augmenter.augment_image(image)
        yield (image, text)
