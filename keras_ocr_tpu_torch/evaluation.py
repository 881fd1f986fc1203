"""End-to-end OCR scoring of the port: polygon IoU matching and edit distance.

Counterpart of ``keras_ocr_tpu/evaluation.py``, in numpy: the Clipper
polygon intersection is a Sutherland-Hodgman clip by a convex polygon
(detection boxes are convex quads), and ``editdistance`` a Levenshtein
dynamic programme. Scoring is offline, so it stays on the host.
"""

from __future__ import annotations

import copy
import typing
import warnings

import numpy as np

from .tools import polygon_area


def _clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman: clip ``subject`` polygon by convex ``clip`` polygon."""
    # Ensure the clip polygon is counter-clockwise (positive signed area).
    def signed_area(poly):
        x, y = poly[:, 0], poly[:, 1]
        return (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2

    if signed_area(clip) < 0:
        clip = clip[::-1]
    output = [tuple(p) for p in subject]
    for i in range(len(clip)):
        if not output:
            return np.zeros((0, 2))
        a = clip[i]
        b = clip[(i + 1) % len(clip)]
        edge = (b[0] - a[0], b[1] - a[1])
        input_pts = output
        output = []

        def inside(p):
            return edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0]) >= 0

        def intersect(p, q):
            # Line a-b with segment p-q.
            r = (q[0] - p[0], q[1] - p[1])
            denom = edge[0] * r[1] - edge[1] * r[0]
            if denom == 0:
                return q
            num = edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0])
            t = -num / denom
            return (p[0] + t * r[0], p[1] + t * r[1])

        for j, current in enumerate(input_pts):
            previous = input_pts[j - 1]
            if inside(current):
                if not inside(previous):
                    output.append(intersect(previous, current))
                output.append(current)
            elif inside(previous):
                output.append(intersect(previous, current))
    return np.array(output) if output else np.zeros((0, 2))


def iou_score(box1, box2):
    """Intersection-over-union of two (possibly rotated) boxes.

    Boxes of two points are expanded to axis-aligned quads; coordinates are
    cast to int32, as the reference's integer Clipper pipeline takes them.
    A box of zero area warns and scores 0.
    """
    box1 = np.asarray(box1)
    box2 = np.asarray(box2)
    if len(box1) == 2:
        (x1, y1), (x2, y2) = box1
        box1 = np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]])
    if len(box2) == 2:
        (x1, y1), (x2, y2) = box2
        box2 = np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]])
    box1 = np.array(box1, dtype="int32").astype("float64")
    box2 = np.array(box2, dtype="int32").astype("float64")
    area1 = polygon_area(box1)
    area2 = polygon_area(box2)
    if area1 == 0 or area2 == 0:
        warnings.warn("A box with zero area was detected.")
        return 0
    intersection = polygon_area(_clip_polygon(box1, box2))
    union = area1 + area2 - intersection
    if union == 0:
        return 0
    return intersection / union


def levenshtein(a: str, b: str) -> int:
    """Edit distance between two strings (editdistance.eval analog)."""
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    previous = np.arange(len(b) + 1)
    for i, ca in enumerate(a, start=1):
        current = np.empty(len(b) + 1, dtype=np.int64)
        current[0] = i
        for j, cb in enumerate(b, start=1):
            current[j] = min(
                previous[j] + 1,
                current[j - 1] + 1,
                previous[j - 1] + (ca != cb),
            )
        previous = current
    return int(previous[-1])


def score(true, pred, iou_threshold=0.5, similarity_threshold=0.5, translator=None):
    """Greedy IoU matching with text-similarity bucketing; returns (results, (P, R)).

    ``true`` and ``pred`` map image ids to lists of ``{"text", "vertices"}``
    annotations (``"ignore": True`` on a ground truth matches without
    counting). ``translator`` is applied to both texts with
    ``str.translate``. True positives are counted once per (image_id,
    true_idx).
    """
    true_ids = sorted(true)
    pred_ids = sorted(pred)
    assert all(
        true_id == pred_id for true_id, pred_id in zip(true_ids, pred_ids)
    ), "true and pred dictionaries must have the same keys"
    results: typing.Dict[str, typing.List[dict]] = {
        "true_positives": [],
        "false_positives": [],
        "near_true_positives": [],
        "false_negatives": [],
    }
    for image_id in true_ids:
        true_anns = true[image_id]
        pred_anns = copy.deepcopy(pred[image_id])
        pred_matched = set()
        for true_index, true_ann in enumerate(true_anns):
            match = None
            for pred_index, pred_ann in enumerate(pred_anns):
                iou = iou_score(true_ann["vertices"], pred_ann["vertices"])
                if iou >= iou_threshold:
                    match = {
                        "true_idx": true_index,
                        "pred_idx": pred_index,
                        "image_id": image_id,
                    }
                    pred_matched.add(pred_index)
                    true_text = true_ann["text"]
                    pred_text = pred_ann["text"]
                    if true_ann.get("ignore", False):
                        continue
                    if translator is not None:
                        true_text = true_text.translate(translator)
                        pred_text = pred_text.translate(translator)
                    edit_distance_norm = max(len(true_text), len(pred_text))
                    if edit_distance_norm == 0:
                        similarity = 1
                    else:
                        similarity = 1 - (
                            levenshtein(true_text, pred_text)
                            / max(len(true_text), len(pred_text))
                        )
                    if similarity >= similarity_threshold:
                        results["true_positives"].append(match)
                    else:
                        results["near_true_positives"].append(match)
            if match is None and not true_ann.get("ignore", False):
                results["false_negatives"].append(
                    {"image_id": image_id, "true_idx": true_index}
                )
        results["false_positives"].extend(
            {"pred_index": pred_index, "image_id": image_id}
            for pred_index, _ in enumerate(pred_anns)
            if pred_index not in pred_matched
        )
    fns = len(results["false_negatives"])
    fps = len(results["false_positives"])
    tps = len(
        set(
            (true_positive["image_id"], true_positive["true_idx"])
            for true_positive in results["true_positives"]
        )
    )
    # Degenerate guards (no predictions / no ground truth): the reference
    # would raise ZeroDivisionError here; 0.0 is the conventional value.
    precision = tps / (tps + fps) if (tps + fps) else 0.0
    recall = tps / (tps + fns) if (tps + fns) else 0.0
    return results, (precision, recall)
