"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each printing one line; any failure exits non-zero:

1. environment: the card (name, power limit), torch and CUDA versions, TF32
   off for convolutions and matrix products;
2. build: both CUDA sources of ``keras_ocr_tpu_torch/csrc`` (the sweep
   kernel and the conv kernel), started together, each with its time;
3. kernel vs plain: both entries of the sweep kernel (the label sweeps and
   the keyed row/column runs of the blob census) against their plain
   PyTorch versions on the card, on seeded masks (densities 0.3-0.8 plus a
   serpentine that needs more than 8 sweeps) at (4, 256, 320) and
   (8, 480, 640); maps and converged flags must be exactly equal; median
   times of 20 runs, with the bytes a full pass moves and the HBM bound of
   the bytes this data needs (each image stops at its fixpoint, and a pass
   writes only what it changes) and the share of it.
   The same on the calls one ``get_boxes`` makes on the golden artifact's
   own heatmaps (its first 8 scenes), recorded as the main path makes
   them. Then the conv kernel: ``conv_chain`` on the 12 conv
   chains of a full-width CRAFT at 960x1280, batch 1, and
   ``conv3x3_bias_act`` at C3 and at an odd size, against ``F.conv2d``
   (cuDNN, TF32 off) within 1e-4 * max(1, max|plain|), median of 20 each,
   with each chain's rate as a share of the kernel's 3xTF32 ceiling and
   the Cout tile each layer took, and one ``F.conv2d`` as the library
   yardstick of ``conv3x3_bias_act``;
4. golden: the committed trained slim pipeline
   (``tests/fixtures/golden_offline``) must read at least the artifact's
   ``pass_fraction`` of its expected words;
5. full width: ``Detector(width=1.0)`` and the default ``Recognizer``
   (filters 64..512, STN) on seeded random weights, ``Pipeline(scale=2)``
   on the golden scenes padded to 640x480, through ``recognize`` and
   ``recognize_many(batch_size=8)``; the output must be well formed with
   finite boxes, the device program must enqueue without a host
   synchronisation, and the pipeline phases must have launched both sweep
   kernel entries;
6. golden, folded: the same artifact through ``Detector(fold_bn=True)``,
   its standard checkpoint folded on load, must pass too, with both conv
   wrappers launched;
7. full width, folded: the full-width detector with seeded BatchNorm
   statistics, folded into ``Detector(fold_bn=True)``; its heatmaps must
   agree with the unfolded cuDNN graph within 1e-3 * max(1, max|ref|);
   ``recognize`` and ``recognize_many`` of both graphs, the folded device
   program under sync debug mode "error", and the CRAFT forward of both
   graphs at batch 1 and 8.

8. refine: (8, 480, 640, 2) heatmaps of seeded split words (whose dilated
   segmaps fall into several blobs), a blob nested in a ring's hole, and one
   word wider than 512 columns that fails the first refine level.
   ``get_boxes`` + ``refine_boxes`` at each level of ``ops.refine.LADDER``
   on the card, every sweep-kernel call held exact against its plain
   version on the same tensors (the window batches of the labelling and the
   flood); level 1 also against the whole CPU run (``refine_ok`` and
   ``n_flagged`` exact, boxes within 1e-3 px), levels 2 and 3 against
   level 1's boxes of the images both prove; per level the host enqueue
   and event ms (medians of 3), the device busy ms and the sweep kernel's
   part (``torch.profiler``) and the sweep-kernel launches. ``Detector.detect``
   with CRAFT replaced by those heatmaps must take no host fallback and
   agree with the host oracle ``getBoxes`` within 3 px; the full-width
   ``Detector.detect`` runs on 8 scenes; the full-width pipeline on the
   stand-in heatmaps must escalate the refine ladder, end with flag 2
   clear, and enqueue at refine levels 1-3 without a host synchronisation.

9. two-stage: the golden artifact through ``recognize(...,
   recognition_kwargs={"verbose": 0})`` (host resize, ``Detector.detect``,
   host ``warpBox`` crops, the CRNN), standard and folded: its word fraction
   and ``evaluation.score`` against the fused path's results must reach
   ``pass_fraction``, both sweep-kernel entries must launch, and both conv
   entries on the folded graph; the full-width CRNN's softmax on the card
   within 1e-4 of the CPU on the slim detector's crops; the full-width
   two-stage ``recognize`` p50 beside the fused one, and its stage split
   (host resize, ``detect``, host crops, CRNN + CTC).

10. serving: ``tests/fixtures/test_image.jpg`` read by path with the port's
   JPEG decoder (its sha256 must be that of PIL's decode, which
   ``tests/test_torch_tools.py`` asserts too; median decode ms beside the
   host's CPU model), and the full-width ``recognize`` of that path; the
   golden pipeline, standard and folded, exported on the card at its
   ``pad_to`` envelope (batch 4), loaded with ``load_exported`` and served
   the 12 scenes through ``ExportedPipeline.recognize``: the word fraction
   must reach ``pass_fraction``, every packed output must equal the live
   device program's at the baked levels, and the kernels must launch inside
   the artifact's run (counted from zero); then the full-width pipeline
   exported at 640x480, batch 1 and 8, with its export, save and load
   seconds, ``.pt2`` size and graph nodes, and the artifact's ``recognize``
   p50 timed in turns with the live one's.

11. training: the full-width CRNN (``DEFAULT_BUILD_PARAMS``, dropout 0) at
   batch 8 and CRAFT (width 1.0) at 2x256x256 take one train step on the
   card and the same step on the CPU from the same state, in float32 and in
   float64: the float32 losses within 1e-4 relative; each float64 gradient
   leaf within 1e-3 of its largest |g| (leaves at rounding noise within
   1e-4 of the model's largest), the worst leaf printed, and the float32
   gradients' distance from the float64 ones on the card and the CPU; 20
   steps on a fixed batch must lower each loss; an OHEM step must give a
   finite loss. Times (CUDA events, medians of 10): CRNN steps
   at batch 8 and 64, CRAFT steps at 640x640 batch 8 on
   ``get_batch_generator`` batches of numpy-drawn character lines, with the
   peak memory and the host ms of one generator batch; the port's
   ``ctc_loss`` forward + backward against ``F.ctc_loss`` at batch 64.
   ``fit`` for 2 epochs x 2 steps with ``EarlyStopping``,
   ``ModelCheckpoint`` and ``CSVLogger``, then ``save_npz`` (in
   ``build/training``, removed at the end); the trained detector's
   ``Detector.detect`` of a golden scene must launch both sweep-kernel
   entries. The train step launches none of the three kernels.

Phases 4-5 (the default path), 6-7 (the folded path), 8 (the refine
path), each run of 9 and each golden artifact's run in 10 count their
kernel launches from zero; the kernel ops are
``torch.ops.keras_ocr_tpu_torch.{cc_sweeps, cc_keyed_rows_cols, conv_layer}``,
whose CUDA kernels count. The second-to-last line is the kernel table as
JSON; the last line is ``{"ok": true, "device": {...}}``. There is no CPU
path.
"""

from __future__ import annotations

import hashlib
import json
import gc
import math
import os
import platform
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(ROOT, "tests", "fixtures", "golden_offline")
SHAPES = ((4, 256, 320), (8, 480, 640))
# The 12 conv chains of a full-width CRAFT forward of one 960x1280 input
# (640x480 at scale 2): (name, H, W, Cin, ((k, Cout, relu), ...), pool, tap).
CRAFT_CHAINS = (
    ("C1 slice1_0,3", 960, 1280, 3, ((3, 64, True), (3, 64, True)), True, False),
    ("C2 slice1_7,10", 480, 640, 64, ((3, 128, True), (3, 128, True)), True, True),
    ("C3 slice2_14,17", 240, 320, 128, ((3, 256, True), (3, 256, True)), False, False),
    ("C4 slice3_20", 240, 320, 256, ((3, 256, True),), True, False),
    ("C5 slice3_24,27", 120, 160, 256, ((3, 512, True), (3, 512, True)), False, False),
    ("C6 slice4_30", 120, 160, 512, ((3, 512, True),), True, False),
    ("C7 slice4_34,37", 60, 80, 512, ((3, 512, True), (3, 512, False)), False, False),
    ("upconv1", 60, 80, 1536, ((1, 512, True), (3, 256, True)), False, False),
    ("upconv2", 120, 160, 768, ((1, 256, True), (3, 128, True)), False, False),
    ("upconv3", 240, 320, 384, ((1, 128, True), (3, 64, True)), False, False),
    ("upconv4", 480, 640, 192, ((1, 64, True), (3, 32, True)), False, False),
    ("cls", 480, 640, 32, ((3, 32, True), (3, 32, True), (3, 16, True), (1, 16, True),
                           (1, 2, False)), False, False),
)
# conv3x3_bias_act alone: C3's first layer and an odd size with Cin 3.
CONV3X3_SHAPES = ((1, 240, 320, 128, 256), (2, 13, 37, 3, 16))
CONV_BAR = 1e-4
# The conv kernel takes three TF32 tensor-core products per multiply-add:
# its ceiling is a third of the H100's 495 TFLOP/s dense TF32.
CEILING_TFLOPS = 495 / 3
HEATMAP_BAR = 1e-3
# The H100 SXM's published HBM rate, TB/s: the sweep kernel's bound.
HBM_TBS = 3.35
# The refine phase's heatmaps; its box bars: the CPU run, and the host
# oracle (tests/test_refine.py's 3 px).
REFINE_SHAPE = (8, 480, 640)
REFINE_BAR = 1e-3
ORACLE_BAR = 3.0
# The serving phase's JPEG and the sha256 of PIL's RGB decode of it.
SERVING_JPEG = os.path.join(ROOT, "tests", "fixtures", "test_image.jpg")
SERVING_JPEG_SHA256 = "f5cb48dc1b0a224b4e16c418b92a2e0b851364882e21645efdd244d0fc3207c4"
SERVING_DIR = os.path.join(ROOT, "build", "serving")
# Each kernel's op in torch.ops.keras_ocr_tpu_torch.
OPS = {"cc_sweeps": "cc_sweeps", "cc_keyed_rows_cols": "cc_keyed_rows_cols",
       "conv_chain": "conv_layer", "conv3x3_bias_act": "conv_layer"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def serpentine(height, width):
    """A snake with a bend every two rows: far more than 8 sweeps."""
    fg = np.zeros((height, width), bool)
    for i, row in enumerate(range(1, height - 1, 2)):
        fg[row, 2 : width - 2] = True
        if row + 2 < height - 1:
            fg[row + 1, width - 3 if i % 2 == 0 else 2] = True
    return fg


def cuda_median_ms(fn, runs=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def sweep_inputs(batch, height, width):
    """Seeded masks of density 0.3-0.8, the last one a serpentine, as
    label-propagation inputs."""
    rng = np.random.RandomState(batch)
    fg = np.stack([rng.rand(height, width) < d for d in np.linspace(0.3, 0.8, batch)])
    fg[-1] = serpentine(height, width)
    sentinel = height * width
    idx = np.arange(sentinel, dtype=np.int32).reshape(height, width)
    values = torch.from_numpy(np.where(fg, idx, sentinel).astype(np.int32)).cuda()
    return fg, values, sentinel


def keyed_inputs(batch, height, width):
    """Seeded dilated-blob covers with blocky component keys."""
    fg, values, sentinel = sweep_inputs(batch, height, width)
    yy, xx = np.mgrid[0:height, 0:width]
    key = np.broadcast_to((yy // 24 * 7 + xx // 40) % 5, fg.shape).astype(np.int32)
    key = np.where(fg, key, -1)
    return values, torch.from_numpy(key).cuda(), torch.from_numpy(fg).cuda(), sentinel


def one_pass(plain, values, planes, rows):
    """One row (or column) pass of the plain sweep ``plain(values, *planes)``
    over (B, H, W) maps: one sweep of each line as a map of one row, whose
    column pass changes nothing."""
    if not rows:
        values, planes = values.transpose(1, 2), [p.transpose(1, 2) for p in planes]
    shape = values.shape

    def lines(t):
        return t.reshape(-1, 1, shape[-1])

    out = plain(lines(values), *map(lines, planes)).reshape(shape)
    return out if rows else out.transpose(1, 2)


def changed_sectors(before, after):
    """The 32 B sectors of int32 maps, laid out as in memory, in which
    ``after`` differs from ``before``."""
    diff = (before != after).flatten().to(torch.int8)
    diff = torch.cat([diff, diff.new_zeros(-diff.numel() % 8)])
    return int(diff.view(-1, 8).any(1).sum())


def sweep_bytes(cc_cuda, values, barrier, sentinel, total):
    """The bytes the passes of one ``cc_sweeps`` call of ``total`` sweeps
    must move, and per image the sweeps it runs: all up to and including
    the first that changes nothing. Each pass that runs reads the labels
    (4 B/px) and the byte barrier (1 B/px); the first pass writes the whole
    output (4 B/px), a later one only the 32 B sectors it changes (the plain
    version, stepped one pass at a time, finds them)."""
    values = values.reshape((-1,) + values.shape[-2:])
    barrier = barrier.reshape(values.shape)
    batch, cells = values.shape[0], values[0].numel()

    def plain(v, b):
        return cc_cuda.segmented_min_sweeps_plain(v, b, sentinel, 1)

    ran = torch.zeros(batch, dtype=torch.int64, device=values.device)
    running = torch.ones_like(ran, dtype=torch.bool)
    nbytes, first = 0, True
    for _ in range(total):
        ran += running
        start = values
        for rows in (True, False):
            swept = one_pass(plain, values, [barrier], rows)
            written = 4 * batch * cells if first else 32 * changed_sectors(values, swept)
            nbytes += 5 * cells * int(running.sum()) + written
            values, first = swept, False
        running &= (values != start).flatten(1).any(1)
    return nbytes, ran.tolist()


def keyed_bytes(cc_cuda, values, key, fg, sentinel):
    """The bytes one ``cc_keyed_rows_cols`` call must move: the row pass
    reads the labels and the key (4 B/px each) and the byte mask (1 B/px)
    and writes the whole output (4 B/px); the column pass reads 9 B/px and
    writes only the 32 B sectors it changes."""

    def plain(v, k, f):
        return cc_cuda.keyed_rows_cols_plain(v, k, f, sentinel)

    rows = one_pass(plain, values, [key, fg], True)
    both = cc_cuda.keyed_rows_cols_plain(values, key, fg, sentinel)
    return 22 * values.numel() + 32 * changed_sectors(rows, both)


def bytes_ms(nbytes):
    """Least time to move ``nbytes`` at HBM_TBS."""
    return nbytes / (HBM_TBS * 1e9)


def exact(what, out, ref, conv=None, ref_conv=None):
    """The largest |out - ref|, which must be 0, flags equal."""
    diff = int((out.to(torch.int64) - ref).abs().max()) if out.numel() else 0
    if diff or (conv is not None and not torch.equal(conv, ref_conv)):
        raise AssertionError(f"{what} disagrees with its plain version: max diff "
                             f"{diff}, converged {conv} vs {ref_conv}")
    return diff


def kernel_phase(cc_cuda):
    """Exact comparison and timing of the two launch entries of the sweep
    kernel against their plain versions; returns, per kernel, its JSON
    entry at (8, 480, 640)."""
    report = {name: {"max_abs_err": 0, "library_ms": None, "bound_by": "bytes"}
              for name in ("cc_sweeps", "cc_keyed_rows_cols")}
    for batch, height, width in SHAPES:
        fg, values, sentinel = sweep_inputs(batch, height, width)
        barrier = torch.from_numpy(~fg).cuda()  # bool, as the main path passes it
        for sweeps in (1, 8):
            out, conv = cc_cuda.segmented_min_sweeps(values, barrier, sentinel, sweeps, True)
            ref, ref_conv = cc_cuda.segmented_min_sweeps_plain(
                values, barrier, sentinel, sweeps, True
            )
            torch.cuda.synchronize()
            diff = exact(f"cc_sweeps {(batch, height, width)}, {sweeps} sweeps",
                         out, ref, conv, ref_conv)
            report["cc_sweeps"]["max_abs_err"] = max(report["cc_sweeps"]["max_abs_err"], diff)
        if bool(ref_conv[-1]):
            raise AssertionError("the serpentine mask converged at 8 sweeps")
        ms = cuda_median_ms(
            lambda: cc_cuda.segmented_min_sweeps(values, barrier, sentinel, 8, True)
        )
        plain_ms = cuda_median_ms(
            lambda: cc_cuda.segmented_min_sweeps_plain(values, barrier, sentinel, 8, True)
        )
        nbytes, ran = sweep_bytes(cc_cuda, values, barrier, sentinel, 9)
        cells = height * width
        full_ms = bytes_ms(18 * 9 * batch * cells)
        bound_ms = bytes_ms(nbytes)
        report["cc_sweeps"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        print(
            f"kernel vs plain: cc_sweeps {(batch, height, width)} exact, converged "
            f"{conv.tolist()}, 8 sweeps + check: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms (median of 20); a full pass moves {batch * cells * 9 / 1e6:.2f} "
            f"MB (9 B/px), 18 of them {full_ms:.4f} ms ({100 * full_ms / ms:.1f}% of the "
            f"kernel's time); sweeps run per image {ran}; the passes run must move "
            f"{nbytes / 1e6:.2f} MB (5 B/px read, the changed sectors written): bound "
            f"{bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}%)"
        )
        keyed = keyed_inputs(batch, height, width)
        out = cc_cuda.keyed_rows_cols(*keyed)
        ref = cc_cuda.keyed_rows_cols_plain(*keyed)
        torch.cuda.synchronize()
        diff = exact(f"cc_keyed_rows_cols {(batch, height, width)}", out, ref)
        report["cc_keyed_rows_cols"]["max_abs_err"] = max(
            report["cc_keyed_rows_cols"]["max_abs_err"], diff)
        ms = cuda_median_ms(lambda: cc_cuda.keyed_rows_cols(*keyed))
        plain_ms = cuda_median_ms(lambda: cc_cuda.keyed_rows_cols_plain(*keyed))
        full_ms = bytes_ms(2 * 13 * batch * cells)
        nbytes = keyed_bytes(cc_cuda, *keyed)
        bound_ms = bytes_ms(nbytes)
        report["cc_keyed_rows_cols"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        print(
            f"kernel vs plain: cc_keyed_rows_cols {(batch, height, width)} exact, "
            f"one row + column pass: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
            f"(median of 20); a full pass moves {batch * cells * 13 / 1e6:.2f} MB (13 B/px), "
            f"two of them {full_ms:.4f} ms ({100 * full_ms / ms:.1f}%); the call must move "
            f"{nbytes / 1e6:.2f} MB (the column pass writes its changed sectors): bound "
            f"{bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}%)"
        )
    return report


def golden_traffic(cc_cuda, pipeline, scenes):
    """The sweep-kernel calls of one ``get_boxes`` on the golden artifact's
    own heatmaps (its first 8 scenes as one batch): each recorded as the
    main path makes it, then held exact against its plain version and
    timed."""
    from keras_ocr_tpu_torch.ops import cc, postprocess

    calls = {"cc_sweeps": [], "cc_keyed_rows_cols": []}

    def record_sweeps(values, barrier, sentinel, num_sweeps, check_convergence=False):
        calls["cc_sweeps"].append((values.clone(), barrier.clone(), sentinel, num_sweeps))
        return cc_cuda.segmented_min_sweeps(
            values, barrier, sentinel, num_sweeps, check_convergence)

    def record_keyed(values, key, fg, sentinel):
        calls["cc_keyed_rows_cols"].append((values.clone(), key.clone(), fg.clone(), sentinel))
        return cc_cuda.keyed_rows_cols(values, key, fg, sentinel)

    saved = cc.segmented_min_sweeps, cc.keyed_rows_cols
    cc.segmented_min_sweeps, cc.keyed_rows_cols = record_sweeps, record_keyed
    try:
        with torch.inference_mode():
            heatmaps = pipeline.detector.model(craft_input(pipeline, scenes))
            postprocess.get_boxes(heatmaps, max_components=pipeline.detector.max_components)
            torch.cuda.synchronize()
    finally:
        cc.segmented_min_sweeps, cc.keyed_rows_cols = saved
    with torch.inference_mode():
        totals = {"cc_sweeps": [0.0, 0.0, 0.0], "cc_keyed_rows_cols": [0.0, 0.0, 0.0]}
        ran_all = []
        for values, barrier, sentinel, sweeps in calls["cc_sweeps"]:
            out, conv = cc_cuda.segmented_min_sweeps(values, barrier, sentinel, sweeps, True)
            ref, ref_conv = cc_cuda.segmented_min_sweeps_plain(
                values, barrier, sentinel, sweeps, True)
            torch.cuda.synchronize()
            exact("cc_sweeps on the golden masks", out, ref, conv, ref_conv)
            nbytes, ran = sweep_bytes(cc_cuda, values, barrier, sentinel, sweeps + 1)
            ran_all.append(ran)
            times = totals["cc_sweeps"]
            times[0] += cuda_median_ms(
                lambda: cc_cuda.segmented_min_sweeps(values, barrier, sentinel, sweeps, True))
            times[1] += cuda_median_ms(
                lambda: cc_cuda.segmented_min_sweeps_plain(values, barrier, sentinel, sweeps, True))
            times[2] += bytes_ms(nbytes)
        for args in calls["cc_keyed_rows_cols"]:
            out = cc_cuda.keyed_rows_cols(*args)
            ref = cc_cuda.keyed_rows_cols_plain(*args)
            torch.cuda.synchronize()
            exact("cc_keyed_rows_cols on the golden masks", out, ref)
            times = totals["cc_keyed_rows_cols"]
            times[0] += cuda_median_ms(lambda: cc_cuda.keyed_rows_cols(*args))
            times[1] += cuda_median_ms(lambda: cc_cuda.keyed_rows_cols_plain(*args))
            times[2] += bytes_ms(keyed_bytes(cc_cuda, *args))
    shape = tuple(calls["cc_sweeps"][0][0].shape)
    (ms, plain_ms, bound_ms), (kms, kplain_ms, kbound_ms) = totals.values()
    print(f"kernel vs plain on the golden masks (one get_boxes of {shape}, exact): "
          f"cc_sweeps {len(calls['cc_sweeps'])} calls, sweeps run per image {ran_all}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({100 * bound_ms / ms:.1f}%); cc_keyed_rows_cols {len(calls['cc_keyed_rows_cols'])} "
          f"calls: kernel {kms:.4f} ms, plain {kplain_ms:.4f} ms, bound {kbound_ms:.4f} ms "
          f"({100 * kbound_ms / kms:.1f}%) (sums of medians of 20)")


def check_results(results, count):
    if len(results) != count:
        raise AssertionError(f"{len(results)} results for {count} images")
    for words in results:
        for word, box in words:
            if not isinstance(word, str) or box.shape != (4, 2) or not np.isfinite(box).all():
                raise AssertionError(f"malformed result ({word!r}, {box})")


def seeded_chain(gen, batch, height, width, cin, plan):
    """A seeded NHWC input and HWIO convs scaled by 1/sqrt(K), so the
    activations stay O(1) through the chain."""
    x = torch.randn((batch, height, width, cin), generator=gen, device="cuda")
    convs = []
    for k, cout, relu in plan:
        w = torch.randn((k, k, cin, cout), generator=gen, device="cuda") / math.sqrt(k * k * cin)
        b = 0.1 * torch.randn((cout,), generator=gen, device="cuda")
        convs.append((w, b, relu))
        cin = cout
    return x, convs


def conv_flop(batch, height, width, cin, plan):
    total = 0
    for k, cout, _ in plan:
        total += 2 * batch * height * width * k * k * cin * cout
        cin = cout
    return total


def conv_bytes(batch, height, width, cin, plan, pool=False, tap=False):
    """fp32 bytes a chain must move: each layer reads its input and
    weights and writes its output (pooled a quarter, and the tap as well)."""
    total = 0
    for i, (k, cout, _) in enumerate(plan):
        out = batch * height * width * cout
        if pool and i == len(plan) - 1:
            out = out // 4 + (out if tap else 0)
        total += 4 * (batch * height * width * cin + k * k * cin * cout + cout + out)
        cin = cout
    return total


def conv_bound_ms(flop, nbytes):
    """The larger of the operations at the 3xTF32 ceiling and the bytes at
    the HBM rate."""
    return max(flop / (CEILING_TFLOPS * 1e9), nbytes / (HBM_TBS * 1e9))


def check_close(what, out, ref, bar, relative=False):
    """max|out - ref|, which must be <= bar * max(1, max|ref|); with
    ``relative``, also that difference over max(1, max|ref|)."""
    if out.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(out.shape)} vs {tuple(ref.shape)}")
    err = float((out - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    if not err <= bar * scale:
        raise AssertionError(f"{what}: max |diff| {err} above {bar} * {scale}")
    return (err, err / scale) if relative else err


def conv_phase(conv_cuda):
    """Both conv wrappers against their plain versions (cuDNN) at the CRAFT
    shapes; returns, per kernel, the largest difference and (kernel ms,
    plain ms): the sum over the 12 chains for ``conv_chain``, C3's first
    layer for ``conv3x3_bias_act``."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"conv_chain": {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                             "bound_by": "operations", "library_ms": None},
              "conv3x3_bias_act": {"max_abs_err": 0.0, "bound_by": "operations"}}
    total_flop = total_bytes = 0
    for name, height, width, cin, plan, pool, tap in CRAFT_CHAINS:
        x, convs = seeded_chain(gen, 1, height, width, cin, plan)

        def kernel():
            return conv_cuda.conv_chain(x, convs, pool=pool, tap_prepool=tap)

        def plain():
            return conv_cuda.conv_chain_plain(x, convs, pool=pool, tap_prepool=tap)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        pairs = list(zip(out, ref, ("output", "tap"))) if tap else [(out, ref, "output")]
        errs = [check_close(f"conv_chain {name} {what}", o, r, CONV_BAR, relative=True)
                for o, r, what in pairs]
        err, rel = max(e for e, _ in errs), max(r for _, r in errs)
        chain = report["conv_chain"]
        chain["max_abs_err"] = max(chain["max_abs_err"], err)
        ms, plain_ms = cuda_median_ms(kernel), cuda_median_ms(plain)
        chain["ms"] += ms
        chain["plain_ms"] += plain_ms
        flop = conv_flop(1, height, width, cin, plan)
        total_flop += flop
        total_bytes += conv_bytes(1, height, width, cin, plan, pool, tap)
        tflops = flop / ms / 1e9
        print(f"kernel vs plain: conv_chain {name} (1, {height}, {width}, {cin}) "
              f"{[p[:2] for p in plan]}{' pool' if pool else ''}{' tap' if tap else ''}: "
              f"max |diff| {err:.3e} ({rel:.2e} of max(1, max|plain|)); {flop / 1e9:.2f} "
              f"GFLOP, kernel {ms:.4f} ms ({tflops:.2f} TFLOP/s, "
              f"{100 * tflops / CEILING_TFLOPS:.1f}% of the 3xTF32 ceiling; Cout tiles "
              f"{[conv_cuda.tile_n(p[1]) for p in plan]}), plain {plain_ms:.4f} ms "
              f"({flop / plain_ms / 1e9:.2f} TFLOP/s) (median of 20)")
    ms, plain_ms = report["conv_chain"]["ms"], report["conv_chain"]["plain_ms"]
    report["conv_chain"]["bound_ms"] = conv_bound_ms(total_flop, total_bytes)
    print(f"kernel vs plain: conv_chain, the 12 chains of one 960x1280 CRAFT forward: "
          f"{total_flop / 1e9:.2f} GFLOP, {total_bytes / 1e9:.2f} GB, kernel {ms:.4f} ms "
          f"({total_flop / ms / 1e9:.2f} TFLOP/s, {100 * total_flop / ms / 1e9 / CEILING_TFLOPS:.1f}% "
          f"of the {CEILING_TFLOPS:.0f} TFLOP/s 3xTF32 ceiling), plain {plain_ms:.4f} ms "
          f"({total_flop / plain_ms / 1e9:.2f} TFLOP/s)")
    for batch, height, width, cin, cout in CONV3X3_SHAPES:
        x, ((w, b, _),) = seeded_chain(gen, batch, height, width, cin, ((3, cout, True),))
        for relu in (True, False):
            out = conv_cuda.conv3x3_bias_act(x, w, b, relu=relu)
            ref = conv_cuda.conv3x3_bias_act_plain(x, w, b, relu=relu)
            torch.cuda.synchronize()
            err = check_close(f"conv3x3_bias_act {(batch, height, width, cin, cout)}",
                              out, ref, CONV_BAR)
            single = report["conv3x3_bias_act"]
            single["max_abs_err"] = max(single["max_abs_err"], err)
        ms = cuda_median_ms(lambda: conv_cuda.conv3x3_bias_act(x, w, b))
        plain_ms = cuda_median_ms(lambda: conv_cuda.conv3x3_bias_act_plain(x, w, b))
        # The library call: one cuDNN convolution with its bias, NCHW, the
        # layout change and the ReLU left out.
        x_nchw, w_oihw = x.permute(0, 3, 1, 2).contiguous(), w.permute(3, 2, 0, 1).contiguous()
        library_ms = cuda_median_ms(lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, b, padding=1))
        flop = conv_flop(batch, height, width, cin, ((3, cout, True),))
        bound_ms = conv_bound_ms(flop, conv_bytes(batch, height, width, cin, ((3, cout, True),)))
        if "ms" not in report["conv3x3_bias_act"]:
            report["conv3x3_bias_act"].update(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, library_ms=library_ms)
        print(f"kernel vs plain: conv3x3_bias_act {(batch, height, width, cin)} -> {cout}: "
              f"max |diff| {err:.3e}; {flop / 1e9:.3f} GFLOP, kernel {ms:.4f} ms "
              f"({flop / ms / 1e9:.2f} TFLOP/s; bound {bound_ms:.4f} ms, "
              f"{100 * bound_ms / ms:.1f}% of it), plain {plain_ms:.4f} ms "
              f"({flop / plain_ms / 1e9:.2f} TFLOP/s), F.conv2d with bias {library_ms:.4f} ms "
              "(median of 20)")
    return report


def enqueue_without_sync(pipeline, scenes, refine_level=0):
    """Enqueue the device program of a batch under sync debug mode
    "error": any host synchronisation raises."""
    device_batch, _, _, resize_to = pipeline._prepare(scenes)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the debug mode's "prototype" notice
        torch.cuda.set_sync_debug_mode("error")
        try:
            pipeline._launch(
                device_batch, {}, pipeline.word_buckets[0], resize_to,
                pipeline._component_cap, pipeline._num_sweeps, refine_level,
            )
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def time_pipeline(pipeline, scenes, repeats=10):
    """(recognize p50 ms over ``repeats`` images, recognize_many images/s
    on 32 images at batch 8), checking every result."""
    latencies = []
    for image in scenes[:repeats]:
        start = time.perf_counter()
        results = pipeline.recognize([image])
        latencies.append((time.perf_counter() - start) * 1e3)
        check_results(results, 1)
    many = (scenes * 3)[:32]
    check_results(pipeline.recognize_many(many, batch_size=8), len(many))
    start = time.perf_counter()
    results = pipeline.recognize_many(many, batch_size=8)
    images_per_s = len(many) / (time.perf_counter() - start)
    check_results(results, len(many))
    return statistics.median(latencies), images_per_s


def seed_batch_norm(model, seed):
    """Non-trivial BatchNorm statistics (scale 0.5-1.5, shift and mean
    +-0.1, variance 0.5-2), so that a fold has something to fold."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.BatchNorm2d):
                n = module.num_features

                def uniform(low, high):
                    return low + (high - low) * torch.rand(n, generator=gen)

                module.weight.copy_(uniform(0.5, 1.5))
                module.bias.copy_(uniform(-0.1, 0.1))
                module.running_mean.copy_(uniform(-0.1, 0.1))
                module.running_var.copy_(uniform(0.5, 2.0))


def craft_input(pipeline, scenes):
    """The normalised CRAFT input the pipeline makes of ``scenes``."""
    from keras_ocr_tpu_torch.ops.image import compute_input, resize_bilinear

    device_batch, _, _, resize_to = pipeline._prepare(scenes)
    return compute_input(resize_bilinear(device_batch.to(torch.float32), *resize_to))


def split_word(text, link, y, x, left, gap, right, height=8):
    """Two text islands joined by a bridge where text and link both pass
    their thresholds: overlap removal cuts the bridge, and the gap is wider
    than the dilation closes, so the word's dilated segmap is two blobs."""
    text[y : y + height, x : x + left] = 0.95
    text[y : y + height, x + left + gap : x + left + gap + right] = 0.9
    mid = y + height // 2 - 1
    text[mid : mid + 2, x + left : x + left + gap] = 0.45
    link[mid : mid + 2, x + left - 1 : x + left + gap + 1] = 0.5


def refine_heatmaps(seed=0):
    """(8, 480, 640, 2) float32 heatmaps: five seeded split words an image,
    one row band each; image 0 also holds a blob nested in a ring's hole
    (bridged to a far island), and image 1's middle word is 540 columns
    wide, past level 1's 512-column window."""
    batch, height, width = REFINE_SHAPE
    rng = np.random.RandomState(seed)
    maps = np.zeros((batch, height, width, 2), np.float32)
    for b in range(batch):
        text, link = maps[b, ..., 0], maps[b, ..., 1]
        for k in range(5):
            y = 30 + 90 * k
            if b == 1 and k == 2:
                split_word(text, link, y, 40, 250, 40, 250)
                continue
            split_word(text, link, y, rng.randint(10, width - 100), rng.randint(8, 21),
                       rng.randint(14, 31), rng.randint(8, 21))
    text, link = maps[0, 440:, 300:, 0], maps[0, 440:, 300:, 1]
    text[10:30, 10:30] = 0.95
    text[16:24, 16:24] = 0.45
    link[15:25, 15:25] = 0.5
    text[18:22, 18:22] = 0.95
    link[17:23, 17:23] = 0.3
    link[18:22, 18:22] = 0.35
    text[19:21, 30:50] = 0.45
    link[19:21, 29:51] = 0.5
    text[12:28, 50:58] = 0.9
    return maps


class FixedCraft(torch.nn.Module):
    """A CRAFT stand-in returning fixed heatmaps for a batch of the size
    they were made for (inputs twice their height and width)."""

    def __init__(self, heatmaps):
        super().__init__()
        self.heatmaps = heatmaps

    def forward(self, x):
        if x.shape[0] != self.heatmaps.shape[0] or x.shape[1] != 2 * self.heatmaps.shape[1]:
            raise AssertionError(f"stand-in CRAFT got {tuple(x.shape)}")
        return self.heatmaps


def canonical(boxes):
    """Boxes in a fixed order, for comparing two unordered lists."""
    return np.array(sorted(boxes.tolist(), key=lambda b: (np.sum(b), b[0][0])))


def checked_sweeps(cc, cc_cuda, record):
    """Swap the sweep kernel's two entries in ``cc`` for versions that also
    run the plain version on the same tensors and require equal maps and
    flags; ``record`` collects (entry, shape) per call. Returns an undo."""
    saved = cc.segmented_min_sweeps, cc.keyed_rows_cols

    def sweeps(values, barrier, sentinel, num_sweeps, check_convergence=False):
        out = cc_cuda.segmented_min_sweeps(values, barrier, sentinel, num_sweeps,
                                           check_convergence)
        ref = cc_cuda.segmented_min_sweeps_plain(values, barrier, sentinel, num_sweeps,
                                                 check_convergence)
        if check_convergence:
            exact("cc_sweeps on the refine path", out[0], ref[0], out[1], ref[1])
        else:
            exact("cc_sweeps on the refine path", out, ref)
        record.append(("cc_sweeps", tuple(values.shape)))
        return out

    def keyed(values, key, fg, sentinel):
        out = cc_cuda.keyed_rows_cols(values, key, fg, sentinel)
        exact("cc_keyed_rows_cols on the refine path", out,
              cc_cuda.keyed_rows_cols_plain(values, key, fg, sentinel))
        record.append(("cc_keyed_rows_cols", tuple(values.shape)))
        return out

    cc.segmented_min_sweeps, cc.keyed_rows_cols = sweeps, keyed

    def undo():
        cc.segmented_min_sweeps, cc.keyed_rows_cols = saved

    return undo


def device_busy(fn):
    """(device busy ms, of it the sweep kernel's passes, device operations)
    of one call of ``fn``, from ``torch.profiler``: a call that enqueues
    more launches than the device's queue holds makes the host wait, so its
    event time is not its device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sweep = 0.0
    count = 0
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = event.self_device_time_total / 1e3
        busy += ms
        count += event.count
        if "sweep_pass" in event.key:
            sweep += ms
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    return busy, sweep, count


def refine_levels(cc, cc_cuda, postprocess, refine, heatmaps):
    """``get_boxes`` + ``refine_boxes`` at each LADDER level on the card,
    every sweep-kernel call checked; level 1 against the CPU run, levels 2
    and 3 against level 1 where both prove an image. Returns per level
    (enqueue ms, device ms, sweep launches, maps in the window batch)."""
    cpu = heatmaps.cpu()
    analysis = postprocess.component_analysis(heatmaps, 0.7, 0.4, 0.4, 10, 256,
                                              per_component_census=True)
    boxes, _, _ = postprocess.get_boxes(heatmaps, analysis=analysis)
    timings, first = [], None
    for level, (wh, ww, md, it, rc) in enumerate(refine.LADDER, 1):
        settings = dict(refine_cap=rc, window_h=wh, window_w=ww, max_dilate=md, num_iters=it)

        def call():
            return refine.refine_boxes(heatmaps, boxes, analysis=analysis, **settings)

        record = []
        undo = checked_sweeps(cc, cc_cuda, record)
        try:
            out, ok, flagged = (t.cpu() for t in call())
        finally:
            undo()
        if level == 1:
            ref_analysis = postprocess.component_analysis(cpu, 0.7, 0.4, 0.4, 10, 256,
                                                          per_component_census=True)
            ref_boxes, _, _ = postprocess.get_boxes(cpu, analysis=ref_analysis)
            ref = refine.refine_boxes(cpu, ref_boxes, analysis=ref_analysis, **settings)
            if not (torch.equal(ok, ref[1]) and torch.equal(flagged, ref[2])):
                raise AssertionError(f"refine level 1: ok {ok} / {ref[1]}, flagged "
                                     f"{flagged} / {ref[2]} on the card / CPU")
            err = float((out - ref[0]).abs().max())
            if not err <= REFINE_BAR:
                raise AssertionError(f"refine level 1 boxes {err} px from the CPU run")
            if ok.tolist() != [True, False] + [True] * 6:
                raise AssertionError(f"refine level 1 proofs {ok.tolist()}")
            first = out, ok
        else:
            if not bool(ok.all()):
                raise AssertionError(f"refine level {level} proofs {ok.tolist()}")
            both = first[1] & ok
            err = float((out[both] - first[0][both]).abs().max())
            if not err <= REFINE_BAR:
                raise AssertionError(f"refine level {level} boxes {err} px from level 1's")
        if flagged.tolist() != [6] + [5] * 7:
            raise AssertionError(f"refine level {level} flagged {flagged.tolist()}")
        maps = {(math.prod(shape[:-2]),) + shape[-2:] for name, shape in record
                if name == "cc_sweeps"}
        call()
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            launches = cc_cuda.segmented_min_sweeps.launches
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            begin = time.perf_counter()
            start.record()
            call()
            stop.record()
            enqueue_ms = (time.perf_counter() - begin) * 1e3
            torch.cuda.synchronize()
            runs.append((enqueue_ms, start.elapsed_time(stop),
                         cc_cuda.segmented_min_sweeps.launches - launches))
        enqueue_ms, event_ms, launches = (statistics.median(r[i] for r in runs) for i in range(3))
        busy_ms, sweep_ms, ops = device_busy(call)
        timings.append((enqueue_ms, event_ms, busy_ms, sweep_ms, ops, launches, sorted(maps),
                        len(record)))
    return timings


def refine_phase(card, detector, recognizer, scenes):
    """Phase 8; returns the sweep-kernel launches of the refine path."""
    from keras_ocr_tpu_torch import Detector, Pipeline, detection
    from keras_ocr_tpu_torch.ops import cc, cc_cuda, postprocess, refine

    heatmaps = torch.from_numpy(refine_heatmaps()).cuda()
    with torch.inference_mode():
        timings = refine_levels(cc, cc_cuda, postprocess, refine, heatmaps)

    stand_in = Detector(width=0.25, device="cuda")
    stand_in.model = FixedCraft(heatmaps)
    images = [np.zeros((960, 1280, 3), np.uint8)] * REFINE_SHAPE[0]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        found = stand_in.detect(images)
        host = detection.getBoxes(heatmaps.cpu().numpy())
        start = time.perf_counter()
        full = detector.detect(scenes[:8])
        detect_ms = (time.perf_counter() - start) * 1e3
    if caught:
        raise AssertionError(f"Detector.detect warned: {[str(w.message) for w in caught]}")
    for image, (got, want) in enumerate(zip(found, host)):
        if len(got) != len(want):
            raise AssertionError(f"detect image {image}: {len(got)} boxes, oracle {len(want)}")
        err = float(np.abs(canonical(got) - canonical(want)).max())
        if not err <= ORACLE_BAR:
            raise AssertionError(f"detect image {image}: {err} px from the oracle")
    check_results([[("", box) for box in boxes] for boxes in full], 8)

    pipeline = Pipeline(detector=stand_in, recognizer=recognizer, scale=2)
    for level in range(len(refine.LADDER) + 1):
        enqueue_without_sync(pipeline, scenes[:8], refine_level=level)
    relaunch_ms = []
    for level in range(len(refine.LADDER) + 1):
        device_batch, _, _, resize_to = pipeline._prepare(scenes[:8])

        def launch():
            return pipeline._launch(device_batch, {}, pipeline.word_buckets[0], resize_to,
                                    pipeline._component_cap, pipeline._num_sweeps, level).cpu()

        launch()
        runs = []
        for _ in range(3):
            start = time.perf_counter()
            launch()
            runs.append((time.perf_counter() - start) * 1e3)
        relaunch_ms.append(statistics.median(runs))
    for wrapper in (cc_cuda.segmented_min_sweeps, cc_cuda.keyed_rows_cols):
        wrapper.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        start = time.perf_counter()
        results = pipeline.recognize(scenes[:8])
        recognize_ms = (time.perf_counter() - start) * 1e3
    launches = {"cc_sweeps": cc_cuda.segmented_min_sweeps.launches,
                "cc_keyed_rows_cols": cc_cuda.keyed_rows_cols.launches}
    check_results(results, 8)
    stats = pipeline.last_run_stats
    if any("contours[0]" in str(w.message) for w in caught) or stats["refine_escalations"] < 1:
        raise AssertionError(f"the refine ladder did not end clear: {stats}, "
                             f"{[str(w.message) for w in caught]}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the refine path was never launched: {launches}")
    levels = "; ".join(
        f"level {i}: sweep-kernel maps {maps}, host enqueue {enq:.2f} ms, event {event:.2f} ms, "
        f"device busy {busy:.2f} ms of which the sweep kernel {sweep:.2f} ms, {ops} device "
        f"operations, {n} cc_sweeps launches ({calls} checked calls exact)"
        for i, (enq, event, busy, sweep, ops, n, maps, calls) in enumerate(timings, 1)
    )
    print(f"refine ({card}), (8, 480, 640) split-word heatmaps: {levels}; level 1 equal to "
          f"the CPU run, levels 2-3 to level 1; Detector.detect on the stand-in: no host "
          f"fallback, {sum(len(b) for b in found)} boxes within {ORACLE_BAR} px of getBoxes; "
          f"full-width Detector.detect of 8 scenes {detect_ms:.1f} ms, "
          f"{sum(len(b) for b in full)} boxes; pipeline launch + fetch at refine levels "
          f"0-3 {[round(t, 2) for t in relaunch_ms]} ms (median of 3), enqueued without a host "
          f"synchronisation at each; recognize of 8 scenes with the refine ladder "
          f"{recognize_ms:.1f} ms, last_run_stats {stats}; launches on the refine path {launches}")
    return launches


def as_annotations(results, names):
    """Pipeline results of one image a scene -> ``evaluation.score``'s
    image id -> [{"text", "vertices"}]."""
    return {name: [{"text": word, "vertices": box} for word, box in words]
            for name, words in zip(names, results)}


def two_stage_golden(label, pipeline, images, expected, fused, wrappers, pass_fraction):
    """The golden scenes through the two-stage path, the launch counts
    from zero; the word fraction and the score against the fused results
    must reach ``pass_fraction``. Returns the launches and a summary."""
    from keras_ocr_tpu_torch import evaluation
    from keras_ocr_tpu_torch.utils import golden

    for wrapper in wrappers.values():
        wrapper.launches = 0
    results = [pipeline.recognize([image], recognition_kwargs={"verbose": 0})[0]
               for image in images]
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    check_results(results, len(images))
    hits = sum(golden._word_match_fraction(words, [w for w, _ in found]) * len(words)
               for words, found in zip(expected, results))
    n_words = sum(len(words) for words in expected)
    fraction = hits / n_words
    names = [f"scene_{i:02d}" for i in range(len(images))]
    _, (precision, recall) = evaluation.score(as_annotations(fused, names),
                                              as_annotations(results, names))
    same = sum(sorted(w for w, _ in a) == sorted(w for w, _ in b)
               for a, b in zip(results, fused))
    if min(fraction, precision, recall) < pass_fraction:
        raise AssertionError(f"two-stage {label}: fraction {fraction}, precision {precision}, "
                             f"recall {recall} (pass >= {pass_fraction})")
    return launches, (f"{label}: fraction {fraction:.4f} over {n_words} words, "
                      f"score against the fused path precision {precision:.4f} recall "
                      f"{recall:.4f}, same word multiset on {same}/{len(images)} scenes, "
                      f"launches {launches}")


def two_stage_phase(card, golden_images, expected, pipelines, wrappers, pass_fraction,
                    full_pipeline, fused_p50):
    """Phase 9: the two-stage ``recognition_kwargs`` path on the golden
    artifact (unfolded and folded), each run's kernel launches counted from
    zero; the full-width CRNN on the card against the CPU on the slim
    detector's crops; the two-stage p50 at full width and its stage
    split."""
    import copy

    from keras_ocr_tpu_torch import recognition, tools

    lines = []
    for label, pipeline in pipelines:
        fused = [pipeline.recognize([image])[0] for image in golden_images]
        launches, line = two_stage_golden(label, pipeline, golden_images, expected, fused,
                                          wrappers, pass_fraction)
        needed = ("cc_sweeps", "cc_keyed_rows_cols") + (
            ("conv_chain", "conv3x3_bias_act") if "folded" in label else ())
        if min(launches[name] for name in needed) <= 0:
            raise AssertionError(f"two-stage {label} skipped a kernel: {launches}")
        lines.append(line)

    # The full-width CRNN on the card and on the CPU, on the crops of the
    # slim detector's boxes in the golden scenes padded to 640x480.
    slim = pipelines[0][1]
    recognizer = full_pipeline.recognizer

    def host_batch(scene):
        """The two-stage path's host resize and pad of one scene."""
        resized, _, extent = full_pipeline._resize_on_host([scene])
        return full_pipeline._pad_batch(resized, *extent)

    scenes = [tools.pad(image, width=640, height=480) for image in golden_images[:10]]
    batches = [host_batch(scene) for scene in scenes]
    boxes = [slim.detector.detect(images=batch)[0] for batch in batches]
    crops = [tools.warpBox(recognition.rgb_to_grayscale_host(batch[0]), box, 31, 200)
             for batch, image_boxes in zip(batches[:2], boxes[:2]) for box in image_boxes]
    x = torch.from_numpy(np.array(crops, dtype=np.float32)[..., None] / 255)
    cpu_model = copy.deepcopy(recognizer.model).cpu()
    with torch.inference_mode():
        card_probs = recognizer.model(x.cuda()).cpu()
        cpu_probs = cpu_model(x)
    err = check_close("full-width CRNN softmax, card vs CPU", card_probs, cpu_probs, 1e-4)

    # Two-stage p50 at full width, then its stages timed one by one (the
    # crops and the CRNN on the slim detector's boxes: the random-weight
    # CRAFT finds no words).
    latencies, found = [], 0
    full_pipeline.recognize([scenes[0]], recognition_kwargs={"verbose": 0})
    for scene in scenes:
        start = time.perf_counter()
        results = full_pipeline.recognize([scene], recognition_kwargs={"verbose": 0})
        latencies.append((time.perf_counter() - start) * 1e3)
        check_results(results, 1)
        found += len(results[0])
    stages = {"host resize": [], "detect": [], "host crops": [], "CRNN + CTC": []}
    for scene, image_boxes in zip(scenes, boxes):
        start = time.perf_counter()
        batch = host_batch(scene)
        mid = time.perf_counter()
        full_pipeline.detector.detect(images=batch)
        detected = time.perf_counter()
        grey = recognition.rgb_to_grayscale_host(batch[0])
        word_crops = np.array([tools.warpBox(grey, box, 31, 200) for box in image_boxes],
                              dtype=np.float32)[..., None] / 255
        cropped = time.perf_counter()
        recognizer._predict_strings(word_crops)
        done = time.perf_counter()
        for name, (a, b) in zip(stages, ((start, mid), (mid, detected), (detected, cropped),
                                         (cropped, done))):
            stages[name].append((b - a) * 1e3)
    split = ", ".join(f"{name} {statistics.median(ms):.2f}" for name, ms in stages.items())
    print(f"two-stage ({card}): " + "; ".join(lines) + f"; full-width CRNN softmax on "
          f"{len(crops)} crops of 2 scenes within {err:.3e} of the CPU run (bar 1e-4); "
          f"full width (640x480, scale 2) recognize p50 with recognition_kwargs "
          f"{statistics.median(latencies):.2f} ms ({found} words found in 10 scenes), fused "
          f"p50 {fused_p50:.2f} ms; stage medians over 10 scenes, "
          f"{statistics.median(len(b) for b in boxes)} words a scene: {split} ms")


def host_cpu() -> str:
    """The host's CPU model: ``/proc/cpuinfo``, else ``lscpu``, else the
    machine type."""
    with open("/proc/cpuinfo", encoding="utf8") as f:
        for line in f:
            if line.lower().startswith("model name"):
                return line.split(":", 1)[1].strip()
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
    except OSError:
        out = ""
    for line in out.splitlines():
        if line.startswith("Model name:"):
            return line.split(":", 1)[1].strip()
    return f"CPU model not reported ({platform.machine()}, {os.cpu_count()} cores)"


def timed_export(pipeline, path, **kwargs):
    """``pipeline.export(path, **kwargs)``, then ``load_exported``; returns
    the served artifact and (export s, save s, load s), the save timed
    inside the export."""
    from keras_ocr_tpu_torch import load_exported

    save, seconds = torch.export.save, {}

    def timed_save(*args, **save_kwargs):
        start = time.perf_counter()
        save(*args, **save_kwargs)
        seconds["save"] = time.perf_counter() - start

    torch.export.save = timed_save
    try:
        start = time.perf_counter()
        pipeline.export(path, **kwargs)
        total = time.perf_counter() - start
    finally:
        torch.export.save = save
    start = time.perf_counter()
    served = load_exported(path)
    load_s = time.perf_counter() - start
    return served, (total - seconds["save"], seconds["save"], load_s)


def export_summary(served, path, seconds):
    export_s, save_s, load_s = seconds
    return (f"export {export_s:.2f} s, save {save_s:.2f} s, load {load_s:.2f} s, "
            f"{os.path.getsize(path + '.pt2') / 1e6:.2f} MB, "
            f"{len(served._program.graph.nodes)} graph nodes")


def serve_golden(label, pipeline, images, expected, wrappers, pass_fraction):
    """The golden pipeline exported on the card (batch 4), loaded and
    served the scenes, the launch counts from zero over the artifact's
    run; every packed output must equal the live device program's at the
    baked levels and the word fraction reach ``pass_fraction``. Returns the
    launches and a summary."""
    from keras_ocr_tpu_torch.utils import golden

    meta = golden._read_json(ARTIFACT, golden.META_NAME)
    height, width = meta["pad_to"]
    path = os.path.join(SERVING_DIR, label.replace(", ", "_"))
    served, seconds = timed_export(pipeline, path, height=height, width=width, batch_size=4)
    program, runs = served._program, []

    def recorded(batch):
        runs.append((batch, program(batch)))
        return runs[-1][1]

    served._program = recorded
    for wrapper in wrappers.values():
        wrapper.launches = 0
    try:
        results = [words for i in range(0, len(images), 4)
                   for words in served.recognize(images[i : i + 4])]
    finally:
        served._program = program
    launches = {name: wrapper.launches for name, wrapper in wrappers.items()}
    check_results(results, len(images))
    baked = served.meta
    for batch, packed in runs:
        live = pipeline._device_pipeline(
            batch, 0.7, 0.4, 0.4, 10.0, pipeline.detector.max_components, baked["max_words"],
            resize_to=(height * baked["scale"], width * baked["scale"]),
            refine_level=baked["refine_level"], warp_level=baked["warp_level"],
        )
        if not torch.equal(live, packed):
            raise AssertionError(f"{label} artifact: packed output differs from the live "
                                 f"program's by {float((live - packed).abs().max())}")
    hits = sum(golden._word_match_fraction(words, [w for w, _ in found]) * len(words)
               for words, found in zip(expected, results))
    n_words = sum(len(words) for words in expected)
    fraction = hits / n_words
    if fraction < pass_fraction:
        raise AssertionError(f"{label} artifact: fraction {fraction} (pass >= {pass_fraction})")
    return launches, (f"{label} artifact (batch 4, {height}x{width}, refine level "
                      f"{baked['refine_level']}, warp level {baked['warp_level']}): "
                      f"{export_summary(served, path, seconds)}; fraction {fraction:.4f} over "
                      f"{n_words} words, {len(runs)} packed outputs equal to the live program's, "
                      f"launches in the artifact's run {launches}")


def serving_phase(card, golden_images, expected, pipelines, wrappers, pass_fraction,
                  full_pipeline, scenes):
    """Phase 10: the JPEG read, the golden artifacts on both graphs and
    the full-width artifacts at batch 1 and 8 against the live pipeline.
    Returns the launches of the folded golden artifact's run."""
    from keras_ocr_tpu_torch import tools

    decode_ms = []
    for _ in range(5):
        start = time.perf_counter()
        photo = tools.read(SERVING_JPEG)
        decode_ms.append((time.perf_counter() - start) * 1e3)
    digest = hashlib.sha256(photo.tobytes()).hexdigest()
    if photo.shape != (480, 640, 3) or digest != SERVING_JPEG_SHA256:
        raise AssertionError(f"JPEG decode {photo.shape} sha256 {digest}, PIL's is "
                             f"{SERVING_JPEG_SHA256}")
    full_pipeline.recognize([SERVING_JPEG])
    start = time.perf_counter()
    photo_results = full_pipeline.recognize([SERVING_JPEG])
    photo_ms = (time.perf_counter() - start) * 1e3
    check_results(photo_results, 1)
    print(f"serving ({card}): {os.path.relpath(SERVING_JPEG, ROOT)} decoded by path in "
          f"{statistics.median(decode_ms):.2f} ms (median of 5; host CPU {host_cpu()}), "
          f"640x480x3, sha256 equal to PIL's decode; full-width recognize of the path "
          f"{photo_ms:.2f} ms, {len(photo_results[0])} words")

    shutil.rmtree(SERVING_DIR, ignore_errors=True)
    os.makedirs(SERVING_DIR)
    try:
        lines, golden_launches = [], {}
        for label, pipeline in pipelines:
            launches, line = serve_golden(label, pipeline, golden_images, expected, wrappers,
                                          pass_fraction)
            needed = ("cc_sweeps", "cc_keyed_rows_cols") + (
                ("conv_chain", "conv3x3_bias_act") if "folded" in label else ())
            if min(launches[name] for name in needed) <= 0:
                raise AssertionError(f"the {label} artifact skipped a kernel: {launches}")
            golden_launches = launches
            lines.append(line)
        print(f"serving ({card}): " + "; ".join(lines))

        for batch_size, reps in ((1, 10), (8, 5)):
            alone_ms = []
            for rep in range(reps):
                start = time.perf_counter()
                check_results(full_pipeline.recognize((scenes * 2)[rep : rep + batch_size]),
                              batch_size)
                alone_ms.append((time.perf_counter() - start) * 1e3)
            path = os.path.join(SERVING_DIR, f"full_b{batch_size}")
            served, seconds = timed_export(full_pipeline, path, height=480, width=640,
                                           batch_size=batch_size)
            gc.collect()  # the export's traced graphs, before anything is timed
            art_ms, live_ms = [], []
            for rep in range(reps + 1):
                images = (scenes * 2)[rep : rep + batch_size]
                for times, call in ((art_ms, served.recognize), (live_ms, full_pipeline.recognize)):
                    start = time.perf_counter()
                    results = call(images)
                    if rep:  # the first round warms both up
                        times.append((time.perf_counter() - start) * 1e3)
                    check_results(results, batch_size)
            print(f"serving, full width ({card}), 640x480 batch {batch_size}: "
                  f"{export_summary(served, path, seconds)}; recognize p50 (in turns, "
                  f"{reps} each) artifact {statistics.median(art_ms):.2f} ms, live "
                  f"{statistics.median(live_ms):.2f} ms (live before the export "
                  f"{statistics.median(alone_ms):.2f} ms); artifact refine level "
                  f"{served.meta['refine_level']}, warp level {served.meta['warp_level']}")
    finally:
        shutil.rmtree(SERVING_DIR, ignore_errors=True)
    return golden_launches


# Phase 11: training.
TRAIN_LOSS_BAR = 1e-4
# Each gradient leaf of the float64 card step within this share of the
# leaf's largest |g| of the float64 CPU step. In float32 the card's cuDNN
# and CUDA reductions leave its gradients up to ~5e-3 (CRNN) and ~6e-2
# (CRAFT at random init, where the CPU's own float32 step is 4.5e-2 off)
# from the float64 ones, so the float32 gradients are printed, not barred.
TRAIN_GRAD_BAR = 1e-3
# Card leaves whose float64 CPU gradient is rounding noise (zero in exact
# arithmetic: a conv bias a BatchNorm follows) stay below this share of
# the model's largest gradient.
TRAIN_NOISE_BAR = 1e-4
TRAINING_DIR = os.path.join(ROOT, "build", "training")
# Detector width, the (batch, height, width) of the card-vs-CPU CRAFT step
# and of the timed CRAFT steps, and the timed CRNN batches.
TRAIN_CRAFT_WIDTH = 1.0
TRAIN_CRAFT_PARITY = (2, 256, 256)
TRAIN_CRAFT_TIMED = (8, 640, 640)
TRAIN_CRNN_BATCHES = (8, 64)


def tree_leaves(tree, prefix=""):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from tree_leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def gradient_leaves(model, bridge):
    """The model's last gradients as numpy leaves of the JAX tree layout
    (zeros for frozen parameters), through the weight bridge."""
    state = dict(model.state_dict())
    for name, param in model.named_parameters():
        state[name] = param.grad if param.grad is not None else torch.zeros_like(param)
    return dict(tree_leaves(bridge(state)["params"]))


def gradient_errors(model, reference, bridge):
    """({leaf: max|g - g_ref| / max|g_ref|}, the largest |g| of the leaves
    that are rounding noise in the reference, over the reference's largest)."""
    ours, ref = gradient_leaves(model, bridge), gradient_leaves(reference, bridge)
    largest = max(float(np.abs(value).max()) for value in ref.values())
    errors, noise = {}, 0.0
    for path, value in ref.items():
        scale = float(np.abs(value).max())
        if scale <= 1e-9 * largest:
            noise = max(noise, float(np.abs(ours[path]).max()) / largest)
        else:
            errors[path] = float(np.abs(ours[path] - value).max()) / scale
    return errors, noise


def worst(errors):
    leaf = max(errors, key=errors.get)
    return (f"{leaf} at {errors[leaf]:.3e} of its largest |g| "
            f"({sum(e > TRAIN_GRAD_BAR for e in errors.values())}/{len(errors)} leaves over "
            f"{TRAIN_GRAD_BAR})")


def step_parity(what, trainer_cls, make, bridge, batch, **kwargs):
    """One train step from one state on the card and on the CPU, in float32
    and in float64: the float32 losses within TRAIN_LOSS_BAR relative; the
    float64 gradients within TRAIN_GRAD_BAR of each leaf's largest |g|.
    Returns the float32 card trainer (for more steps), its loss and a
    summary with the float32 gradients' distance from the float64 ones."""
    card = make("cuda")
    variables = bridge(card.model)
    cpu, card64, cpu64 = (make(on).load_variables(variables) for on in ("cpu", "cuda", "cpu"))
    for wide in (card64, cpu64):
        wide.model.double()
    trainer = trainer_cls(card, **kwargs)
    loss = trainer.train_step(batch)
    loss_err = loss_parity(what, loss, trainer_cls(cpu, **kwargs).train_step(batch))
    trainer_cls(card64, **kwargs).train_step(batch)
    trainer_cls(cpu64, **kwargs).train_step(batch)
    errors, noise = gradient_errors(card64.model, cpu64.model, bridge)
    if not (max(errors.values()) <= TRAIN_GRAD_BAR and noise <= TRAIN_NOISE_BAR):
        raise AssertionError(f"{what} float64 gradients, card vs CPU: {worst(errors)}; noise "
                             f"leaves {noise:.3e}")
    card32, _ = gradient_errors(card.model, cpu64.model, bridge)
    cpu32, _ = gradient_errors(cpu.model, cpu64.model, bridge)
    summary = (f"loss {loss:.6f} within {loss_err:.3e} relative of the CPU's (bar "
               f"{TRAIN_LOSS_BAR}); float64 gradients, card vs CPU: worst {worst(errors)}, "
               f"noise leaves {noise:.3e} of the largest |g|; float32 gradients against the "
               f"float64 CPU step: card worst {worst(card32)}, CPU worst {worst(cpu32)}")
    return trainer, loss, summary


def loss_parity(what, card_loss, cpu_loss):
    err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    if not err <= TRAIN_LOSS_BAR:
        raise AssertionError(f"{what} loss {card_loss} on the card vs {cpu_loss} on the CPU")
    return err


def crnn_batch(rng, size, frames, alphabet_size, width=200):
    """Random crops and labels of 1-20 characters, as ``get_batch_generator``
    gives them."""
    images = rng.rand(size, 31, width, 1).astype(np.float32)
    label_length = rng.randint(1, min(20, frames) + 1, size=(size, 1))
    labels = np.full((size, frames), -1, np.int64)
    for i, n in enumerate(label_length[:, 0]):
        labels[i, :n] = rng.randint(0, alphabet_size, size=n)
    return ((images, labels, np.full((size, 1), frames, np.float64), label_length),
            np.zeros((size, 1)))


def craft_batch(rng, size, height, width):
    """Normalised random images and maps with a text and a link blob each."""
    images = rng.randn(size, height, width, 3).astype(np.float32)
    targets = (rng.rand(size, height // 2, width // 2, 2) * 0.05).astype(np.float32)
    for i in range(size):
        y, x = rng.randint(0, height // 4, size=2)
        targets[i, y : y + height // 8, x : x + width // 4, 0] = 0.9
        targets[i, y + 2 : y + height // 16, x : x + width // 4, 1] = 0.6
    return images, targets


def text_scenes(rng, height=640, width=640):
    """(image, lines) samples for ``Detector.get_batch_generator``: dark
    character rectangles on a light noisy page, in horizontal lines of
    words separated by spaces."""
    while True:
        image = rng.randint(180, 256, (height, width, 3)).astype(np.uint8)
        lines = []
        for top in range(20, height - 60, 60):
            size = rng.randint(16, 40)
            x, line = rng.randint(0, 40), []
            while x + size < width - 10 and len(line) < 24:
                if line and rng.rand() < 0.15:
                    line.append((np.array([[x, top], [x + size // 2, top],
                                           [x + size // 2, top + size], [x, top + size]],
                                          np.float32), " "))
                    x += size // 2
                    continue
                w = int(size * rng.uniform(0.6, 0.9))
                image[top : top + size, x : x + w] = rng.randint(0, 80)
                line.append((np.array([[x, top], [x + w, top], [x + w, top + size],
                                       [x, top + size]], np.float32), "x"))
                x += w + 2
            lines.append(line)
        yield image, lines


def crop_samples(rng, alphabet):
    """(image, text) samples for ``Recognizer.get_batch_generator``."""
    while True:
        text = "".join(rng.choice(list(alphabet), size=rng.randint(3, 11)))
        yield rng.randint(0, 256, (31, 200, 3)).astype(np.uint8), text


def training_phase(card, golden_images, sweep_wrappers):
    """Phase 11: the full-width train steps on the card held against the
    same steps on the CPU, falling losses, OHEM, step and generator times,
    the CTC loss against ``F.ctc_loss``, ``fit`` with the three callbacks
    and ``save_npz``, and ``Detector.detect`` of the trained detector."""
    from torch.nn import functional as F

    from keras_ocr_tpu_torch import Detector, Recognizer, weights
    from keras_ocr_tpu_torch.models.crnn import DEFAULT_BUILD_PARAMS
    from keras_ocr_tpu_torch.ops.ctc import ctc_loss
    from keras_ocr_tpu_torch.train import DetectorTrainer, RecognizerTrainer, checkpoint
    from keras_ocr_tpu_torch.train.callbacks import CSVLogger, EarlyStopping, ModelCheckpoint

    device = torch.device("cuda")
    rng = np.random.RandomState(11)
    no_dropout = dict(DEFAULT_BUILD_PARAMS, dropout=0.0)

    # (a) One step on the card against the same step on the CPU from one
    # state, then 19 more on the same batch.
    def recognizer_on(on):
        return Recognizer(build_params=no_dropout, device=on, seed=3)

    def detector_on(on):
        return Detector(width=TRAIN_CRAFT_WIDTH, device=on, seed=4)

    frames = 48
    batch = crnn_batch(rng, 8, frames, 36)
    trainer, loss, crnn_summary = step_parity("CRNN", RecognizerTrainer, recognizer_on,
                                              weights.crnn_variables, batch)
    crnn_losses = [loss] + [trainer.train_step(batch) for _ in range(19)]

    images, targets = craft_batch(rng, *TRAIN_CRAFT_PARITY)
    detector_trainer, loss, craft_summary = step_parity(
        "CRAFT", DetectorTrainer, detector_on, weights.craft_variables, (images, targets))
    detector = detector_trainer.detector
    craft_losses = [loss] + [detector_trainer.train_step((images, targets)) for _ in range(19)]
    ohem_loss = DetectorTrainer(Detector(width=TRAIN_CRAFT_WIDTH, device=device, seed=5),
                                loss="ohem").train_step((images, targets))
    for what, series in (("CRNN", crnn_losses), ("CRAFT", craft_losses)):
        if not (np.isfinite(series).all() and series[-1] < series[0]):
            raise AssertionError(f"{what} loss on a fixed batch did not fall: {series}")
    if not np.isfinite(ohem_loss):
        raise AssertionError(f"OHEM loss {ohem_loss}")
    print(f"training ({card}), card vs CPU from one state: full-width CRNN (31x200, filters "
          f"64..512, STN at its identity start, dropout 0) batch 8: {crnn_summary}")
    print(f"training ({card}), card vs CPU from one state: CRAFT width {TRAIN_CRAFT_WIDTH}, "
          f"{'x'.join(map(str, TRAIN_CRAFT_PARITY))}: {craft_summary}")
    print(f"training ({card}), 20 steps on a fixed batch: CRNN (RMSprop 1e-3) "
          f"{crnn_losses[0]:.4f} -> {crnn_losses[-1]:.4f}; CRAFT (Adam 1e-3, MSE) "
          f"{craft_losses[0]:.6f} -> {craft_losses[-1]:.6f}; OHEM step loss {ohem_loss:.6f}")

    # (b) Times: CUDA events around whole train steps (upload, forward,
    # backward, optimiser, loss fetch), medians of 10 after a warm-up.
    timing = Recognizer(device=device, seed=6)  # dropout 0.25, as trained
    timing_trainer = RecognizerTrainer(timing)
    if timing.max_string_length() != frames:
        raise AssertionError(f"{timing.max_string_length()} CTC frames, not {frames}")
    step_ms = {}
    for size in TRAIN_CRNN_BATCHES:
        batch = crnn_batch(rng, size, frames, len(timing.alphabet))
        step_ms["crnn", size] = cuda_median_ms(lambda: timing_trainer.train_step(batch),
                                               runs=10)
    size_craft, height, width = TRAIN_CRAFT_TIMED
    generator = detector.get_batch_generator(text_scenes(rng, height, width),
                                             batch_size=size_craft)
    batches, generator_ms = [], []
    for _ in range(3):
        start = time.perf_counter()
        batches.append(next(generator))
        generator_ms.append((time.perf_counter() - start) * 1e3)
    turn = iter(range(1 << 30))
    torch.cuda.reset_peak_memory_stats()
    step_ms["craft"] = cuda_median_ms(
        lambda: detector_trainer.train_step(batches[next(turn) % len(batches)]), runs=10)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # Forwards alone, in training mode with autograd recording, and the
    # CTC loss forward + backward against F.ctc_loss at each CRNN batch.
    forward_ms = {}
    dropout_masks = torch.Generator(device="cuda").manual_seed(8)
    timing.model.train()
    for size in TRAIN_CRNN_BATCHES:
        x = torch.rand((size, 31, 200, 1), device=device)
        forward_ms["crnn", size] = cuda_median_ms(
            lambda: timing.model(x, return_logits=True, generator=dropout_masks), runs=10)
    timing.model.eval()
    x = torch.randn((size_craft, height, width, 3), device=device)
    detector.model.train()
    forward_ms["craft"] = cuda_median_ms(lambda: detector.model(x), runs=10)
    detector.model.eval()
    del x

    ctc_ms, library_ms, ctc_err = {}, {}, 0.0
    for ctc_batch in TRAIN_CRNN_BATCHES:
        logits = torch.randn((ctc_batch, frames, len(timing.alphabet) + 1), device=device,
                             generator=torch.Generator(device="cuda").manual_seed(7))
        _, labels, input_length, label_length = [
            torch.as_tensor(a, device=device)
            for a in crnn_batch(rng, ctc_batch, frames, 36)[0]]
        input_length = input_length.to(torch.int64).reshape(-1)
        label_length = label_length.reshape(-1)

        def port_ctc():
            x = logits.detach().requires_grad_()
            loss = ctc_loss(x, labels, input_length, label_length)
            loss.sum().backward()
            return loss.detach()

        def library_ctc():
            x = logits.detach().requires_grad_()
            loss = F.ctc_loss(torch.log_softmax(x, -1).transpose(0, 1), labels.clamp(min=0),
                              input_length, label_length, blank=logits.shape[-1] - 1,
                              reduction="none")
            loss.sum().backward()
            return loss.detach()

        ctc_err = max(ctc_err, float(((port_ctc() - library_ctc()).abs()
                                      / library_ctc().abs()).max()))
        ctc_ms[ctc_batch] = cuda_median_ms(port_ctc, runs=10)
        library_ms[ctc_batch] = cuda_median_ms(library_ctc, runs=10)
    if not ctc_err <= TRAIN_LOSS_BAR:
        raise AssertionError(f"ctc_loss vs F.ctc_loss: {ctc_err}")
    crnn_ms = ", ".join(f"batch {b} {step_ms['crnn', b]:.3f} ms (forward "
                        f"{forward_ms['crnn', b]:.3f}, CTC forward + backward {ctc_ms[b]:.3f} "
                        f"vs F.ctc_loss {library_ms[b]:.3f})" for b in TRAIN_CRNN_BATCHES)
    print(f"training ({card}): train step, median of 10: CRNN {crnn_ms}; CRAFT "
          f"{height}x{width} batch {size_craft} (get_batch_generator batches) "
          f"{step_ms['craft']:.3f} ms (forward {forward_ms['craft']:.3f}), peak memory "
          f"{peak_gb:.3f} GB; one generator batch of {size_craft} (compute_maps on the host) "
          f"{statistics.median(generator_ms):.2f} ms (median of 3; host CPU {host_cpu()}); "
          f"the port's CTC losses within {ctc_err:.3e} relative of F.ctc_loss")

    # (c) fit with the three callbacks, then save_npz.
    shutil.rmtree(TRAINING_DIR, ignore_errors=True)
    try:
        log = os.path.join(TRAINING_DIR, "log.csv")
        os.makedirs(TRAINING_DIR)
        history = timing_trainer.fit(
            timing.get_batch_generator(crop_samples(rng, timing.alphabet), batch_size=8),
            steps_per_epoch=2, epochs=2, seed=1, callbacks=[
                EarlyStopping(restore_best_weights=True),
                ModelCheckpoint(os.path.join(TRAINING_DIR, "best")), CSVLogger(log)])
        path = checkpoint.save_npz(os.path.join(TRAINING_DIR, "recognizer.npz"),
                                   timing_trainer.variables)
        with open(log) as f:
            rows = len(f.read().strip().splitlines())
        restored = dict(tree_leaves(checkpoint.restore_npz(path)))
        if (len(history) != 2 or rows != 3 or timing.model.training
                or not os.path.isfile(os.path.join(TRAINING_DIR, "best.npz"))
                or not all(np.array_equal(restored[k], v)
                           for k, v in tree_leaves(timing_trainer.variables))):
            raise AssertionError(f"fit: history {history}, {rows} CSV rows")
        print(f"training ({card}): fit 2 epochs x 2 steps (batch 8, EarlyStopping, "
              f"ModelCheckpoint, CSVLogger): epoch losses {[round(h, 4) for h in history]}; "
              f"save_npz {os.path.getsize(path) / 1e6:.2f} MB, restored equal")
    finally:
        shutil.rmtree(TRAINING_DIR, ignore_errors=True)

    # (d) The trained detector reads a golden scene through the sweep kernel.
    for wrapper in sweep_wrappers.values():
        wrapper.launches = 0
    boxes = detector.detect([golden_images[0]])
    launches = {name: wrapper.launches for name, wrapper in sweep_wrappers.items()}
    if len(boxes) != 1 or min(launches.values()) <= 0:
        raise AssertionError(f"trained detector's detect: {len(boxes)} results, {launches}")
    print(f"training ({card}): Detector.detect of the trained detector on one golden scene: "
          f"{len(boxes[0])} boxes, launches {launches}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from keras_ocr_tpu_torch import Detector, Pipeline, Recognizer, kernels, tools
    from keras_ocr_tpu_torch.models.craft import fold_bn_state_dict
    from keras_ocr_tpu_torch.ops import cc_cuda, conv_cuda
    from keras_ocr_tpu_torch.utils import golden

    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(f"environment: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    def build(source):
        start = time.perf_counter()
        kernels.load(source)
        return time.perf_counter() - start

    sources = (cc_cuda.SOURCE, conv_cuda.SOURCE)
    start = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        build_s = list(pool.map(build, sources))
    print("build: " + ", ".join(f"{s} in {t:.2f} s" for s, t in zip(sources, build_s))
          + f" (together {time.perf_counter() - start:.2f} s)")

    report = kernel_phase(cc_cuda)
    with open(os.path.join(ARTIFACT, "expected.json"), encoding="utf8") as f:
        golden_scenes = json.load(f)["scenes"]
    names = [entry["image"] for entry in golden_scenes]
    golden_images = [tools.read(os.path.join(ARTIFACT, name)) for name in names]
    golden_pipeline = golden.load_golden_pipeline(ARTIFACT, device=device)[0]
    golden_traffic(cc_cuda, golden_pipeline, golden_images[:8])
    report.update(conv_phase(conv_cuda))
    sweep_wrappers = {
        "cc_sweeps": cc_cuda.segmented_min_sweeps,
        "cc_keyed_rows_cols": cc_cuda.keyed_rows_cols,
    }
    conv_wrappers = {
        "conv_chain": conv_cuda.conv_chain,
        "conv3x3_bias_act": conv_cuda.conv3x3_bias_act,
    }
    all_wrappers = {**sweep_wrappers, **conv_wrappers}
    with open(os.path.join(ARTIFACT, "meta.json"), encoding="utf8") as f:
        pass_fraction = json.load(f)["pass_fraction"]

    def golden_phase(label, pipeline):
        result = golden.run_golden_check(ARTIFACT, pipeline=pipeline)
        print(f"{label}: fraction {result['fraction']} over {result['n_words']} words / "
              f"{result['n_scenes']} scenes (pass >= {pass_fraction}); last_run_stats "
              f"{result['run_stats']}")
        if not result["pass"]:
            raise AssertionError(f"{label} check failed: {result}")

    # The default path (BatchNorm unfolded, cuDNN): count its launches.
    for wrapper in all_wrappers.values():
        wrapper.launches = 0
    golden_phase("golden", golden_pipeline)
    detector = Detector(width=1.0, device=device, seed=0)
    recognizer = Recognizer(device=device, seed=1)
    pipeline = Pipeline(detector=detector, recognizer=recognizer, scale=2)
    scenes = [tools.pad(image, width=640, height=480) for image in golden_images]
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        check_results(pipeline.recognize([scenes[0]]), 1)
    # The device program must not make the host wait: only the fetch does.
    enqueue_without_sync(pipeline, scenes[:8])
    p50, images_per_s = time_pipeline(pipeline, scenes)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: wrapper.launches for name, wrapper in sweep_wrappers.items()}
    print(f"full width ({card}): device program of 8 images enqueued with no host "
          f"synchronisation (torch.cuda sync debug mode 'error'); recognize p50 "
          f"{p50:.2f} ms (640x480, scale 2, 10 images), recognize_many {images_per_s:.2f} images/s "
          f"(32 images, batch 8), peak memory {peak_gb:.3f} GB; last_run_stats "
          f"{pipeline.last_run_stats}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was never launched: {launches}")

    # The folded path (BatchNorm folded, the conv kernel): count its launches.
    for wrapper in all_wrappers.values():
        wrapper.launches = 0
    golden_folded = golden.load_golden_pipeline(ARTIFACT, device=device, fold_bn=True)[0]
    golden_phase("golden, folded", golden_folded)
    golden_launches = {name: w.launches for name, w in conv_wrappers.items()}
    if min(golden_launches.values()) <= 0:
        raise AssertionError(f"the folded golden path skipped a conv kernel: {golden_launches}")
    seed_batch_norm(detector.model, seed=2)
    folded = Detector(width=1.0, fold_bn=True, device=device)
    folded.model.load_state_dict(fold_bn_state_dict(detector.model.state_dict()))
    folded_pipeline = Pipeline(detector=folded, recognizer=recognizer, scale=2)
    with torch.inference_mode():
        x = craft_input(pipeline, scenes[:2])
        ref = detector.model(x)
        err = check_close("folded heatmaps", folded.model(x), ref, HEATMAP_BAR)
    print(f"full width, folded: heatmaps of 2 scenes (960x1280 input) within {err:.3e} "
          f"of the unfolded cuDNN graph (max|ref| {float(ref.abs().max()):.3e}; bar "
          f"{HEATMAP_BAR} * max(1, max|ref|))")
    enqueue_without_sync(folded_pipeline, scenes[:8])
    times = {}
    for label, pipe in (("unfolded", pipeline), ("folded", folded_pipeline)):
        check_results(pipe.recognize([scenes[0]]), 1)
        times[label] = time_pipeline(pipe, scenes)
    launches.update({name: w.launches for name, w in conv_wrappers.items()})
    print(f"full width, folded ({card}): device program of 8 images enqueued with no "
          f"host synchronisation; recognize p50 {times['folded'][0]:.2f} ms folded vs "
          f"{times['unfolded'][0]:.2f} ms unfolded, recognize_many "
          f"{times['folded'][1]:.2f} vs {times['unfolded'][1]:.2f} images/s (seeded BN "
          f"statistics); launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was never launched: {launches}")

    forward_ms = {}
    with torch.inference_mode():
        for batch, runs in ((1, 20), (8, 5)):
            x = torch.randn((batch, 960, 1280, 3), generator=torch.Generator(
                device="cuda").manual_seed(batch), device="cuda")
            for label, model in (("unfolded", detector.model), ("folded", folded.model)):
                forward_ms[label, batch] = cuda_median_ms(lambda: model(x), runs=runs)
    print(f"CRAFT forward ({card}), 960x1280: batch 1 unfolded (cuDNN) "
          f"{forward_ms['unfolded', 1]:.3f} ms, folded (conv kernel) "
          f"{forward_ms['folded', 1]:.3f} ms; batch 8 {forward_ms['unfolded', 8]:.3f} ms "
          f"vs {forward_ms['folded', 8]:.3f} ms (median of 20 / 5)")

    refine_phase(card, detector, recognizer, scenes)

    expected = [entry["words"] for entry in golden_scenes]
    two_stage_phase(card, golden_images, expected,
                    (("golden", golden_pipeline), ("golden, folded", golden_folded)),
                    all_wrappers, pass_fraction, pipeline, p50)

    serving_phase(card, golden_images, expected,
                  (("golden", golden_pipeline), ("golden, folded", golden_folded)),
                  all_wrappers, pass_fraction, pipeline, scenes)

    training_phase(card, golden_images, sweep_wrappers)

    replaces = {
        "cc_sweeps": "keras_ocr_tpu/ops/cc_pallas.py:82",
        # An XLA loop in the JAX package, not a Pallas kernel.
        "cc_keyed_rows_cols": "keras_ocr_tpu/ops/cc.py:210",
        "conv_chain": "keras_ocr_tpu/ops/conv_pallas.py:141",
        "conv3x3_bias_act": "keras_ocr_tpu/ops/conv_pallas.py:302",
    }
    sources = {
        "cc_sweeps": cc_cuda.SOURCE, "cc_keyed_rows_cols": cc_cuda.SOURCE,
        "conv_chain": conv_cuda.SOURCE, "conv3x3_bias_act": conv_cuda.SOURCE,
    }
    print(card)
    print(json.dumps({"kernels": [
        {
            "name": name,
            "op": f"keras_ocr_tpu_torch::{OPS[name]}",
            "route": "cuda",
            "source": f"keras_ocr_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name],
            "launches": launches[name],
            **{key: report[name][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        }
        for name in all_wrappers
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
