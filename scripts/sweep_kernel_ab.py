"""Time the label-sweep kernel of this checkout, and of another, on one GPU.

    python3 scripts/sweep_kernel_ab.py [--parent DIR] [--rounds N]

At (8, 480, 640), on the seeded masks of ``chip_smoke.py``, both entries of
the sweep kernel (8 sweeps + check; one keyed row and column pass) are held
exact against their plain versions, then timed: the median of 20 calls by
CUDA events, the device time of each kernel launched in one call
(``profile_torch_pipeline.device_kernels``), and the host time to enqueue
one call. With ``--parent DIR`` (a checkout of an earlier commit), the same
runs with that checkout's package, in turns (this, parent, parent, this)
per round, each in a process of its own, for a comparison on one card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (8, 480, 640)


def host_us(fn, calls=50):
    """Host time to enqueue one call, in microseconds (no synchronisation
    inside the window)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def measure(package):
    """Exactness and times of both entries with ``package``'s kernel."""
    sys.path.insert(0, package)
    import torch
    from keras_ocr_tpu_torch.ops import cc_cuda

    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke
    from profile_torch_pipeline import device_kernels

    if not cc_cuda.__file__.startswith(os.path.abspath(package)):
        raise RuntimeError(f"imported {cc_cuda.__file__}, not the package in {package}")
    fg, values, sentinel = chip_smoke.sweep_inputs(*SHAPE)
    barrier = torch.from_numpy(~fg).cuda()
    keyed = chip_smoke.keyed_inputs(*SHAPE)
    calls = {
        "cc_sweeps": lambda: cc_cuda.segmented_min_sweeps(values, barrier, sentinel, 8, True),
        "cc_keyed_rows_cols": lambda: cc_cuda.keyed_rows_cols(*keyed),
    }
    out, conv = calls["cc_sweeps"]()
    ref, ref_conv = cc_cuda.segmented_min_sweeps_plain(values, barrier, sentinel, 8, True)
    chip_smoke.exact("cc_sweeps", out, ref, conv, ref_conv)
    chip_smoke.exact("cc_keyed_rows_cols", calls["cc_keyed_rows_cols"](),
                     cc_cuda.keyed_rows_cols_plain(*keyed))
    for name, call in calls.items():
        ms = chip_smoke.cuda_median_ms(call)
        kernels = device_kernels(call)
        device = sum(t for t, _ in kernels.values())
        parts = ", ".join(f"{key[:40]} {n} x {1e3 * t / n:.2f} us"
                          for key, (t, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0]))
        print(f"{package}: {name} {SHAPE} exact: {ms:.4f} ms (median of 20); device "
              f"{device:.4f} ms per call ({parts}); host enqueue {host_us(call):.1f} us per call",
              flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="a checkout of an earlier commit")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--package", help=argparse.SUPPRESS)  # one run, in this process
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sweep_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.package:
        measure(args.package)
        return 0
    sys.path.insert(0, ROOT)
    import chip_smoke

    print(chip_smoke.card_line(), flush=True)
    order = [ROOT, os.path.abspath(args.parent)] if args.parent else [ROOT]
    for _ in range(args.rounds):
        for package in order + order[::-1]:
            subprocess.run([sys.executable, os.path.abspath(__file__), "--package", package],
                           check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
