"""Time the conv kernel of this checkout, and of another, on one GPU.

    python3 scripts/conv_kernel_ab.py [--parent DIR] [--rounds N] [--dtypes bfloat16,float32]
    python3 scripts/conv_kernel_ab.py --only DIR     # one checkout's package alone
    python3 scripts/conv_kernel_ab.py --tiles        # this checkout's bf16 tile table

On the 12 CRAFT chains of a 960x1280 forward (``chip_smoke.CRAFT_CHAINS``,
the seeded inputs of ``chip_smoke.seeded_chain``) and on C3's first layer
alone, (1, 240, 320, 128) -> 256, each conv wrapper is held to its plain
version (``chip_smoke.check_bf16`` in bfloat16, ``check_close`` at 1e-4 in
float32), then timed three ways: the median of 20 calls by CUDA events (the
call's time, wrapper included), the device time of the conv kernel's own
launches in one call and of every other kernel the call launches (weight
copies and casts, the im2col), from ``torch.profiler``
(``chip_smoke.conv_device_ms``), and the host time to enqueue one
call, and the device time of one call replayed from a CUDA graph (its
kernels back to back). C3's layer is also timed as one cuDNN ``F.conv2d``
with bias in the same dtype. The same weight tensors are passed on every call, as the folded
CRAFT passes its cached ones.

With ``--parent DIR`` (a checkout of an earlier commit, e.g. ``git archive``
unpacked under ``build/``), both packages run in turns (this, parent,
parent, this) per round, each in a process of its own, for a comparison on
one card. Each run ends with one JSON line of its numbers.

With ``--tiles``, every bf16 layer of the 12 chains is launched straight
through ``conv_layer_bf16`` at each Cout tile and K slab it could take
(the narrowest tile that holds Cout, 64, 128 and, for Cout >= 256, 256;
the narrowest slab and 64), held within one bf16 ulp of the plain layer
and timed (median of 20 by CUDA events): the data behind ``tile_n`` and
``slab_channels``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from sweep_kernel_ab import host_us

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C3_LAYER = (1, 240, 320, 128, 256)


def measure(package, dtypes):
    """The conv wrappers of ``package`` on the CRAFT chains, per dtype."""
    sys.path.insert(0, package)
    import torch
    from keras_ocr_tpu_torch.ops import conv_cuda

    sys.path.insert(0, ROOT)
    import chip_smoke

    if not conv_cuda.__file__.startswith(os.path.abspath(package)):
        raise RuntimeError(f"imported {conv_cuda.__file__}, not the package in {package}")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    summary = {"package": package, "card": chip_smoke.card_line()}
    for dtype_name in dtypes:
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device="cuda").manual_seed(15)
        chains, total = {}, [0.0, 0.0, 0.0, 0.0]
        for name, height, width, cin, plan, pool, tap in chip_smoke.CRAFT_CHAINS:
            x, convs = chip_smoke.seeded_chain(gen, 1, height, width, cin, plan)
            x = x.to(dtype)

            def call():
                return conv_cuda.conv_chain(x, convs, pool=pool, tap_prepool=tap)

            out = call()
            ref = conv_cuda.conv_chain_plain(x, convs, pool=pool, tap_prepool=tap)
            torch.cuda.synchronize()
            for o, r in zip(out, ref) if tap else [(out, ref)]:
                if dtype == torch.bfloat16:
                    chip_smoke.check_bf16(conv_cuda, f"{name}", o, r, len(plan))
                else:
                    chip_smoke.check_close(f"{name}", o, r, chip_smoke.CONV_BAR)
            ms = chip_smoke.cuda_median_ms(call)
            conv_ms, other_ms, seen = chip_smoke.conv_device_ms(call)
            replay = chip_smoke.graph_replay_ms(call)
            host = host_us(call)
            flop = chip_smoke.conv_flop(1, height, width, cin, plan)
            chains[name] = {"ms": ms, "kernel_ms": conv_ms, "other_ms": other_ms,
                            "launches_seen": seen, "graph_ms": replay, "host_us": host}
            total[0] += ms
            total[1] += conv_ms
            total[2] += other_ms
            total[3] += replay or 0.0
            print(f"{package} {dtype_name}: {name}: call {ms:.4f} ms, conv kernel "
                  f"{conv_ms:.4f} ms ({seen:g} of {len(plan)} launches seen; "
                  f"{flop / max(conv_ms, 1e-9) / 1e9:.1f} TFLOP/s), other kernels "
                  f"{other_ms:.4f} ms, graph replay {replay} ms, host enqueue {host:.1f} us",
                  flush=True)
        batch, height, width, cin, cout = C3_LAYER
        x, ((w, b, _),) = chip_smoke.seeded_chain(gen, batch, height, width, cin,
                                                  ((3, cout, True),))
        x = x.to(dtype)
        if dtype == torch.bfloat16:
            chip_smoke.check_bf16(conv_cuda, "C3 layer", conv_cuda.conv3x3_bias_act(x, w, b),
                                  conv_cuda.conv3x3_bias_act_plain(x, w, b), 1)
        else:
            chip_smoke.check_close("C3 layer", conv_cuda.conv3x3_bias_act(x, w, b),
                                   conv_cuda.conv3x3_bias_act_plain(x, w, b), chip_smoke.CONV_BAR)

        def layer():
            return conv_cuda.conv3x3_bias_act(x, w, b)

        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous().to(dtype)
        b_lib = b.to(dtype)
        library_ms = chip_smoke.cuda_median_ms(
            lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, b_lib, padding=1))
        ms = chip_smoke.cuda_median_ms(layer)
        conv_ms, other_ms, _ = chip_smoke.conv_device_ms(layer)
        replay = chip_smoke.graph_replay_ms(layer)
        host = host_us(layer)
        print(f"{package} {dtype_name}: C3 layer {C3_LAYER}: call {ms:.4f} ms, conv kernel "
              f"{conv_ms:.4f} ms, other kernels {other_ms:.4f} ms, graph replay {replay} ms, "
              f"host enqueue {host:.1f} us; cuDNN F.conv2d with bias {library_ms:.4f} ms; the "
              f"12 chains: call {total[0]:.4f} ms, conv kernel {total[1]:.4f} ms, other kernels "
              f"{total[2]:.4f} ms, graph replay {total[3]:.4f} ms", flush=True)
        summary[dtype_name] = {
            "chains": chains, "chains_ms": total[0], "chains_kernel_ms": total[1],
            "chains_other_ms": total[2], "chains_graph_ms": total[3],
            "c3": {"ms": ms, "kernel_ms": conv_ms, "other_ms": other_ms, "graph_ms": replay,
                   "host_us": host, "library_ms": library_ms}}
    print(json.dumps(summary), flush=True)


def tile_table():
    """Each bf16 CRAFT layer at each Cout tile and slab it could take."""
    sys.path.insert(0, ROOT)
    import torch
    from keras_ocr_tpu_torch.ops import conv_cuda

    import chip_smoke

    lib = conv_cuda._library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(15)
    bf16 = torch.bfloat16
    rows = []
    for name, height, width, cin, plan, pool, _ in chip_smoke.CRAFT_CHAINS:
        x, convs = chip_smoke.seeded_chain(gen, 1, height, width, cin, plan)
        x = x.to(bf16)
        for i, (w, b, relu) in enumerate(convs):
            last_pooled = pool and i == len(convs) - 1
            cin_now, cout = w.shape[2], w.shape[3]
            ref = conv_cuda.conv_chain_plain(x, [(w, b, relu)], pool=last_pooled)
            out = torch.empty_like(ref)
            xk, wmat, k, cin_pad = conv_cuda.kernel_operands(x, w)
            variants = {"": (xk, wmat, k, cin_pad)}
            if conv_cuda.uses_im2col(w.shape[0], cin_now, bf16):
                # The same layer without the im2col: 3x3 on Cin padded to 8.
                variants[" direct"] = (conv_cuda._aligned(conv_cuda.pad_channels(x, 8)),
                                       conv_cuda._aligned(conv_cuda.kmajor_weights(w, 8).to(bf16)),
                                       3, 8)
            chosen = (conv_cuda.tile_n(cout, conv_cuda.tiles_m(1, height, width), bf16, sms),
                      conv_cuda.slab_channels(cin_pad, bf16))
            narrow = conv_cuda.tile_n(cout)
            tiles = sorted({narrow, *(n for n in (64, 128) if n >= narrow)}
                           | ({256} if cout >= 256 else set()))
            times = {}
            for label, (xv, wv, kv, cv) in variants.items():
                for bn in tiles:
                    for slab in sorted({conv_cuda.slab_channels(cv, bf16), 64}):
                        def launch():
                            rc = lib.conv_layer_bf16(
                                xv.data_ptr(), wv.data_ptr(), b.data_ptr(), out.data_ptr(), None,
                                1, height, width, cv, cout, kv, int(relu), int(last_pooled),
                                bn, slab, sms, stream)
                            if rc != 0:
                                raise RuntimeError(f"conv_layer_bf16 returned {rc}")

                        out.fill_(float("nan"))
                        launch()
                        torch.cuda.synchronize()
                        chip_smoke.check_bf16(conv_cuda, f"{name} {i}{label} bn {bn} slab {slab}",
                                              out, ref, 1)
                        times[f"bn {bn} slab {slab}{label}"] = chip_smoke.cuda_median_ms(launch)
            extra = ""
            if len(variants) > 1:
                extra = f"; im2col of the input {chip_smoke.cuda_median_ms(lambda: conv_cuda.im2col(x)):.4f} ms"
            best = min(times, key=times.get)
            flop = chip_smoke.conv_flop(1, height, width, cin_now, ((w.shape[0], cout, relu),))
            print(f"{name} layer {i} ({w.shape[0]}x{w.shape[0]}, {cin_now} -> {cout}, "
                  f"{height}x{width}): " + ", ".join(
                      f"{key} {ms:.4f} ms ({flop / ms / 1e9:.0f} TFLOP/s)"
                      for key, ms in times.items())
                  + f"{extra}; chosen bn {chosen[0]} slab {chosen[1]}, fastest {best}", flush=True)
            rows.append({"layer": f"{name} {i}", "chosen": list(chosen), "fastest": best,
                         "ms": times})
            x = ref
    print(json.dumps({"tiles": rows}), flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="a checkout of an earlier commit")
    parser.add_argument("--only", help="measure this checkout's package alone")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--tiles", action="store_true", help="the bf16 tile table")
    parser.add_argument("--dtypes", default="bfloat16,float32")
    parser.add_argument("--package", help=argparse.SUPPRESS)  # one run, in this process
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("conv_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    dtypes = args.dtypes.split(",")
    if args.package:
        measure(args.package, dtypes)
        return 0
    if args.tiles:
        tile_table()
        return 0
    sys.path.insert(0, ROOT)
    import chip_smoke

    print(chip_smoke.card_line(), flush=True)
    if args.only:
        order = [os.path.abspath(args.only)]
    else:
        order = [ROOT, os.path.abspath(args.parent)] if args.parent else [ROOT]
    for _ in range(args.rounds):
        for package in order + order[::-1] if len(order) > 1 else order:
            subprocess.run([sys.executable, os.path.abspath(__file__), "--package", package,
                            "--dtypes", args.dtypes], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
