"""The connected-component sweep kernel and its plain PyTorch versions.

Counterpart of ``keras_ocr_tpu/ops/cc_pallas.py``. On the card,
:func:`segmented_min_sweeps` launches the hand-written CUDA kernel
``csrc/cc_sweeps.cu`` (one launch per row or column pass, batched over
images), as the op ``torch.ops.keras_ocr_tpu_torch.cc_sweeps``. For tensors
on the CPU the op runs :func:`segmented_min_sweeps_plain`,
the shift-doubling form of ``keras_ocr_tpu/ops/cc.py:segmented_min_sweeps``
written in PyTorch, which computes the same values.

:func:`keyed_rows_cols` is the same kernel in its keyed mode: the row then
column passes of ``keras_ocr_tpu/ops/cc.py:label_blobs_keyed``'s sweep,
with :func:`keyed_rows_cols_plain` (``_keyed_run_min`` twice) for the CPU,
as the op ``cc_keyed_rows_cols``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

SOURCE = "cc_sweeps.cu"


def _shift(arr, distance, dim, reverse, fill):
    """Bring the element ``distance`` positions behind (ahead if reverse)."""
    size = arr.shape[dim]
    pad_shape = list(arr.shape)
    pad_shape[dim] = min(distance, size)
    pad = torch.full(pad_shape, fill, dtype=arr.dtype, device=arr.device)
    if distance >= size:
        return pad
    if reverse:
        return torch.cat([arr.narrow(dim, distance, size - distance), pad], dim)
    return torch.cat([pad, arr.narrow(dim, 0, size - distance)], dim)


def segmented_min_sweeps_plain(
    values, barrier, sentinel, num_sweeps, check_convergence=False
):
    """Shift-doubling sweeps on (..., H, W) int32 tensors (see
    :func:`segmented_min_sweeps`)."""
    barrier = barrier.to(torch.int32)

    def segmented_min(v, dim, reverse):
        f = barrier
        distance = 1
        size = v.shape[dim]
        while distance < size:
            vs = _shift(v, distance, dim, reverse, sentinel)
            fs = _shift(f, distance, dim, reverse, 1)
            v = torch.where(f == 0, torch.minimum(v, vs), v)
            f = torch.maximum(f, fs)
            distance *= 2
        return v

    def run_min(lab, dim):
        best = torch.minimum(
            segmented_min(lab, dim, False), segmented_min(lab, dim, True)
        )
        return torch.where(barrier == 1, torch.full_like(best, sentinel), best)

    def sweep(lab):
        return run_min(run_min(lab, -1), -2)

    out = values
    for _ in range(num_sweeps):
        out = sweep(out)
    if check_convergence:
        final = sweep(out)
        return final, (final == out).flatten(-2).all(-1)
    return out


def _library():
    lib = kernels.load(SOURCE)
    pointer, number = ctypes.c_void_p, ctypes.c_int
    lib.cc_sweeps.argtypes = [pointer] * 3 + [number] * 6 + [pointer] * 2
    lib.cc_sweeps.restype = number
    lib.cc_keyed_rows_cols.argtypes = [pointer] * 4 + [number] * 4 + [pointer]
    lib.cc_keyed_rows_cols.restype = number
    lib.cc_sweeps_max_line.restype = number
    lib.cc_sweeps_max_batch.restype = number
    return lib


def _check(values, *planes):
    """Validate (..., H, W) int32 CUDA ``values`` and same-shape bool or
    integer planes (other devices raise); shapes and dtypes only, so that it
    traces."""
    if values.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {values.device}")
    if values.dtype != torch.int32:
        raise TypeError(f"values must be int32, got {values.dtype}")
    for plane in planes:
        if plane.shape != values.shape or plane.device != values.device:
            raise ValueError(
                f"plane {tuple(plane.shape)} on {plane.device} does not "
                f"match values {tuple(values.shape)} on {values.device}"
            )
        if plane.dtype.is_floating_point or plane.dtype.is_complex:
            raise TypeError(f"a barrier, key or mask must be bool or integer, got {plane.dtype}")
    if values.dim() < 2:
        raise ValueError(f"values must be (..., H, W), got {tuple(values.shape)}")


def _maps(values):
    """The library and the (batch, H, W) of ``values``, within the kernel's
    line and batch limits."""
    height, width = values.shape[-2:]
    batch = values.numel() // (height * width) if height * width else 0
    lib = _library()
    max_line = lib.cc_sweeps_max_line()
    if height > max_line or width > max_line:
        raise ValueError(
            f"({height}, {width}) maps exceed the kernel's line limit {max_line}"
        )
    max_batch = lib.cc_sweeps_max_batch()
    if batch > max_batch:
        raise ValueError(f"{batch} maps exceed the kernel's batch limit {max_batch}")
    return lib, (batch, height, width)


def _byte_plane(mask, shape):
    """A bool or integer plane as the kernel's one byte a cell, nonzero =
    set: bool and uint8 pass as they are, other integers are converted once."""
    if mask.dtype not in (torch.bool, torch.uint8):
        mask = mask != 0
    return mask.reshape(shape).contiguous()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


kernels.LIBRARY.define(
    "cc_sweeps(Tensor values, Tensor barrier, int sentinel, int num_sweeps, "
    "bool check_convergence) -> (Tensor, Tensor)"
)


def _sweeps_cpu(values, barrier, sentinel, num_sweeps, check_convergence):
    if check_convergence:
        return segmented_min_sweeps_plain(values, barrier, sentinel, num_sweeps, True)
    out = segmented_min_sweeps_plain(values, barrier, sentinel, num_sweeps)
    # Zero sweeps return the input itself; an op's output owns its storage.
    out = out.clone() if out is values else out
    return out, torch.zeros(values.shape[:-2], dtype=torch.bool)


def _sweeps_cuda(values, barrier, sentinel, num_sweeps, check_convergence):
    lib, shape = _maps(values)
    source = values.reshape(shape).contiguous()
    barrier = _byte_plane(barrier, shape)
    out = torch.empty_like(source)
    # One zeroed allocation: a byte an image, the all-False ``converged`` of
    # a call without the check (at offset 0, as an output must start), then
    # 4-byte aligned flags[s, b], sweep s changed image b (see
    # csrc/cc_sweeps.cu).
    head = -(-shape[0] // 4) * 4
    buffer = torch.zeros(head + 4 * (num_sweeps + 1) * shape[0], dtype=torch.uint8,
                         device=values.device)
    flags = buffer[head:].view(torch.int32).view(num_sweeps + 1, shape[0])
    if shape[0]:
        with torch.cuda.device(values.device):
            rc = lib.cc_sweeps(
                source.data_ptr(), out.data_ptr(), barrier.data_ptr(), *shape,
                int(sentinel), int(num_sweeps), int(bool(check_convergence)),
                flags.data_ptr(), _stream(values.device),
            )
        if rc != 0:
            raise RuntimeError(f"cc_sweeps launch failed with CUDA error {rc}")
        segmented_min_sweeps.launches += 1
    converged = flags[num_sweeps] == 0 if check_convergence else buffer[: shape[0]].view(torch.bool)
    return out.reshape(values.shape), converged.reshape(values.shape[:-2])


def _sweeps_fake(values, barrier, sentinel, num_sweeps, check_convergence):
    return (
        values.new_empty(values.shape),
        values.new_empty(values.shape[:-2], dtype=torch.bool),
    )


kernels.LIBRARY.impl("cc_sweeps", _sweeps_cpu, "CPU")
kernels.LIBRARY.impl("cc_sweeps", _sweeps_cuda, "CUDA")
torch.library.register_fake(f"{kernels.NAMESPACE}::cc_sweeps", _sweeps_fake, lib=kernels.LIBRARY)


def segmented_min_sweeps(values, barrier, sentinel, num_sweeps, check_convergence=False):
    """Propagate per-component minima of ``values`` across a barrier mask.

    Port of ``keras_ocr_tpu/ops/cc.py:segmented_min_sweeps``, batched: every
    leading dimension is an independent image.

    Args:
        values: (..., H, W) int32; barrier positions must hold ``sentinel``.
        barrier: (..., H, W) bool or integer 0/1 (1 = background /
            propagation barrier); the kernel reads it as one byte a cell.
        sentinel: value acting as +inf.
        num_sweeps: number of row+column propagation sweeps.
        check_convergence: run one extra sweep and report, per image,
            whether it changed nothing (the fixpoint proof).

    Returns:
        (..., H, W) int32; with ``check_convergence`` a tuple of (values
        after the extra sweep, (...) bool ``converged``).

    One call of the op ``torch.ops.keras_ocr_tpu_torch.cc_sweeps``: CPU
    tensors take the plain version; CUDA tensors launch the kernel (its CUDA
    kernel counts the launch in ``segmented_min_sweeps.launches``, also when
    an exported program makes the call) or raise. On the card an image stops
    at its fixpoint: the sweeps after one that left it unchanged skip it,
    which changes neither the map nor the flags.
    """
    if values.device.type != "cpu":
        _check(values, barrier)
    out, converged = torch.ops.keras_ocr_tpu_torch.cc_sweeps(
        values, barrier, int(sentinel), int(num_sweeps), bool(check_convergence)
    )
    return (out, converged) if check_convergence else out


segmented_min_sweeps.launches = 0


def _keyed_run_min(values, key, fg, sentinel, dim):
    """Bidirectional min over maximal same-key foreground runs along dim."""

    def one_direction(reverse):
        prev_fg = _shift(fg.to(torch.int32), 1, dim, reverse, 0)
        prev_key = _shift(key, 1, dim, reverse, -1)
        head = ((~fg) | (prev_fg == 0) | (prev_key != key)).to(torch.int32)
        v, f = values, head
        distance = 1
        size = values.shape[dim]
        while distance < size:
            vs = _shift(v, distance, dim, reverse, sentinel)
            fs = _shift(f, distance, dim, reverse, 1)
            v = torch.where(f == 0, torch.minimum(v, vs), v)
            f = f | fs
            distance *= 2
        return v

    best = torch.minimum(one_direction(False), one_direction(True))
    return torch.where(fg, best, torch.full_like(best, sentinel))


def keyed_rows_cols_plain(values, key, fg, sentinel):
    """Shift-doubling keyed run minimum along rows, then columns; ``fg``
    bool or integer (nonzero = foreground)."""
    fg = fg if fg.dtype == torch.bool else fg != 0
    values = _keyed_run_min(values, key, fg, sentinel, -1)
    return _keyed_run_min(values, key, fg, sentinel, -2)


kernels.LIBRARY.define(
    "cc_keyed_rows_cols(Tensor values, Tensor key, Tensor fg, int sentinel) -> Tensor"
)


def _keyed_cuda(values, key, fg, sentinel):
    lib, shape = _maps(values)
    source = values.reshape(shape).contiguous()
    key = key.to(torch.int32).reshape(shape).contiguous()
    fg = _byte_plane(fg, shape)
    out = torch.empty_like(source)
    if shape[0]:
        with torch.cuda.device(values.device):
            rc = lib.cc_keyed_rows_cols(
                source.data_ptr(), out.data_ptr(), fg.data_ptr(), key.data_ptr(),
                *shape, int(sentinel), _stream(values.device),
            )
        if rc != 0:
            raise RuntimeError(f"cc_keyed_rows_cols launch failed with CUDA error {rc}")
        keyed_rows_cols.launches += 1
    return out.reshape(values.shape)


kernels.LIBRARY.impl("cc_keyed_rows_cols", keyed_rows_cols_plain, "CPU")
kernels.LIBRARY.impl("cc_keyed_rows_cols", _keyed_cuda, "CUDA")
torch.library.register_fake(
    f"{kernels.NAMESPACE}::cc_keyed_rows_cols",
    lambda values, key, fg, sentinel: values.new_empty(values.shape),
    lib=kernels.LIBRARY,
)


def keyed_rows_cols(values, key, fg, sentinel):
    """Keyed run minimum of (..., H, W) int32 ``values`` along the rows,
    then along the columns: a run is a maximal stretch of ``fg`` cells
    (bool or integer, nonzero = foreground) with equal int32 ``key``;
    cells outside ``fg`` get ``sentinel``.

    One call of the op ``torch.ops.keras_ocr_tpu_torch.cc_keyed_rows_cols``:
    CPU tensors take :func:`keyed_rows_cols_plain`; CUDA tensors launch the
    kernel's keyed mode (counted in ``keyed_rows_cols.launches`` by the
    op's CUDA kernel) or raise.
    """
    if values.device.type != "cpu":
        _check(values, key, fg)
    return torch.ops.keras_ocr_tpu_torch.cc_keyed_rows_cols(values, key, fg, int(sentinel))


keyed_rows_cols.launches = 0
