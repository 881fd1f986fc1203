"""ctypes bindings of the port's host-ops library (``csrc/hostops.cpp``).

Counterpart of ``keras_ocr_tpu/native.py``: bilinear resize, perspective
warp, 4-connected labelling and square dilation in C++. The library is
built at first use with the host C++ compiler (``$CXX``, else ``c++`` or
``g++``; it is host code, not a CUDA source) into
``<checkout>/build/kernels/`` under a hash of its source and flags, and
loaded with :mod:`ctypes`. Where the build fails, :func:`available` returns
``False`` with a warning that names the compiler's error, and callers take
their numpy paths (the host oracle :func:`..detection.getBoxes` does), as
the JAX package's callers do.

``-ffp-contract=off`` keeps the compiler from fusing a product and a sum
into one rounding, so the float32 resize and the float64 warp round as the
numpy versions beside them (:func:`resize_bilinear_plain`,
:func:`warp_perspective_plain`) do, on every host.

``calls`` counts the calls that reached the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import threading
import typing
import warnings

import numpy as np

from . import kernels

SOURCE = "hostops.cpp"
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

calls = 0

_lock = threading.Lock()
_state: dict = {}


def find_compiler() -> str:
    """The host C++ compiler: ``$CXX``, then ``c++``, then ``g++`` on PATH."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler found ($CXX, c++ or g++ on PATH)")


def library_path() -> str:
    """Where ``csrc/hostops.cpp`` is built."""
    with open(os.path.join(kernels.SOURCE_DIR, SOURCE), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return os.path.join(kernels.BUILD_DIR, f"hostops_{digest[:16]}.so")


def _build() -> str:
    path = library_path()
    if not os.path.isfile(path):
        kernels.compile_library([find_compiler(), *CXX_FLAGS], SOURCE, path, "the host compiler")
    return path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32, f64 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)
    u8, i32, c_int = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32), ctypes.c_int
    lib.resize_bilinear_f32.argtypes = [f32, c_int, c_int, c_int, f32, c_int, c_int]
    lib.resize_bilinear_f32.restype = None
    lib.warp_perspective_f32.argtypes = [f32, c_int, c_int, c_int, f64, f32, c_int, c_int,
                                         ctypes.c_float]
    lib.warp_perspective_f32.restype = None
    lib.label_components_u8.argtypes = [u8, c_int, c_int, i32]
    lib.label_components_u8.restype = ctypes.c_int
    lib.dilate_square_u8.argtypes = [u8, c_int, c_int, c_int, u8]
    lib.dilate_square_u8.restype = None
    return lib


def _library() -> typing.Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None (with one warning
    naming the error) where it cannot be built or loaded."""
    with _lock:
        if "lib" not in _state:
            try:
                _state["lib"] = _declare(ctypes.CDLL(_build()))
            except (OSError, RuntimeError) as exc:
                _state["lib"] = None
                warnings.warn(f"the native host-ops library is unavailable; callers take "
                              f"their numpy paths: {exc}", RuntimeWarning, stacklevel=3)
        return _state["lib"]


def available() -> bool:
    """Whether the library is built and loaded (building it on first call)."""
    return _library() is not None


def _lib() -> ctypes.CDLL:
    global calls
    lib = _library()
    if lib is None:
        raise RuntimeError("the native host-ops library is unavailable (see available())")
    calls += 1
    return lib


def _ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def _mask_u8(mask: np.ndarray) -> np.ndarray:
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    if mask.ndim != 2:
        raise ValueError(f"expected an (H, W) mask, got shape {mask.shape}")
    return mask


def _channels_last(image: np.ndarray) -> typing.Tuple[np.ndarray, bool]:
    squeeze = image.ndim == 2
    src = np.ascontiguousarray(image[..., None] if squeeze else image, dtype=np.float32)
    if src.ndim != 3:
        raise ValueError(f"expected an (H, W) or (H, W, C) image, got shape {image.shape}")
    return src, squeeze


def _cast_back(dst: np.ndarray, image: np.ndarray, squeeze: bool) -> np.ndarray:
    """The float32 result in ``image``'s dtype: integers rounded and clipped
    to their range, as the JAX package's wrappers do."""
    if np.issubdtype(image.dtype, np.integer):
        info = np.iinfo(image.dtype)
        dst = np.clip(np.rint(dst), info.min, info.max).astype(image.dtype)
    else:
        dst = dst.astype(image.dtype)
    return dst[..., 0] if squeeze else dst


def resize_bilinear(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of an HWC or HW image (cv2 ``INTER_LINEAR``'s
    half-pixel centres, edge clamping), computed in float32."""
    src, squeeze = _channels_last(image)
    lib = _lib()
    dst = np.empty((height, width, src.shape[2]), dtype=np.float32)
    lib.resize_bilinear_f32(_ptr(src, ctypes.c_float), src.shape[0], src.shape[1], src.shape[2],
                            _ptr(dst, ctypes.c_float), height, width)
    return _cast_back(dst, image, squeeze)


def resize_bilinear_plain(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """:func:`resize_bilinear` in numpy, rounding as the C++ loop does."""
    src, squeeze = _channels_last(image)
    src_h, src_w = src.shape[:2]
    f32 = np.float32

    def taps(n, size, scale):
        s = (np.arange(n, dtype=f32) + f32(0.5)) * scale - f32(0.5)
        s = np.maximum(f32(0), np.minimum(s, f32(size - 1)))
        lo = s.astype(np.int64)
        return lo, np.minimum(lo + 1, size - 1), s - lo.astype(f32)

    y0, y1, fy = taps(height, src_h, f32(src_h) / f32(height))
    x0, x1, fx = taps(width, src_w, f32(src_w) / f32(width))
    fy, fx = fy[:, None, None], fx[None, :, None]
    w00, w01 = (f32(1) - fx) * (f32(1) - fy), fx * (f32(1) - fy)
    w10, w11 = (f32(1) - fx) * fy, fx * fy
    rows0, rows1 = src[y0], src[y1]
    dst = (w00 * rows0[:, x0] + w01 * rows0[:, x1]) + w10 * rows1[:, x0] + w11 * rows1[:, x1]
    return _cast_back(dst.astype(f32), image, squeeze)


def warp_perspective(image: np.ndarray, M: np.ndarray, dsize, cval=0.0) -> np.ndarray:
    """``cv2.warpPerspective`` with ``M`` mapping source to destination:
    bilinear taps in float64, those outside the image dropped, ``cval``
    where all four are outside; ``dsize`` is (width, height)."""
    width, height = dsize
    src, squeeze = _channels_last(image)
    lib = _lib()
    minv = np.ascontiguousarray(np.linalg.inv(np.asarray(M, dtype=np.float64)))
    dst = np.empty((height, width, src.shape[2]), dtype=np.float32)
    lib.warp_perspective_f32(_ptr(src, ctypes.c_float), src.shape[0], src.shape[1], src.shape[2],
                             _ptr(minv, ctypes.c_double), _ptr(dst, ctypes.c_float), height,
                             width, ctypes.c_float(float(cval)))
    return _cast_back(dst, image, squeeze)


def warp_perspective_plain(image: np.ndarray, M: np.ndarray, dsize, cval=0.0) -> np.ndarray:
    """:func:`warp_perspective` in numpy, rounding as the C++ loop does."""
    width, height = dsize
    src, squeeze = _channels_last(image)
    src_h, src_w = src.shape[:2]
    m = np.linalg.inv(np.asarray(M, dtype=np.float64)).ravel()
    y, x = np.meshgrid(np.arange(height, dtype=np.float64), np.arange(width, dtype=np.float64),
                       indexing="ij")
    denom = m[6] * x + m[7] * y + m[8]
    sx = (m[0] * x + m[1] * y + m[2]) / denom
    sy = (m[3] * x + m[4] * y + m[5]) / denom
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    acc = np.zeros((height, width, src.shape[2]))
    inside = np.zeros((height, width, 1), dtype=bool)
    for weight, xs, ys in (((1 - fx) * (1 - fy), x0, y0), (fx * (1 - fy), x0 + 1, y0),
                           ((1 - fx) * fy, x0, y0 + 1), (fx * fy, x0 + 1, y0 + 1)):
        ok = ((xs >= 0) & (xs < src_w) & (ys >= 0) & (ys < src_h))[..., None]
        tap = src[np.clip(ys, 0, src_h - 1), np.clip(xs, 0, src_w - 1)].astype(np.float64)
        acc = np.where(ok, acc + weight * tap, acc)
        inside |= ok
    dst = np.where(inside, acc.astype(np.float32), np.float32(cval))
    return _cast_back(dst, image, squeeze)


def label_components(mask: np.ndarray) -> typing.Tuple[np.ndarray, int]:
    """4-connected labels (int32, 1..n in raster order of each component's
    first pixel, ``scipy.ndimage.label``'s numbering; 0 at background) and
    the count n."""
    mask_u8 = _mask_u8(mask)
    lib = _lib()
    labels = np.empty(mask_u8.shape, dtype=np.int32)
    count = lib.label_components_u8(_ptr(mask_u8, ctypes.c_uint8), mask_u8.shape[0],
                                    mask_u8.shape[1], _ptr(labels, ctypes.c_int32))
    return labels, int(count)


def dilate_square(mask: np.ndarray, niter: int) -> np.ndarray:
    """Dilation of a bool mask by the (1+niter)^2 square with cv2's anchor
    (``detection._dilate_cv2_style``)."""
    src = _mask_u8(mask)
    lib = _lib()
    dst = np.empty_like(src)
    lib.dilate_square_u8(_ptr(src, ctypes.c_uint8), src.shape[0], src.shape[1], int(niter),
                         _ptr(dst, ctypes.c_uint8))
    return dst.astype(bool)
