"""Host-side tile helpers, native (C++/OpenMP) with numpy versions
(counterpart of ``mri_inr_tpu/native/__init__.py``).

``tileops.cpp`` is built with ``g++`` at first use into ``native/_build/``
(listed in ``.gitignore``; rebuilt when the source is newer) and bound with
``ctypes``. Every entry point keeps its numpy version, so the package works
without a compiler; :func:`have_native` says which one is active, and the
tests hold the two exact-equal. Setting ``MRI_INR_TPU_TORCH_NO_NATIVE``
forces the numpy versions.

- ``tile_image(image, outer, inner)`` -> (nv*nh, outer, outer), (nv, nh)
- ``gather_pairs(fully, under, idx)`` -> (batch_fully, batch_under)
- ``patch_means(patches)`` -> (n,) means (black-patch classification)
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import subprocess
import tempfile

import numpy as np

_SRC = pathlib.Path(__file__).parent / "tileops.cpp"
_LIB_PATH = pathlib.Path(__file__).parent / "_build" / "libtileops.so"


def _build() -> bool:
    """Compile next to the target and rename, so a concurrent loader never
    sees a half-written library."""
    try:
        _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_LIB_PATH.parent)
        os.close(fd)
    except OSError:
        return False
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp", "-o", tmp, str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.SubprocessError, OSError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


@functools.lru_cache(maxsize=None)
def _load():
    """The bound library, or None without a compiler (decided once)."""
    if os.environ.get("MRI_INR_TPU_TORCH_NO_NATIVE"):
        return None
    try:
        stale = (not _LIB_PATH.exists()
                 or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime)
        if stale and not _build():
            return None
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    lib.tile_f32.argtypes = [f32p, i64, i64, i64, i64, f32p]
    lib.gather_pairs_f32.argtypes = [f32p, f32p, i64p, i64, i64, f32p, f32p]
    lib.patch_means_f32.argtypes = [f32p, i64, i64, f32p]
    lib.omp_max_threads.restype = ctypes.c_int
    return lib


def have_native() -> bool:
    return _load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _tile_np(image: np.ndarray, outer: int, inner: int):
    height, width = image.shape
    pad = (outer - inner) // 2
    vpad = (inner - height % inner) % inner
    hpad = (inner - width % inner) % inner
    padded = np.pad(image, ((pad, pad + vpad), (pad, pad + hpad)), mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(padded, (outer, outer))[
        ::inner, ::inner
    ]
    nv, nh = windows.shape[:2]
    return windows.reshape(nv * nh, outer, outer).copy(), (nv, nh)


def _patch_means_np(patches: np.ndarray) -> np.ndarray:
    return patches.mean(axis=(-2, -1), dtype=np.float64).astype(np.float32)


def tile_image(image: np.ndarray, outer: int, inner: int):
    """Reflect-pad + overlapping-window extraction of one (H, W) image.
    Returns ((nv*nh, outer, outer) float32, (nv, nh))."""
    lib = _load()
    image = np.ascontiguousarray(image, np.float32)
    if lib is None:
        return _tile_np(image, outer, inner)
    height, width = image.shape
    nv = -(-height // inner)
    nh = -(-width // inner)
    out = np.empty((nv * nh, outer, outer), np.float32)
    lib.tile_f32(_f32p(image), height, width, outer, inner, _f32p(out))
    return out, (nv, nh)


def gather_pairs(fully: np.ndarray, under: np.ndarray, idx: np.ndarray):
    """Rows ``idx`` of two parallel (N, P, P) float32 pools as fresh
    contiguous arrays."""
    lib = _load()
    if (lib is None or fully.dtype != np.float32 or under.dtype != np.float32
            or not (fully.flags.c_contiguous and under.flags.c_contiguous)):
        return fully[idx], under[idx]
    idx = np.ascontiguousarray(idx, np.int64)
    n = idx.shape[0]
    patch_elems = int(np.prod(fully.shape[1:]))
    out_f = np.empty((n,) + fully.shape[1:], np.float32)
    out_u = np.empty((n,) + under.shape[1:], np.float32)
    lib.gather_pairs_f32(_f32p(fully), _f32p(under),
                         idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
                         patch_elems, _f32p(out_f), _f32p(out_u))
    return out_f, out_u


def patch_means(patches: np.ndarray) -> np.ndarray:
    """Per-patch mean over a (N, P, P) float32 pool (summed in f64)."""
    lib = _load()
    if lib is None:
        return _patch_means_np(patches)
    patches = np.ascontiguousarray(patches, np.float32)
    n = patches.shape[0]
    out = np.empty((n,), np.float32)
    lib.patch_means_f32(_f32p(patches), n, int(np.prod(patches.shape[1:])), _f32p(out))
    return out
