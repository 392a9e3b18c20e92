"""Centred 2-D DFT as dense complex products (counterpart of
``mri_inr_tpu/ops/fft_kernel.py``).

``Y = A_H @ X @ A_W^T`` per slice, where ``A_n`` is the centred orthonormal
1-D (i)DFT matrix: ``A @ x == fftshift((i)fft(ifftshift(x), norm="ortho"))``.
Both shifts are folded into the matrices once on the host, in float64, then
rounded to float32: bit for bit the JAX package's matrices. An optional
epilogue writes ``|Y|`` (the reconstruction path's ``complex_abs``).

Complex data is float32 real/imag pairs in the last axis, ``(..., H, W, 2)``.

- :func:`dft2c_ri_reference` is the plain PyTorch version: the eight real
  ``torch.matmul`` products in float32 and ``sqrt(yr^2 + yi^2)``.
- :func:`dft2c_ri_cuda` launches the hand-written kernel
  ``csrc/dft2c.cu`` (f32 FMA on the CUDA cores, one launch, no workspace)
  and counts its launches.
- :func:`dft2c_ri` and :func:`reconstruct_magnitude_ri_dft` take the kernel
  for CUDA tensors and the plain version for CPU tensors.

The matrices are cached per ``(n, inverse, device)``, so no call uploads
them twice.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mri_inr_tpu_torch.ops import _build

#: largest H or W the CUDA kernel takes (MAX_DIM in csrc/dft2c.cu): its row
#: strips of A_H and of the intermediate product live in shared memory
DFT_MAX_DIM = 640


@functools.lru_cache(maxsize=None)
def _centered_dft_matrix_np(n: int, inverse: bool):
    """(real, imag) float32 (n, n) matrices of the centred orthonormal 1-D
    (i)DFT, built by pushing the identity through the reference pipeline
    (which gets the odd-n shift asymmetry right)."""
    eye = np.eye(n, dtype=np.complex128)
    shifted = np.fft.ifftshift(eye, axes=0)
    f = (np.fft.ifft if inverse else np.fft.fft)(shifted, axis=0, norm="ortho")
    a = np.fft.fftshift(f, axes=0)
    return a.real.astype(np.float32), a.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _matrices(n: int, inverse: bool, device: torch.device):
    """(real, imag) of ``A_n`` on ``device``."""
    return tuple(torch.from_numpy(m).to(device) for m in _centered_dft_matrix_np(n, inverse))


@functools.lru_cache(maxsize=None)
def _matrix_ri(n: int, inverse: bool, transpose: bool, device: torch.device) -> torch.Tensor:
    """``A_n`` (or its transpose) as interleaved (n, n, 2) f32, the kernel's
    layout."""
    re, im = _matrices(n, inverse, device)
    if transpose:
        re, im = re.t(), im.t()
    return torch.stack([re, im], dim=-1).contiguous()


def _split(kspace_ri: torch.Tensor):
    if kspace_ri.ndim < 3 or kspace_ri.shape[-1] != 2:
        raise ValueError(f"expected (..., H, W, 2) real/imag pairs, got {tuple(kspace_ri.shape)}")
    if kspace_ri.dtype != torch.float32:
        raise ValueError(f"expected float32, got {kspace_ri.dtype}")
    lead = tuple(kspace_ri.shape[:-3])
    h, w = kspace_ri.shape[-3:-1]
    return lead, h, w, kspace_ri.reshape(-1, h, w, 2)


def dft2c_ri_reference(kspace_ri: torch.Tensor, *, inverse: bool = True,
                       magnitude: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (..., H, W, 2) f32 ->
    (..., H, W, 2), or (..., H, W) magnitudes."""
    lead, h, w, x = _split(kspace_ri)
    ar, ai = _matrices(h, inverse, x.device)
    br, bi = _matrices(w, inverse, x.device)
    btr, bti = br.t(), bi.t()
    xr, xi = x[..., 0], x[..., 1]
    tr = ar @ xr - ai @ xi
    ti = ar @ xi + ai @ xr
    yr = tr @ btr - ti @ bti
    yi = tr @ bti + ti @ btr
    if magnitude:
        return torch.sqrt(yr * yr + yi * yi).reshape(*lead, h, w)
    return torch.stack([yr, yi], dim=-1).reshape(*lead, h, w, 2)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("dft2c")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dft2c_launch.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.dft2c_launch.restype = i
    lib.dft2c_error_string.argtypes = [i]
    lib.dft2c_error_string.restype = ctypes.c_char_p
    return lib


def dft2c_ri_cuda(kspace_ri: torch.Tensor, *, inverse: bool = True,
                  magnitude: bool = False) -> torch.Tensor:
    """Launch ``csrc/dft2c.cu`` on PyTorch's current stream; same contract as
    :func:`dft2c_ri_reference`. Counts its launches in
    ``dft2c_ri_cuda.launches``."""
    dev = kspace_ri.device
    if dev.type != "cuda":
        raise ValueError(f"dft2c_ri_cuda needs CUDA tensors, got {dev}")
    lead, h, w, x = _split(kspace_ri)
    if max(h, w) > DFT_MAX_DIM:
        raise ValueError(f"the CUDA kernel takes H, W <= DFT_MAX_DIM = {DFT_MAX_DIM}, "
                         f"got ({h}, {w})")
    if x.shape[0] == 0:
        raise ValueError("empty batch")
    if not x.is_contiguous() or x.data_ptr() % 8:  # the kernel reads float2
        x = x.clone(memory_format=torch.contiguous_format)
    a = _matrix_ri(h, inverse, False, dev)
    bt = _matrix_ri(w, inverse, True, dev)
    shape = (x.shape[0], h, w) if magnitude else (x.shape[0], h, w, 2)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.dft2c_launch(x.data_ptr(), a.data_ptr(), bt.data_ptr(), out.data_ptr(),
                               x.shape[0], h, w, int(magnitude),
                               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.dft2c_error_string(err).decode()
        raise RuntimeError(f"dft2c launch failed: {msg} ({err})")
    dft2c_ri_cuda.launches += 1
    return out.reshape(*lead, h, w) if magnitude else out.reshape(*lead, h, w, 2)


dft2c_ri_cuda.launches = 0


def dft2c_ri(kspace_ri: torch.Tensor, *, inverse: bool = True,
             magnitude: bool = False) -> torch.Tensor:
    """Centred orthonormal 2-D (i)DFT of (..., H, W, 2) real/imag data: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if kspace_ri.device.type == "cuda":
        return dft2c_ri_cuda(kspace_ri, inverse=inverse, magnitude=magnitude)
    if kspace_ri.device.type == "cpu":
        return dft2c_ri_reference(kspace_ri, inverse=inverse, magnitude=magnitude)
    raise ValueError(f"unsupported device {kspace_ri.device}")


def reconstruct_magnitude_ri_dft(kspace_ri: torch.Tensor) -> torch.Tensor:
    """f32 (..., H, W, 2) k-space -> (..., H, W) magnitude image through the
    DFT products; drop-in for ``kspace.reconstruct_magnitude_ri``."""
    return dft2c_ri(kspace_ri, inverse=True, magnitude=True)
