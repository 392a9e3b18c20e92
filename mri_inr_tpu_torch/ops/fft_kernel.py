"""Centred 2-D DFT as a two-pass mixed-radix FFT (counterpart of
``mri_inr_tpu/ops/fft_kernel.py``).

The function is the JAX kernel's: ``fftshift((i)fft2(ifftshift(x),
norm="ortho"))`` per slice, or its magnitude ``|Y|`` (the reconstruction
path's ``complex_abs``). Complex data is float32 real/imag pairs in the last
axis, ``(..., H, W, 2)``. The JAX kernel computes it as dense products
``A_H @ X @ A_W^T`` because a TPU's matrix unit cannot run butterflies; a GPU
can, so the port computes the same function as an FFT:

- pass 1, along W: each row is loaded with both ``ifftshift`` index maps
  folded in (the row's, and the column's within the row), transformed, and
  written to a workspace with the W axis's ``fftshift`` folded into the
  store;
- pass 2, along H: each column of the workspace is transformed and written
  with the H axis's ``fftshift`` folded into the store, as ``Y`` or ``|Y|``.

Each 1-D transform is a Stockham autosort FFT over the radix plan of its
length (:func:`radices`): radix 8, 4 and 2 for the powers of two, 3 and 5,
then one generic radix-p stage per remaining prime factor (a length-p DFT
per butterfly), so every length is taken. Stage ``s`` with radix ``R`` after
stages whose radices multiply to ``ns`` reads ``v[r] = in[j + r*n/R]``
(``j < n/R``), multiplies by the twiddle ``w^(r*(j % ns))`` (``w = exp(+-2 pi
i / (ns*R))``), takes the length-R DFT and writes ``out[(j - j % ns)*R + j %
ns + q*ns]``. Each pass scales by ``1/sqrt(n)`` of its axis.

The twiddles and the radix roots are built in float64 on the host, rounded
to float32 once and cached per ``(n, inverse, device)`` (:func:`tables`):

    stage s: R*ns twiddles  tw[r*ns + k] = exp(sign * 2 pi i r k / (ns*R))
             R roots        root[q]      = exp(sign * 2 pi i q / R)

concatenated stage after stage; ``csrc/dft2c.cu`` recomputes ``ns`` and the
offsets from the radix list by the same rule.

- :func:`dft2c_ri_reference` is the plain PyTorch version: the same plan,
  tables, shift index maps and pass order in float32 operations.
- :func:`dft2c_ri_cuda` launches the hand-written kernel ``csrc/dft2c.cu``
  (both passes, f32 on the CUDA cores, a workspace of N*H*W complex) and
  counts one launch per call.
- :func:`dft2c_ri` and :func:`reconstruct_magnitude_ri_dft` take the kernel
  for CUDA tensors and the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mri_inr_tpu_torch.ops import _build

#: largest H or W the CUDA kernel takes (MAX_DIM in csrc/dft2c.cu): pass 2
#: holds H x 8 complex columns twice in shared memory
DFT_MAX_DIM = 640


@functools.lru_cache(maxsize=None)
def radices(n: int) -> tuple[int, ...]:
    """The radix plan of length ``n``: 8s, then a 4 or a 2 for the powers of
    two, then the odd prime factors in ascending order (3 and 5 have their
    own butterflies in the kernel; any other prime is one generic stage)."""
    if n < 1:
        raise ValueError(f"length must be positive, got {n}")
    twos = (n & -n).bit_length() - 1
    odd = n >> twos
    plan = [8] * (twos // 3) + {0: [], 1: [2], 2: [4]}[twos % 3]
    p = 3
    while odd > 1:
        while odd % p == 0:
            plan.append(p)
            odd //= p
        p += 2
    return tuple(plan)


def _stages(n: int):
    """(radix, ns, table offset) per stage."""
    ns, off = 1, 0
    for r in radices(n):
        yield r, ns, off
        off += r * ns + r
        ns *= r


@functools.lru_cache(maxsize=None)
def _tables_np(n: int, inverse: bool) -> np.ndarray:
    sign = 1.0 if inverse else -1.0
    parts = []
    for r, ns, _ in _stages(n):
        k = np.arange(ns)
        tw = np.exp(sign * 2j * np.pi * np.outer(np.arange(r), k) / (ns * r)).ravel()
        parts += [tw, np.exp(sign * 2j * np.pi * np.arange(r) / r)]
    t = np.concatenate(parts) if parts else np.zeros(0, np.complex128)
    return np.stack([t.real, t.imag], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def tables(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """Twiddles and roots of the plan of ``n`` as (T, 2) float32 on
    ``device``, in the layout of the module docstring."""
    return torch.from_numpy(_tables_np(n, inverse)).to(device)


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _fft_last(re: torch.Tensor, im: torch.Tensor, inverse: bool, shift_in: bool):
    """Centred orthonormal 1-D (i)DFT of ``re + i im`` along the last axis,
    stage by stage as the kernel runs it; ``shift_in=False`` leaves out the
    ``ifftshift`` of the input (pass 2 gets it from pass 1's row map)."""
    n = re.shape[-1]
    lead = re.shape[:-1]
    idx = torch.arange(n, device=re.device)
    if shift_in:
        src = (idx + n // 2) % n
        re, im = re[..., src], im[..., src]
    tab = tables(n, inverse, re.device)
    for r, ns, off in _stages(n):
        m = n // r
        tw = tab[off:off + r * ns].view(r, ns, 2)[:, torch.arange(m, device=re.device) % ns]
        root = tab[off + r * ns:off + r * ns + r]
        q = torch.arange(r, device=re.device)
        dft = root[(q[:, None] * q[None, :]) % r]  # (R, R, 2): [q, r]
        vr, vi = _cmul(re.reshape(*lead, r, m), im.reshape(*lead, r, m), tw[..., 0], tw[..., 1])
        yr = dft[..., 0] @ vr - dft[..., 1] @ vi
        yi = dft[..., 0] @ vi + dft[..., 1] @ vr

        def place(y):
            return y.reshape(*lead, r, m // ns, ns).transpose(-3, -2).reshape(*lead, n)

        re, im = place(yr), place(yi)
    dst = (idx - n // 2) % n  # fftshift: position p takes Z[(p - n//2) mod n]
    scale = float(np.float32(1.0 / np.sqrt(n)))
    return re[..., dst] * scale, im[..., dst] * scale


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
    rows = (torch.arange(h, device=x.device) + h // 2) % h  # pass 1's row map
    re, im = x[:, rows, :, 0], x[:, rows, :, 1]
    re, im = _fft_last(re, im, inverse, shift_in=True)  # pass 1, along W
    re, im = _fft_last(re.transpose(1, 2), im.transpose(1, 2), inverse, shift_in=False)
    yr, yi = re.transpose(1, 2), im.transpose(1, 2)  # pass 2, along H
    if magnitude:
        return torch.sqrt(yr * yr + yi * yi).reshape(*lead, h, w)
    return torch.stack([yr, yi], dim=-1).reshape(*lead, h, w, 2)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("dft2c")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dft2c_launch.argtypes = [p, p, p, p, p, i, i, i, p, i, p, i, i, i, p]
    lib.dft2c_launch.restype = i
    lib.dft2c_error_string.argtypes = [i]
    lib.dft2c_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _radix_array(n: int):
    plan = radices(n)
    return (ctypes.c_int * max(len(plan), 1))(*plan), len(plan)


def dft2c_ri_cuda(kspace_ri: torch.Tensor, *, inverse: bool = True,
                  magnitude: bool = False) -> torch.Tensor:
    """Launch ``csrc/dft2c.cu`` (both passes) on PyTorch's current stream;
    same contract as :func:`dft2c_ri_reference`. Counts one launch per call
    in ``dft2c_ri_cuda.launches``."""
    dev = kspace_ri.device
    if dev.type != "cuda":
        raise ValueError(f"dft2c_ri_cuda needs CUDA tensors, got {dev}")
    lead, h, w, x = _split(kspace_ri)
    if max(h, w) > DFT_MAX_DIM:
        raise ValueError(f"the CUDA kernel takes H, W <= DFT_MAX_DIM = {DFT_MAX_DIM}, "
                         f"got ({h}, {w})")
    if x.shape[0] == 0:
        raise ValueError("empty batch")
    if not x.is_contiguous() or x.data_ptr() % 16:  # the kernel reads float4
        x = x.clone(memory_format=torch.contiguous_format)
    tab_h, tab_w = tables(h, inverse, dev), tables(w, inverse, dev)
    (rad_h, n_h), (rad_w, n_w) = _radix_array(h), _radix_array(w)
    work = torch.empty((x.shape[0], h, w, 2), dtype=torch.float32, device=dev)
    shape = (x.shape[0], h, w) if magnitude else (x.shape[0], h, w, 2)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.dft2c_launch(x.data_ptr(), tab_h.data_ptr(), tab_w.data_ptr(), work.data_ptr(),
                               out.data_ptr(), x.shape[0], h, w, rad_h, n_h, rad_w, n_w,
                               int(inverse), int(magnitude),
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
    FFT kernel; drop-in for ``kspace.reconstruct_magnitude_ri``."""
    return dft2c_ri(kspace_ri, inverse=True, magnitude=True)
