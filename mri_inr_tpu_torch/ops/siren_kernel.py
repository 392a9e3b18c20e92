"""Fused modulated-SIREN forward (counterpart of
``mri_inr_tpu/ops/siren_kernel.py``).

The eval hot path: per patch, a chain of (576, H) @ (H, H) products with a
polynomial-sine + FiLM epilogue. The split is the JAX package's:

- :func:`extract_kernel_params` repacks the model's weights; the first SIREN
  layer ``sin(w0_initial * (coords @ W0 + b0))`` does not depend on the
  patch and is computed once as ``base`` (S, H), with the exact sine (the
  module path uses ``fast_sin`` there, as the JAX model does);
- :func:`compute_modulations` runs the modulator MLP outside the kernel as
  bf16-input / f32-output products;
- the last layer's modulation is multiplied by the projection weights
  before the kernel, so the kernel ends in ``sum_h act * modproj``;
- :func:`siren_forward` runs the chain: the hand-written CUDA kernel
  ``csrc/siren_forward.cu`` for tensors on the card (it reads the hidden
  weights transposed, ``s_wt``), its plain PyTorch version
  :func:`siren_forward_reference` for tensors on the CPU.

Numeric knobs as in the JAX kernel: the hidden sine is degree 5 with
``sin5``, else the bf16-tail degree 7 with ``sin_bf16``, else degree 7 with
``sin7``, else degree 9; ``sin_bf16`` also rounds the hidden modulations to
bf16; the output sine is degree 7 when any of the three is set, else 9.
``block_b`` pads the batch like the TPU grid does. ``streams`` and ``ksplit``
are TPU schedule knobs that only change the order of summation; they are
validated as in the JAX package and otherwise ignored (the CUDA kernel's
two consumer warpgroups always interleave two row tiles, as ``streams=2``
interleaves two row halves on the TPU).

``quantized=True`` takes the int8 chain instead
(:func:`fused_siren_forward_int8`): per-output-channel symmetric int8
weights, per-patch dynamic activation scales folded into the modulations,
int8 x int8 -> int32 products, f32 degree-9 sines. On the card it is the
hand-written kernel ``csrc/siren_forward_int8.cu``, on the CPU its plain
version :func:`siren_forward_int8_reference`.
"""

from __future__ import annotations

import ctypes
import functools
import warnings
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mri_inr_tpu_torch.models.modulated_siren import coordinate_grid
from mri_inr_tpu_torch.ops import _build
from mri_inr_tpu_torch.ops.fast_math import (fast_sin, fast_sin5, fast_sin7,
                                             fast_sin7_bf16)
from mri_inr_tpu_torch.utils.device import module_device, resolve_device

#: hidden sine mode codes shared with csrc/siren_forward.cu (0 = bf16 tail)
_HIDDEN_SINES = {5: fast_sin5, 7: fast_sin7, 9: fast_sin, 0: fast_sin7_bf16}
#: widths the CUDA kernel is instantiated for
KERNEL_WIDTHS = (64, 128, 192, 256)


class SirenKernelParams(NamedTuple):
    """Weights repacked for the fused forward (H = dim_hidden, L = layers)."""

    base: torch.Tensor  # (S, H) f32: sin(w0_init * (coords @ W0 + b0))
    m0_w: torch.Tensor  # (latent, H) bf16: modulator layer 0
    m0_b: torch.Tensor  # (1, H) f32
    mh_w: torch.Tensor  # (L-1, H, H) bf16: modulator hidden-part weights
    mz_w: torch.Tensor  # (L-1, latent, H) bf16: modulator latent-part weights
    m_b: torch.Tensor  # (L-1, 1, H) f32
    s_w: torch.Tensor  # (L-1, H, H) bf16: SIREN hidden layers 1..L-1, (in, out)
    s_b: torch.Tensor  # (L-1, 1, H) f32
    last_w: torch.Tensor  # (1, H) f32: final projection (transposed)
    last_b: torch.Tensor  # (1, 1) f32


def extract_kernel_params(model, coords: torch.Tensor, *,
                          mm_dtype: torch.dtype = torch.bfloat16) -> SirenKernelParams:
    """Repack a :class:`ModulatedSiren`'s ``net`` and ``modulator`` weights;
    product weights in ``mm_dtype`` (bf16 for the tensor cores, f32 for tight
    parity tests), the rest f32. ``coords``: (S, 2) fixed coordinate grid.
    Every operation is differentiable: outside ``torch.no_grad`` the training
    path backpropagates through this repacking into the model's parameters."""
    net, mod = model.net, model.modulator
    num_layers = model.num_layers
    l0 = net.layers[0]
    pre0 = coords.float() @ l0.weight.float().t() + l0.bias.float()
    base = torch.sin(model.w0_initial * pre0)
    if model.activation == "morlet":
        base = base * torch.exp(-0.5 * torch.square(pre0))

    hidden = net.layers[1].weight.shape[1]
    kernel = lambda layer: layer.weight.t()  # (in, out), as the Flax kernel
    stack = lambda xs, dtype: torch.stack(list(xs)).to(dtype).contiguous()
    mw = [kernel(mod.layers[i]) for i in range(1, num_layers)]
    return SirenKernelParams(
        base=base.float().contiguous(),
        m0_w=kernel(mod.layers[0]).to(mm_dtype).contiguous(),
        m0_b=mod.layers[0].bias[None, :].float(),
        mh_w=stack((w[:hidden] for w in mw), mm_dtype),
        mz_w=stack((w[hidden:] for w in mw), mm_dtype),
        m_b=stack((mod.layers[i].bias[None, :] for i in range(1, num_layers)),
                  torch.float32),
        s_w=stack((kernel(net.layers[i]) for i in range(1, num_layers)), mm_dtype),
        s_b=stack((net.layers[i].bias[None, :] for i in range(1, num_layers)),
                  torch.float32),
        last_w=net.last_layer.weight[0][None, :].float().contiguous(),
        last_b=net.last_layer.bias.reshape(1, 1).float().contiguous(),
    )


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(x.astype(w.dtype), w, preferred_element_type=f32)``: round
    the inputs to ``w``'s dtype, multiply in f32. A product of two bf16
    values is exact in f32, so only the summation order can differ."""
    return x.to(w.dtype).float() @ w.float()


def compute_modulations(kp: SirenKernelParams, latents: torch.Tensor, *,
                        num_layers: int = 5) -> torch.Tensor:
    """(B, latent) -> (B, L*H) f32 FiLM modulations;
    ``relu(concat(m, z) @ W + b) == relu(m @ Wh + z @ Wz + b)``."""
    z = latents
    m = torch.relu(_dot(z, kp.m0_w) + kp.m0_b)
    mods = [m]
    for i in range(num_layers - 1):
        m = torch.relu(_dot(m, kp.mh_w[i]) + _dot(z, kp.mz_w[i]) + kp.m_b[i])
        mods.append(m)
    return torch.cat(mods, dim=1)


def _sine_modes(sin7: bool, sin_bf16: bool, sin5: bool) -> tuple[int, int]:
    """(hidden sine mode, output sine degree), the JAX kernel's precedence."""
    hidden = 5 if sin5 else 0 if sin_bf16 else 7 if sin7 else 9
    return hidden, 7 if (sin7 or sin_bf16 or sin5) else 9


def siren_forward_reference(
    mods: torch.Tensor, base: torch.Tensor, s_w: torch.Tensor,
    s_b: torch.Tensor, last_b: torch.Tensor, *, num_layers: int = 5,
    w0: float = 1.0, activation: str = "sine", sin7: bool = False,
    sin_bf16: bool = False, sin5: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same chain, step by step.

    mods (B, L*H) f32 with modproj as the last block, base (S, H) f32,
    s_w (L-1, H, H) bf16 (in, out), s_b (L-1, 1, H) f32, last_b (1, 1) f32
    -> (B, S) f32."""
    hidden_mode, out_deg = _sine_modes(sin7, sin_bf16, sin5)
    sin = _HIDDEN_SINES[hidden_mode]
    sin_last = fast_sin7 if out_deg == 7 else fast_sin

    def act(pre):
        out = sin(w0 * pre)
        if activation == "morlet":
            out = out * torch.exp(-0.5 * torch.square(pre))
        return out

    batch = mods.shape[0]
    hidden = base.shape[1]
    m = mods.reshape(batch, num_layers, 1, hidden)
    x = (base[None] * m[:, 0]).to(torch.bfloat16)
    for i in range(num_layers - 1):
        a = act(_dot(x, s_w[i]) + s_b[i])
        if i < num_layers - 2:
            mod = m[:, i + 1].to(torch.bfloat16) if sin_bf16 else m[:, i + 1]
            x = (a * mod).to(torch.bfloat16)
    r = (a.float() * m[:, num_layers - 1]).sum(-1)
    return sin_last(w0 * (r + last_b[0, 0]))


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: expected {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("siren_forward")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.siren_forward_launch.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                         ctypes.c_float, i, i, i, i, p]
    lib.siren_forward_launch.restype = i
    lib.siren_forward_error_string.argtypes = [i]
    lib.siren_forward_error_string.restype = ctypes.c_char_p
    return lib


def siren_forward_cuda(
    mods: torch.Tensor, base: torch.Tensor, s_w: torch.Tensor,
    s_b: torch.Tensor, last_b: torch.Tensor, *, num_layers: int = 5,
    w0: float = 1.0, activation: str = "sine", sin7: bool = False,
    sin_bf16: bool = False, sin5: bool = False, s_wt: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch ``csrc/siren_forward.cu`` on PyTorch's current stream; same
    contract as :func:`siren_forward_reference`. The kernel reads the hidden
    weights as ``s_wt`` (L-1, H, H) bf16, ``s_w`` transposed per layer to
    (out, in): the caller's copy where it keeps one
    (:func:`make_apply_fn` does), made here otherwise. Counts its launches in
    ``siren_forward_cuda.launches``."""
    batch = mods.shape[0]
    seq, hidden = base.shape
    layers = num_layers
    dev = mods.device
    if dev.type != "cuda":
        raise ValueError(f"siren_forward_cuda needs CUDA tensors, got {dev}")
    if hidden not in KERNEL_WIDTHS:
        raise ValueError(f"the CUDA kernel takes H in {KERNEL_WIDTHS}, got {hidden}")
    if layers < 2:
        raise ValueError(f"num_layers must be at least 2, got {layers}")
    _check("mods", mods, (batch, layers * hidden), torch.float32, dev)
    _check("base", base, (seq, hidden), torch.float32, dev)
    _check("s_w", s_w, (layers - 1, hidden, hidden), torch.bfloat16, dev)
    _check("s_b", s_b, (layers - 1, 1, hidden), torch.float32, dev)
    _check("last_b", last_b, (1, 1), torch.float32, dev)
    if s_wt is None:
        s_wt = s_w.transpose(1, 2).contiguous()  # (out, in): K-contiguous rows
    _check("s_wt", s_wt, (layers - 1, hidden, hidden), torch.bfloat16, dev)
    hidden_mode, out_deg = _sine_modes(sin7, sin_bf16, sin5)
    out = torch.empty((batch, seq), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.siren_forward_launch(
            mods.data_ptr(), base.data_ptr(), s_wt.data_ptr(), s_b.data_ptr(),
            last_b.data_ptr(), out.data_ptr(), batch, seq, hidden, layers,
            float(w0), int(activation == "morlet"), hidden_mode,
            int(sin_bf16), out_deg, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        msg = lib.siren_forward_error_string(err).decode()
        raise RuntimeError(f"siren_forward launch failed: {msg} ({err})")
    siren_forward_cuda.launches += 1
    return out


siren_forward_cuda.launches = 0


def siren_forward(mods: torch.Tensor, *args, s_wt: torch.Tensor | None = None,
                  **kwargs) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors (which
    reads ``s_w`` alone and has no use for ``s_wt``)."""
    if mods.device.type == "cuda":
        return siren_forward_cuda(mods, *args, s_wt=s_wt, **kwargs)
    if mods.device.type == "cpu":
        return siren_forward_reference(mods, *args, **kwargs)
    raise ValueError(f"unsupported device {mods.device}")


def fused_siren_forward(
    kp: SirenKernelParams, latents: torch.Tensor, *, num_layers: int = 5,
    w0: float = 1.0, activation: str = "sine", block_b: int = 8,
    streams: int = 1, sin7: bool = False, sin_bf16: bool = False,
    sin5: bool = False, ksplit: int = 1, s_wt: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, latent) latents -> (B, S) SIREN outputs through the fused chain.
    ``s_wt``: ``kp.s_w`` transposed per layer, where the caller keeps it."""
    batch = latents.shape[0]
    hidden = kp.base.shape[1]
    if block_b % streams:
        raise ValueError(f"{streams=} must divide {block_b=}")
    if hidden % ksplit or (ksplit > 1 and (hidden // ksplit) % 128):
        raise ValueError(f"{ksplit=} must cut hidden={hidden} into 128-multiples")
    padded = -(-batch // block_b) * block_b
    if padded != batch:
        latents = F.pad(latents, (0, 0, 0, padded - batch))
    mods = compute_modulations(kp, latents, num_layers=num_layers)
    cut = (num_layers - 1) * hidden
    mods = torch.cat([mods[:, :cut], mods[:, cut:] * kp.last_w], dim=1)
    out = siren_forward(
        mods, kp.base, kp.s_w, kp.s_b, kp.last_b, num_layers=num_layers,
        w0=w0, activation=activation, sin7=sin7, sin_bf16=sin_bf16, sin5=sin5,
        s_wt=s_wt,
    )
    return out[:batch]


# ------------------------------------------------------------- int8 chain
class Int8SirenParams(NamedTuple):
    """Weights repacked for the int8 chain: per-output-channel symmetric
    int8; the per-patch activation scales are dynamic
    (:func:`compute_quant_factors`)."""

    base: torch.Tensor  # (S, H) f32: sin(w0_init * (coords @ W0 + b0))
    swq: torch.Tensor  # (L-1, H, H) int8: quantised SIREN hidden weights, (in, out)
    sw_scale: torch.Tensor  # (L-1, 1, H) f32: per-output-channel dequant scale
    s_b: torch.Tensor  # (L-1, 1, H) f32
    last_w: torch.Tensor  # (1, H) f32
    last_b: torch.Tensor  # (1, 1) f32
    # (L-1, H, H) int8: ``swq`` as the CUDA kernel reads it
    # (:func:`int8_kernel_weights`), made once here so that no launch makes
    # it again
    swq_t: torch.Tensor | None = None


def int8_k_order(hidden: int, device=None) -> torch.Tensor:
    """The CUDA kernel's contraction order for the inputs of hidden layers
    1..L-2: position ``p`` of each 32-block holds column ``perm[p]``. The
    kernel keeps a layer's activations as the next product's int8 A
    fragments in registers; a thread's accumulators hold columns {8j + 2t,
    8j + 2t + 1}, and byte ``q`` of its fragment register for the 16-byte
    half ``u`` of a block wants position 16u + 4t + q. Taking column 16u +
    2t + (q & 1) + 8 (q >> 1) there lets every thread pack its own four
    values (columns c, c + 1, c + 8, c + 9) into one register."""
    p = torch.arange(hidden, device=device)
    r = p % 32
    u, t, q = r // 16, (r % 16) // 4, r % 4
    return p - r + 16 * u + 2 * t + (q & 1) + 8 * (q >> 1)


def int8_kernel_weights(swq: torch.Tensor) -> torch.Tensor:
    """``swq`` (L-1, H, H) int8 (in, out) -> the CUDA kernel's weight pack:
    (out, in) per layer, K-contiguous rows (int8 wgmma reads both operands
    K-major), and for layers 1..L-2 the contraction index in
    :func:`int8_k_order`, so that ``pack[i][:, p] == swq[i][perm[p], :]``.
    Layer 0 keeps the natural order: its input is built from ``base``."""
    pack = swq.transpose(1, 2).contiguous()
    perm = int8_k_order(swq.shape[1], swq.device)
    pack[1:] = pack[1:, :, perm]
    return pack


def quantize_kernel_params(model, kp: SirenKernelParams) -> Int8SirenParams:
    """Quantise the SIREN hidden weights from the model's f32 parameters
    (not the bf16 copies in ``kp``): scale = max|w| over the input axis /
    127, ``round`` to nearest even."""
    net = model.net
    w = torch.stack([net.layers[i].weight.t() for i in range(1, model.num_layers)]).float()
    scale = w.abs().amax(dim=1, keepdim=True) / 127.0  # (L-1, 1, H)
    swq = torch.round(w / scale).to(torch.int8)
    return Int8SirenParams(kp.base, swq, scale, kp.s_b, kp.last_w, kp.last_b,
                           int8_kernel_weights(swq))


def compute_quant_factors(kp: SirenKernelParams, ikp: Int8SirenParams,
                          latents: torch.Tensor, *, num_layers: int = 5):
    """Per-patch dynamic activation quantisation, folded into the
    modulations. Layer i's product input is ``x = sin(pre) * m_i[b]`` with
    ``|sin| <= 1`` and ``m_i >= 0`` (ReLU), so ``max|x| <= max_h m_i[b, h]``.
    With ``scale_i[b] = max_h m_i[b, h] / 127``:

    - ``fq_i[b, h] = m_i[b, h] / scale_i[b]`` (quantise: ``round(sin * fq)``),
    - ``gd_i[b, h'] = scale_i[b] * sw_scale_i[h']`` (dequantise the int32 sum),
    - ``ls[b] = scale_{L-1}[b]`` (the last layer's rescale).

    Returns ``fq`` (B, L*H), ``gd`` (B, (L-1)*H), ``ls`` (B, 1)."""
    mods = compute_modulations(kp, latents, num_layers=num_layers)
    batch = mods.shape[0]
    hidden = ikp.base.shape[1]
    m = mods.reshape(batch, num_layers, hidden)
    scale = m.amax(dim=2).clamp_min(1e-12) / 127.0  # (B, L)
    fq = (m / scale[:, :, None]).reshape(batch, num_layers * hidden)
    gd = scale[:, : num_layers - 1, None] * ikp.sw_scale[:, 0, :][None]
    gd = gd.reshape(batch, (num_layers - 1) * hidden)
    ls = scale[:, num_layers - 1 :].contiguous()
    return fq, gd, ls


def siren_forward_int8_reference(
    fq: torch.Tensor, gd: torch.Tensor, ls: torch.Tensor, base: torch.Tensor,
    swq: torch.Tensor, s_b: torch.Tensor, last_w: torch.Tensor,
    last_b: torch.Tensor, *, num_layers: int = 5, w0: float = 1.0,
    activation: str = "sine",
) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel.

    fq (B, L*H), gd (B, (L-1)*H), ls (B, >=1; column 0 is read), base (S, H),
    swq (L-1, H, H) int8 (in, out), s_b (L-1, 1, H), last_w (1, H), last_b
    (1, 1) -> (B, S) f32.

    The integer products are exact: the quantised operands are held as
    float32 (float64 above H = 1040), and every partial sum of H products of
    magnitude <= 127^2 is an integer below 2^24, which float32 holds exactly
    in any order of summation. So no integer matmul routine is needed, on the
    CPU or on the card."""
    batch = fq.shape[0]
    hidden = base.shape[1]
    exact = torch.float32 if hidden * 127 * 127 < 2 ** 24 else torch.float64

    def act(pre):
        out = fast_sin(w0 * pre)
        if activation == "morlet":
            out = out * torch.exp(-0.5 * torch.square(pre))
        return out

    def rows(t, layer):  # (B, 1, H) per-patch factor slice
        return t[:, layer * hidden : (layer + 1) * hidden].reshape(batch, 1, hidden)

    def quantize(s3, layer):  # integer-valued, in [-127, 127]
        return torch.floor(s3 * rows(fq, layer) + 0.5).to(exact)

    xq = quantize(base[None], 0)
    for i in range(num_layers - 1):
        acc = (xq @ swq[i].to(exact)).float()
        s3 = act(acc * rows(gd, i) + s_b[i].reshape(1, 1, hidden))
        if i < num_layers - 2:
            xq = quantize(s3, i + 1)
    xlast = s3 * rows(fq, num_layers - 1)
    r = (xlast * last_w.reshape(1, 1, hidden)).sum(-1)  # (B, S)
    return fast_sin(w0 * (r * ls[:, :1] + last_b[0, 0]))


@functools.lru_cache(maxsize=None)
def _library_int8() -> ctypes.CDLL:
    lib = _build.load("siren_forward_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.siren_forward_int8_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                              ctypes.c_float, i, p]
    lib.siren_forward_int8_launch.restype = i
    lib.siren_forward_int8_error_string.argtypes = [i]
    lib.siren_forward_int8_error_string.restype = ctypes.c_char_p
    return lib


def siren_forward_int8_cuda(
    fq: torch.Tensor, gd: torch.Tensor, ls: torch.Tensor, base: torch.Tensor,
    swq: torch.Tensor, s_b: torch.Tensor, last_w: torch.Tensor,
    last_b: torch.Tensor, *, num_layers: int = 5, w0: float = 1.0,
    activation: str = "sine", swq_t: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch ``csrc/siren_forward_int8.cu`` on PyTorch's current stream; same
    contract as :func:`siren_forward_int8_reference`. ``swq`` comes in the
    (in, out) layout; the kernel reads its own pack
    (:func:`int8_kernel_weights`), which is ``swq_t`` where the caller keeps
    that copy (``Int8SirenParams.swq_t``) and is made here otherwise. Counts
    its launches in ``siren_forward_int8_cuda.launches``."""
    batch = fq.shape[0]
    seq, hidden = base.shape
    layers = num_layers
    dev = fq.device
    if dev.type != "cuda":
        raise ValueError(f"siren_forward_int8_cuda needs CUDA tensors, got {dev}")
    if hidden not in KERNEL_WIDTHS:
        raise ValueError(f"the CUDA kernel takes H in {KERNEL_WIDTHS}, got {hidden}")
    if layers < 2:
        raise ValueError(f"num_layers must be at least 2, got {layers}")
    if ls.ndim != 2 or ls.shape[1] < 1:
        raise ValueError(f"ls: expected (B, >=1), got {tuple(ls.shape)}")
    _check("fq", fq, (batch, layers * hidden), torch.float32, dev)
    _check("gd", gd, (batch, (layers - 1) * hidden), torch.float32, dev)
    _check("ls", ls, (batch, ls.shape[1]), torch.float32, dev)
    _check("base", base, (seq, hidden), torch.float32, dev)
    _check("swq", swq, (layers - 1, hidden, hidden), torch.int8, dev)
    _check("s_b", s_b, (layers - 1, 1, hidden), torch.float32, dev)
    _check("last_w", last_w, (1, hidden), torch.float32, dev)
    _check("last_b", last_b, (1, 1), torch.float32, dev)
    if swq_t is None:
        swq_t = int8_kernel_weights(swq)
    _check("swq_t", swq_t, (layers - 1, hidden, hidden), torch.int8, dev)
    out = torch.empty((batch, seq), dtype=torch.float32, device=dev)
    lib = _library_int8()
    with torch.cuda.device(dev):
        err = lib.siren_forward_int8_launch(
            fq.data_ptr(), gd.data_ptr(), ls.data_ptr(), base.data_ptr(),
            swq_t.data_ptr(), s_b.data_ptr(), last_w.data_ptr(), last_b.data_ptr(),
            out.data_ptr(), batch, seq, hidden, layers, ls.shape[1], float(w0),
            int(activation == "morlet"), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        msg = lib.siren_forward_int8_error_string(err).decode()
        raise RuntimeError(f"siren_forward_int8 launch failed: {msg} ({err})")
    siren_forward_int8_cuda.launches += 1
    return out


siren_forward_int8_cuda.launches = 0


def siren_forward_int8(fq: torch.Tensor, *args, swq_t: torch.Tensor | None = None,
                       **kwargs) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors (which
    reads ``swq`` alone and has no use for ``swq_t``)."""
    if fq.device.type == "cuda":
        return siren_forward_int8_cuda(fq, *args, swq_t=swq_t, **kwargs)
    if fq.device.type == "cpu":
        return siren_forward_int8_reference(fq, *args, **kwargs)
    raise ValueError(f"unsupported device {fq.device}")


def fused_siren_forward_int8(
    kp: SirenKernelParams, ikp: Int8SirenParams, latents: torch.Tensor, *,
    num_layers: int = 5, w0: float = 1.0, activation: str = "sine",
    block_b: int = 8,
) -> torch.Tensor:
    """(B, latent) latents -> (B, S) SIREN outputs through the int8 chain.
    ``block_b`` pads the batch as the TPU grid does."""
    batch = latents.shape[0]
    if block_b < 1:
        raise ValueError(f"{block_b=} must be positive")
    padded = -(-batch // block_b) * block_b
    if padded != batch:
        latents = F.pad(latents, (0, 0, 0, padded - batch))
    fq, gd, ls = compute_quant_factors(kp, ikp, latents, num_layers=num_layers)
    out = siren_forward_int8(
        fq.contiguous(), gd.contiguous(), ls, ikp.base, ikp.swq, ikp.s_b, ikp.last_w,
        ikp.last_b, num_layers=num_layers, w0=w0, activation=activation,
        swq_t=ikp.swq_t,
    )
    return out[:batch]


@torch.no_grad()
def fused_forward(model, tiles: torch.Tensor, *, block_b: int = 8,
                  quantized: bool = False, sin7: bool = True,
                  sin_bf16: bool = False, sin5: bool = False,
                  ksplit: int = 1,
                  packed: tuple[SirenKernelParams, Int8SirenParams | None] | None = None,
                  s_wt: torch.Tensor | None = None,
                  ) -> torch.Tensor:
    """Full forward: conv encoder -> fused modulator + SIREN ->
    (B, siren, siren). Drop-in for ``model(tiles)`` in eval mode. ``packed``:
    ``(kp, ikp)``, the first two of a :class:`WeightPack`'s values (``ikp``
    may be None when not ``quantized``), and ``s_wt`` its third, ``kp.s_w``
    transposed per layer, for a caller whose weights stay fixed over many
    calls; without ``packed`` the weights are repacked (and quantised) on
    every call."""
    latent = model.encode(tiles)
    s = model.siren_patch_size
    if packed is not None:
        kp, ikp = packed
        if quantized and ikp is None:
            ikp = quantize_kernel_params(model, kp)
    else:
        kp = extract_kernel_params(model, coordinate_grid(s, tiles.device))
        ikp = quantize_kernel_params(model, kp) if quantized else None
    common = dict(num_layers=model.num_layers, w0=model.w0,
                  activation=model.activation, block_b=block_b)
    if quantized:
        # sin5 is not in this check: it is the eval default, and the int8
        # chain evaluates no polynomial tail it could shorten
        if sin_bf16 or ksplit != 1 or not sin7:
            warnings.warn(
                "quantized=True uses the int8 kernel, which has no "
                "sin7/sin_bf16/ksplit knobs: those settings are ignored",
                stacklevel=2,
            )
        out = fused_siren_forward_int8(kp, ikp, latent.float(), **common)
    else:
        out = fused_siren_forward(kp, latent.float(), sin7=sin7, sin_bf16=sin_bf16,
                                  sin5=sin5, ksplit=ksplit, s_wt=s_wt, **common)
    return out.reshape(tiles.shape[0], s, s)


@torch.no_grad()
def pack_weights(model, quantized: bool = False):
    """``(kp, ikp, s_wt)`` for :func:`fused_forward`: the repacked weights,
    the int8 ones when ``quantized`` (else None) and ``kp.s_w`` transposed
    per layer, as the CUDA kernel reads it."""
    kp = extract_kernel_params(
        model, coordinate_grid(model.siren_patch_size, module_device(model)))
    ikp = quantize_kernel_params(model, kp) if quantized else None
    return kp, ikp, kp.s_w.transpose(1, 2).contiguous()


class WeightPack:
    """``model``'s kernel weights for :func:`fused_forward`
    (:func:`pack_weights`). Packed when made and again, on a call, whenever
    a parameter of the model has changed since: in place (its ``_version``
    counter, which an in-place update such as ``load_state_dict`` or a
    plain optimizer step moves) or by a new tensor (its storage). So an
    apply function built once follows such updates. An update that moves no
    ``_version`` (the replay of a CUDA graph; fused Adam's kernel) must be
    followed by :meth:`invalidate`. ``packs`` counts the packings."""

    def __init__(self, model, quantized: bool = False):
        self.model, self.quantized = model, quantized
        self.packs, self._key, self._value = 0, None, None
        self()

    def _state(self) -> tuple:
        return tuple((p.data_ptr(), p._version) for p in self.model.parameters())

    def invalidate(self) -> None:
        """Repack on the next call, whatever the counters say."""
        self._key = None

    def __call__(self):
        key = self._state()
        if key != self._key:
            self._value = pack_weights(self.model, self.quantized)
            self._key = key
            self.packs += 1
        return self._value


@torch.no_grad()
def _module_apply(model, tiles: torch.Tensor) -> torch.Tensor:
    return model(tiles)


def make_apply_fn(model, *, use_pallas: bool = True, block_b: int = 16,
                  quantized: bool = False, sin7: bool = True,
                  sin_bf16: bool = False, sin5: bool = False, ksplit: int = 1,
                  device: str | torch.device | None = None):
    """tiles -> (B, siren, siren) forward for ``SliceReconstructor``: the
    fused forward when ``use_pallas`` (the name is the config key's), else
    the module path. Residual models always take the module path. Puts the
    model in eval mode (dropout off). ``device`` (default ``cuda``) must be
    where the model lives. The fused path packs the weights (and quantises
    them, with ``quantized``) here, and again on a call only when a
    parameter has changed since (:class:`WeightPack`, the function's
    ``pack``). Its ``forward(tiles, packed)`` takes the weights from the
    caller instead, as :func:`pack_weights` gives them."""
    dev = resolve_device(device)
    if module_device(model) != dev:
        raise ValueError(f"model is on {module_device(model)}, not on {dev}")
    model.eval()
    if not use_pallas or model.residual:
        return functools.partial(_module_apply, model)
    pack = WeightPack(model, quantized)

    def forward(tiles: torch.Tensor, packed) -> torch.Tensor:
        kp, ikp, s_wt = packed
        return fused_forward(model, tiles, block_b=block_b, quantized=quantized, sin7=sin7,
                             sin_bf16=sin_bf16, sin5=sin5, ksplit=ksplit, packed=(kp, ikp),
                             s_wt=s_wt)

    def apply(tiles: torch.Tensor) -> torch.Tensor:
        return forward(tiles, pack())

    apply.pack, apply.forward = pack, forward
    return apply
