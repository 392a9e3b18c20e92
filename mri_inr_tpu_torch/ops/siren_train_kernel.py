"""Fused modulated-SIREN TRAINING chain: forward and backward (counterpart
of ``mri_inr_tpu/ops/siren_train_kernel.py``).

The modulator + SIREN chain of the train step is one differentiable op,
:func:`siren_chain_train`, whose forward is one hand-written CUDA kernel
(``csrc/siren_train_fwd.cu``) and whose backward is one call of
``csrc/siren_train_bwd.cu`` (a chain kernel, then a split-K weight-gradient
kernel over its workspace) for tensors on the card, and a plain PyTorch
version of each for tensors on the CPU. The backward recomputes the forward from
the op's inputs, so no layer activation is kept between the two. Both
kernels read the hidden weights transposed per layer, (out, in); the op
makes that copy once per call and hands it to both.

Dropout masks come from a counter hash of (seed, layer, element index)
rather than a random stream, so the backward regenerates the forward's masks
bit for bit from the seed alone. The hash is the JAX package's, so a test can
hand both sides one seed and compare.

Everything outside the chain (conv encoder, modulator products, the first
SIREN layer folded into ``base``) stays ordinary PyTorch under autograd:
the op's (dmods, dbase, dW, ...) gradients flow on through
``compute_modulations`` / ``extract_kernel_params`` into the model's
parameters.

``block_b``, ``bwd_block_b`` and ``dw_partials`` are TPU schedule knobs. They
are validated and otherwise ignored: the masks do not depend on them, and
the CUDA kernels need no batch padding.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mri_inr_tpu_torch.models.modulated_siren import coordinate_grid
from mri_inr_tpu_torch.ops import _build
from mri_inr_tpu_torch.ops.fast_math import fast_cos, fast_cos5, fast_sin, fast_sin5
from mri_inr_tpu_torch.ops.siren_kernel import (KERNEL_WIDTHS, SirenKernelParams, _check,
                                                _dot, compute_modulations,
                                                extract_kernel_params)

# multiplicative-hash constants; 32-bit wraparound is the point
_HASH_M = 0x9E3779B1
_LAYER_STRIDE = 1315423911


def _keep_threshold(keep: float) -> int:
    """Signed-int32 threshold t with P(h < t) = keep for uniform int32 h."""
    return int(round(keep * 2.0**32 - 2.0**31))


def _wrap_i32(v: int) -> int:
    """Two's-complement wrap of a Python int to the int32 range."""
    v %= 2**32
    return v - 2**32 if v >= 2**31 else v


def seed_tensor(seed, device) -> torch.Tensor:
    """``seed`` (int or (1,) tensor) as the (1,) f32 tensor the op takes. An
    integer is written by a fill on the device, not copied from host memory:
    such a copy would make the host wait for the device's stream each step."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.float32).reshape(1)
    return torch.full((1,), float(int(seed)), dtype=torch.float32, device=device)


def dropout_mask(seed: torch.Tensor, layer: int, keep: float,
                 shape: tuple[int, int, int]) -> torch.Tensor:
    """(B, S, H) f32 mask of {0, 1/keep} for ``layer``: element ``idx =
    (b*S + s)*H + col`` is kept where ``(int32)h < round(keep*2^32 - 2^31)``,
    ``h = m ^ (m >>> 16)``, ``m = (idx + seed + layer*1315423911) *
    0x9E3779B1`` in 32-bit wraparound. Done in int32 tensors, whose add and
    multiply wrap modulo 2^32 on the CPU and on the card (the hash's own
    arithmetic; tests hold it to the JAX hash and to a written-out int64
    version); ``>>`` on int32 is arithmetic, so ``m >>> 16`` is ``(m >> 16)
    & 0xFFFF``."""
    batch, seq, hidden = shape
    off = seed.reshape(()).to(torch.int32) + _wrap_i32(layer * _LAYER_STRIDE)
    idx = torch.arange(batch * seq * hidden, dtype=torch.int32, device=seed.device)
    m = (idx + off) * _wrap_i32(_HASH_M)
    h = m ^ ((m >> 16) & 0xFFFF)
    inv_keep = float(np.float32(1.0 / keep))
    mask = torch.where(h < _keep_threshold(keep), inv_keep, 0.0)
    return mask.to(torch.float32).reshape(batch, seq, hidden)


def _sin_cos(sin5: bool):
    return (fast_sin5, fast_cos5) if sin5 else (fast_sin, fast_cos)


def _sine_pair(w0: float, sin5: bool):
    """(act, dact) of the OUTPUT layer: always a sine, Morlet models too."""
    sin, cos = _sin_cos(sin5)
    return (lambda p: sin(w0 * p)), (lambda p: w0 * cos(w0 * p))


def _act_pair(w0: float, activation: str, sin5: bool):
    """(act, dact): hidden activation and its derivative wrt the
    pre-activation; the derivative is the cosine polynomial, not autograd's
    derivative of the sine polynomial."""
    if activation != "morlet":
        return _sine_pair(w0, sin5)
    sin, cos = _sin_cos(sin5)

    def act(p):
        return sin(w0 * p) * torch.exp(-0.5 * torch.square(p))

    def dact(p):
        env = torch.exp(-0.5 * torch.square(p))
        return env * (w0 * cos(w0 * p) - p * sin(w0 * p))

    return act, dact


def _dropper(seed: torch.Tensor, rate: float, shape):
    if rate <= 0.0:
        return lambda x, layer: x
    keep = 1.0 - rate
    return lambda x, layer: x * dropout_mask(seed, layer, keep, shape)


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0 or (rate > 0.0 and _keep_threshold(1.0 - rate) >= 2**31):
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")


def siren_chain_train_fwd_reference(
    seed: torch.Tensor, mods: torch.Tensor, base: torch.Tensor, s_w: torch.Tensor,
    s_b: torch.Tensor, last_w: torch.Tensor, last_b: torch.Tensor, *,
    num_layers: int = 5, w0: float = 1.0, activation: str = "sine",
    dropout_rate: float = 0.0, sin5: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, step by step.

    seed (1,) f32 holding an integer, mods (B, L*H) f32, base (S, H) f32,
    s_w (L-1, H, H) (in, out) in the product dtype (bf16, or f32 for tight
    parity tests), s_b (L-1, 1, H) f32, last_w (1, H) f32, last_b (1, 1) f32
    -> (B, S) f32."""
    _check_rate(dropout_rate)
    batch = mods.shape[0]
    seq, hidden = base.shape
    act, _ = _act_pair(w0, activation, sin5)
    act_last, _ = _sine_pair(w0, sin5)
    drop = _dropper(seed, dropout_rate, (batch, seq, hidden))
    m = mods.reshape(batch, num_layers, 1, hidden)

    x = (drop(base[None].expand(batch, seq, hidden), 0) * m[:, 0]).to(s_w.dtype)
    for i in range(num_layers - 1):
        pre = _dot(x, s_w[i]) + s_b[i]
        x = (drop(act(pre), i + 1) * m[:, i + 1]).to(s_w.dtype)
    r = (x.float() * last_w).sum(-1)
    return act_last(r + last_b[0, 0])


def siren_chain_train_bwd_reference(
    seed: torch.Tensor, mods: torch.Tensor, base: torch.Tensor, s_w: torch.Tensor,
    s_b: torch.Tensor, last_w: torch.Tensor, last_b: torch.Tensor, g: torch.Tensor, *,
    num_layers: int = 5, w0: float = 1.0, activation: str = "sine",
    dropout_rate: float = 0.0, sin5: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward kernel: the forward recomputed
    keeping the layer inputs, then the reverse sweep written out (three
    products per hidden layer), not taken from autograd.

    Inputs as the forward plus g (B, S) f32 -> (dmods (B, L*H), dbase
    (S, H), dsw (L-1, H, H), dsb (L-1, 1, H), dlw (1, H), dlb (1, 1)), all
    f32; the op casts dsw to ``s_w``'s dtype."""
    _check_rate(dropout_rate)
    batch = mods.shape[0]
    seq, hidden = base.shape
    mm = s_w.dtype
    act, dact = _act_pair(w0, activation, sin5)
    _, dact_last = _sine_pair(w0, sin5)
    drop = _dropper(seed, dropout_rate, (batch, seq, hidden))
    m = mods.reshape(batch, num_layers, 1, hidden)

    # rematerialised forward, keeping the layer inputs x_0 .. x_{L-1}
    b3 = drop(base[None].expand(batch, seq, hidden), 0)
    xs = [(b3 * m[:, 0]).to(mm)]
    for i in range(num_layers - 1):
        pre = _dot(xs[i], s_w[i]) + s_b[i]
        xs.append((drop(act(pre), i + 1) * m[:, i + 1]).to(mm))

    # last layer
    x_last = xs[num_layers - 1].float()
    pre_last = (x_last * last_w).sum(-1, keepdim=True) + last_b[0, 0]  # (B, S, 1)
    dpre_last = g[..., None] * dact_last(pre_last)
    dlw = (dpre_last * x_last).sum((0, 1))[None, :]
    dlb = dpre_last.sum().reshape(1, 1)
    dx = dpre_last * last_w

    dms = [None] * num_layers
    dsw, dsb = [None] * (num_layers - 1), [None] * (num_layers - 1)
    for i in range(num_layers - 2, -1, -1):
        pre = _dot(xs[i], s_w[i]) + s_b[i]
        dms[i + 1] = (dx * drop(act(pre), i + 1)).sum(1)
        dpre = drop(dx * m[:, i + 1], i + 1) * dact(pre)
        dpre_m = dpre.to(mm).float().reshape(batch * seq, hidden)
        dsw[i] = xs[i].float().reshape(batch * seq, hidden).t() @ dpre_m
        dsb[i] = dpre.sum((0, 1))[None, :]
        dx = (dpre_m @ s_w[i].float().t()).reshape(batch, seq, hidden)

    dms[0] = (dx * b3).sum(1)
    dbase = drop(dx * m[:, 0], 0).sum(0)
    return (torch.cat(dms, dim=1), dbase, torch.stack(dsw), torch.stack(dsb), dlw, dlb)


# ------------------------------------------------------------------ CUDA
@functools.lru_cache(maxsize=None)
def _fwd_library() -> ctypes.CDLL:
    lib = _build.load("siren_train_fwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.siren_train_fwd_launch.argtypes = [p] * 8 + [i, i, i, i, f, i, i, i, i, f, p]
    lib.siren_train_fwd_launch.restype = i
    lib.siren_train_fwd_error_string.argtypes = [i]
    lib.siren_train_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = _build.load("siren_train_bwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.siren_train_bwd_launch.argtypes = [p] * 15 + [i, i, i, i, f, i, i, i, i, f, p]
    lib.siren_train_bwd_launch.restype = i
    lib.siren_train_bwd_dw_splits.argtypes = [i, i, i, i]
    lib.siren_train_bwd_dw_splits.restype = i
    lib.siren_train_bwd_dbase_parts.argtypes = [i, i]
    lib.siren_train_bwd_dbase_parts.restype = i
    lib.siren_train_bwd_error_string.argtypes = [i]
    lib.siren_train_bwd_error_string.restype = ctypes.c_char_p
    lib.siren_train_bwd_tile_rows.argtypes = []
    lib.siren_train_bwd_tile_rows.restype = i
    return lib


def _check_chain_inputs(name, seed, mods, base, s_w, s_b, last_w, last_b, num_layers):
    batch = mods.shape[0]
    seq, hidden = base.shape
    dev = mods.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if hidden not in KERNEL_WIDTHS:
        raise ValueError(f"the CUDA kernel takes H in {KERNEL_WIDTHS}, got {hidden}")
    if num_layers < 2:
        raise ValueError(f"num_layers must be at least 2, got {num_layers}")
    if seed.device != dev or seed.dtype != torch.float32 or tuple(seed.shape) != (1,):
        raise ValueError(f"seed: expected float32 (1,) on {dev}")
    _check("mods", mods, (batch, num_layers * hidden), torch.float32, dev)
    _check("base", base, (seq, hidden), torch.float32, dev)
    _check("s_w", s_w, (num_layers - 1, hidden, hidden), torch.bfloat16, dev)
    _check("s_b", s_b, (num_layers - 1, 1, hidden), torch.float32, dev)
    _check("last_w", last_w, (1, hidden), torch.float32, dev)
    _check("last_b", last_b, (1, 1), torch.float32, dev)
    return batch, seq, hidden, dev


def _dropout_args(rate: float) -> tuple[int, int, float]:
    """(dropout flag, keep threshold, 1/keep) as the kernels take them."""
    _check_rate(rate)
    if rate <= 0.0:
        return 0, 0, 1.0
    keep = 1.0 - rate
    return 1, _keep_threshold(keep), float(np.float32(1.0 / keep))


def _transposed(s_w: torch.Tensor, s_wt: torch.Tensor | None, dev) -> torch.Tensor:
    """``s_w`` (L-1, H, H) transposed per layer to (out, in), the kernels'
    operand: ``s_wt`` where the caller made it, checked; made here otherwise."""
    if s_wt is None:
        s_wt = s_w.transpose(1, 2).contiguous()  # x . W reads W^T's rows
    _check("s_wt", s_wt, tuple(s_w.shape), torch.bfloat16, dev)
    return s_wt


def siren_chain_train_fwd_cuda(
    seed: torch.Tensor, mods: torch.Tensor, base: torch.Tensor, s_w: torch.Tensor,
    s_b: torch.Tensor, last_w: torch.Tensor, last_b: torch.Tensor, *,
    num_layers: int = 5, w0: float = 1.0, activation: str = "sine",
    dropout_rate: float = 0.0, sin5: bool = False, s_wt: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch ``csrc/siren_train_fwd.cu`` on PyTorch's current stream; same
    contract as :func:`siren_chain_train_fwd_reference` with bf16 ``s_w``,
    which the kernel reads as ``s_wt`` (see :func:`_transposed`). Counts its
    launches in ``siren_chain_train_fwd_cuda.launches``."""
    batch, seq, hidden, dev = _check_chain_inputs(
        "siren_chain_train_fwd_cuda", seed, mods, base, s_w, s_b, last_w, last_b, num_layers)
    s_wt = _transposed(s_w, s_wt, dev)
    on, thresh, inv_keep = _dropout_args(dropout_rate)
    out = torch.empty((batch, seq), dtype=torch.float32, device=dev)
    lib = _fwd_library()
    with torch.cuda.device(dev):
        err = lib.siren_train_fwd_launch(
            seed.data_ptr(), mods.data_ptr(), base.data_ptr(), s_wt.data_ptr(),
            s_b.data_ptr(), last_w.data_ptr(), last_b.data_ptr(), out.data_ptr(),
            batch, seq, hidden, num_layers, float(w0), int(activation == "morlet"),
            5 if sin5 else 9, on, thresh, inv_keep,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        msg = lib.siren_train_fwd_error_string(err).decode()
        raise RuntimeError(f"siren_train_fwd launch failed: {msg} ({err})")
    siren_chain_train_fwd_cuda.launches += 1
    return out


siren_chain_train_fwd_cuda.launches = 0


def siren_chain_train_bwd_cuda(
    seed: torch.Tensor, mods: torch.Tensor, base: torch.Tensor, s_w: torch.Tensor,
    s_b: torch.Tensor, last_w: torch.Tensor, last_b: torch.Tensor, g: torch.Tensor, *,
    num_layers: int = 5, w0: float = 1.0, activation: str = "sine",
    dropout_rate: float = 0.0, sin5: bool = False, s_wt: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """Launch ``csrc/siren_train_bwd.cu`` (the chain kernel, the
    weight-gradient kernel and its fixed-order sum) on PyTorch's current
    stream; same contract as :func:`siren_chain_train_bwd_reference` with
    bf16 ``s_w`` (and its transpose ``s_wt``, see :func:`_transposed`). The
    chain kernel writes the bf16 layer inputs and
    bf16(dpre) of every hidden layer to a workspace of 2 * (L-1) * B * S * H
    bf16, which the weight-gradient kernel reads; it adds the dbase terms of
    a block's patches, in patch order, into an f32 partial per block
    (``parts`` of S x H), which a small kernel sums in order, and writes
    dmods, dsb, dlw and dlb as one partial record per (patch, 64-row tile),
    summed here. All six gradients repeat bit for bit from call to call.
    Counts one launch per call in
    ``siren_chain_train_bwd_cuda.launches``."""
    batch, seq, hidden, dev = _check_chain_inputs(
        "siren_chain_train_bwd_cuda", seed, mods, base, s_w, s_b, last_w, last_b, num_layers)
    _check("g", g, (batch, seq), torch.float32, dev)
    on, thresh, inv_keep = _dropout_args(dropout_rate)
    lib = _bwd_library()
    tiles = -(-seq // lib.siren_train_bwd_tile_rows())
    splits = lib.siren_train_bwd_dw_splits(batch, seq, hidden, num_layers)
    f32 = dict(dtype=torch.float32, device=dev)
    layers, lh = num_layers - 1, num_layers * hidden
    s_wt = _transposed(s_w, s_wt, dev)
    work = torch.empty((2, layers, batch, seq, hidden), dtype=torch.bfloat16, device=dev)
    partial = torch.empty((layers, splits, hidden, hidden), **f32)
    dsw = torch.empty((layers, hidden, hidden), **f32)
    part = torch.empty((batch, tiles, 2 * lh + 4), **f32)
    dbase = torch.empty((seq, hidden), **f32)
    parts = lib.siren_train_bwd_dbase_parts(batch, seq)
    dbase_part = torch.empty((parts, seq, hidden), **f32)
    with torch.cuda.device(dev):
        err = lib.siren_train_bwd_launch(
            seed.data_ptr(), mods.data_ptr(), base.data_ptr(), s_w.data_ptr(),
            s_wt.data_ptr(), s_b.data_ptr(), last_w.data_ptr(), last_b.data_ptr(),
            g.data_ptr(), part.data_ptr(), dbase.data_ptr(), dbase_part.data_ptr(),
            dsw.data_ptr(), work.data_ptr(), partial.data_ptr(), batch, seq, hidden, num_layers, float(w0),
            int(activation == "morlet"), 5 if sin5 else 9, on, thresh, inv_keep,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        msg = lib.siren_train_bwd_error_string(err).decode()
        raise RuntimeError(f"siren_train_bwd launch failed: {msg} ({err})")
    siren_chain_train_bwd_cuda.launches += 1
    rest = part[:, :, lh:].sum((0, 1))
    dsb = rest[:layers * hidden].view(layers, 1, hidden)
    dlw = rest[layers * hidden:lh].view(1, hidden)
    return part[:, :, :lh].sum(1), dbase, dsw, dsb, dlw, rest[lh:lh + 1].view(1, 1)


siren_chain_train_bwd_cuda.launches = 0


# ------------------------------------------------------------------ the op
class _SirenChainTrain(torch.autograd.Function):
    """Kernels for CUDA tensors, plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, mods, base, s_w, s_b, last_w, last_b, seed, knobs):
        kw = dict(knobs)
        if mods.device.type == "cuda":
            # W^T once per call, for both kernels
            mods, card = mods.contiguous(), dict(s_wt=s_w.transpose(1, 2).contiguous())
            out = siren_chain_train_fwd_cuda(seed, mods, base, s_w, s_b, last_w, last_b,
                                             **kw, **card)
        elif mods.device.type == "cpu":
            card = {}
            out = siren_chain_train_fwd_reference(seed, mods, base, s_w, s_b, last_w, last_b,
                                                  **kw)
        else:
            raise ValueError(f"unsupported device {mods.device}")
        ctx.save_for_backward(seed, mods, base, s_w, s_b, last_w, last_b)
        ctx.knobs, ctx.card = kw, card
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        seed, mods, *rest = ctx.saved_tensors
        if mods.device.type == "cuda":
            fn, g = functools.partial(siren_chain_train_bwd_cuda, **ctx.card), g.contiguous()
        else:
            fn = siren_chain_train_bwd_reference
        dmods, dbase, dsw, dsb, dlw, dlb = fn(seed, mods, *rest, g, **ctx.knobs)
        s_w = rest[1]
        return dmods, dbase, dsw.to(s_w.dtype), dsb, dlw, dlb, None, None


def _check_schedule_knobs(block_b: int, bwd_block_b: int) -> None:
    for name, v in (("block_b", block_b), ("bwd_block_b", bwd_block_b)):
        if not isinstance(v, int) or v <= 0:
            raise ValueError(f"{name} must be a positive integer, got {v!r}")


def siren_chain_train(
    kp: SirenKernelParams, mods: torch.Tensor, seed, *, num_layers: int = 5,
    w0: float = 1.0, activation: str = "sine", dropout_rate: float = 0.0,
    block_b: int = 8, bwd_block_b: int = 16, sin5: bool = False,
    dw_partials: bool = True,
) -> torch.Tensor:
    """(B, L*H) modulations -> (B, S) outputs; differentiable wrt ``mods``
    and the chain weights in ``kp`` through the fused forward / backward
    pair. ``seed``: an integer in [0, 2^23) or a (1,) float32 tensor holding
    one (float so that it travels like the JAX op's seed)."""
    _check_schedule_knobs(block_b, bwd_block_b)
    del dw_partials  # where the TPU kernel reduces dW; no meaning here
    knobs = (("num_layers", num_layers), ("w0", float(w0)), ("activation", activation),
             ("dropout_rate", float(dropout_rate)), ("sin5", bool(sin5)))
    return _SirenChainTrain.apply(mods, kp.base, kp.s_w, kp.s_b, kp.last_w, kp.last_b,
                                  seed_tensor(seed, mods.device), knobs)


def fused_train_apply(
    model, tiles: torch.Tensor, seed, *, deterministic: bool = False,
    block_b: int = 8, bwd_block_b: int | None = None,
    mm_dtype: torch.dtype = torch.bfloat16, sin5: bool = False,
    dw_partials: bool = True,
) -> torch.Tensor:
    """Differentiable forward of the TRAIN step: conv encoder and modulator
    under autograd -> fused SIREN chain -> (B, siren, siren). Drop-in for
    ``model(tiles)`` in train mode up to the dropout stream (counter hash of
    ``seed`` here, ``F.dropout`` there)."""
    latent = model.encode(tiles)
    s = model.siren_patch_size
    kp = extract_kernel_params(model, coordinate_grid(s, tiles.device), mm_dtype=mm_dtype)
    mods = compute_modulations(kp, latent.float(), num_layers=model.num_layers)
    rate = 0.0 if deterministic else float(model.dropout)
    if bwd_block_b is None:
        bwd_block_b = 8 if model.activation == "morlet" else 16
    out = siren_chain_train(
        kp, mods, seed, num_layers=model.num_layers, w0=model.w0,
        activation=model.activation, dropout_rate=rate, block_b=block_b,
        bwd_block_b=bwd_block_b, sin5=sin5, dw_partials=dw_partials,
    )
    return out.reshape(tiles.shape[0], s, s)
