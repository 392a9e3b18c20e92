"""The operations and bytes the benchmark's work needs, from the
configuration's shapes, and the peaks it is measured against.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates), as the
repository's ``chip_smoke.py`` states them: 989 TFLOP/s bf16 on the tensor
cores, 67 TFLOP/s float32 outside them, 3.35 TB/s of HBM3. No integer unit
of the card is faster than the float32 rate, so integer work counted at it
gives a bound that a kernel cannot beat.

Model FLOP count each multiply-add as two operations and nothing that a
program recomputes: a training step is three forward passes' worth (the
forward, and the two products of the backward per layer).
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

#: float32 operations of one polynomial sine of degree d: its range
#: reduction (mul, add, floor, mul, sub), v * v, (d - 1) / 2 fused
#: multiply-adds, v * p (``chip_smoke.py``'s count)
SIN_F32 = {d: 5 + 1 + 2 * (d - 1) // 2 + 1 for d in (5, 7, 9)}


def _conv_out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def encoder_flops(outer: int, latent: int) -> int:
    """One patch through the ``custom`` conv encoder."""
    s1 = _conv_out(outer, 3, 2, 1)
    s2 = _conv_out(s1, 3, 2, 1)
    s3 = _conv_out(s2, 8, 1, 0)
    return 2 * (s1 * s1 * 16 * 9 + s2 * s2 * 32 * 16 * 9 + s3 * s3 * 64 * 32 * 64
                + s3 * s3 * 64 * latent)


def modulator_flops(latent: int, hidden: int, layers: int) -> int:
    return 2 * (latent * hidden + (layers - 1) * (hidden + latent) * hidden)


def siren_flops(seq: int, hidden: int, layers: int) -> int:
    """One patch's SIREN: the first layer from 2 coordinates, the hidden
    layers, the output layer."""
    return 2 * seq * (2 * hidden + (layers - 1) * hidden * hidden + hidden)


def model_forward_flops(m: dict) -> int:
    """One patch through the whole model; ``m`` is a configuration's
    ``model`` section."""
    seq = m["siren_patch_size"] ** 2
    return (encoder_flops(m["outer_patch_size"], m["latent_dim"])
            + modulator_flops(m["latent_dim"], m["dim_hidden"], m["num_layers"])
            + siren_flops(seq, m["dim_hidden"], m["num_layers"]))


def chain_products(batch: int, seq: int, hidden: int, layers: int) -> int:
    """FLOP of one pass of the hidden chain's products: 2 B S H^2 (L-1)."""
    return 2 * batch * seq * hidden * hidden * (layers - 1)


def chain_bytes(batch: int, seq: int, hidden: int, layers: int, *, grads: bool) -> int:
    """Each input byte of a chain kernel call once and each output byte once:
    the modulations (f32), the first layer's base (f32), the hidden weights
    (bf16) and biases, the output layer's weights; out the (B, S) outputs,
    or for the backward the (B, S) cotangent in and the gradients of all
    of those out."""
    ins = 4 + batch * layers * hidden * 4 + seq * hidden * 4 + (layers - 1) * hidden * hidden * 2 \
        + (layers - 1) * hidden * 4 + hidden * 4 + 4
    if not grads:
        return ins + batch * seq * 4
    outs = batch * layers * hidden * 4 + seq * hidden * 4 + (layers - 1) * hidden * hidden * 4 \
        + (layers - 1) * hidden * 4 + hidden * 4 + 4
    return ins + batch * seq * 4 + outs


def chain_f32_ops(batch: int, seq: int, hidden: int, layers: int, kind: str) -> int:
    """float32 operations outside the tensor cores that a chain call needs
    (``chip_smoke.py:siren_f32_ops``, with the backward's recomputed
    forward left out): per hidden activation, and per element of the first
    layer's output."""
    acts = batch * seq * hidden * (layers - 1)
    elems = batch * seq * hidden
    if kind == "eval":  # bias, w0, sine (degree 5), modulation, rounding; x_0
        return acts * (4 + SIN_F32[5]) + elems * 2
    if kind == "train_fwd":  # bias, w0, sine, dropout, modulation, rounding; x_0 as well
        return acts * (5 + SIN_F32[5]) + elems * (2 + 3)
    if kind == "train_bwd":  # reverse only: bias, w0, sine, cosine, w0 * cos, dmods,
        # dpre, dsb, rounding; layer 0's dmods and dbase
        return acts * (1 + 1 + SIN_F32[5] + SIN_F32[5] + 1 + 1 + 3 + 3 + 1 + 1) + elems * 6
    raise ValueError(kind)


def bound_seconds(tensor_flops: float, f32_ops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, and the term that sets it."""
    terms = {"bf16 tensor operations": tensor_flops / PEAK_BF16_FLOPS,
             "f32 operations": f32_ops / PEAK_F32_FLOPS, "bytes": nbytes / PEAK_BYTES}
    term = max(terms, key=terms.get)
    return terms[term], term


#: integer operations of one element of a Threefry-2x32 keep mask (20
#: rounds of add, rotate (two shifts and an or) and xor, 5 key injections of
#: two adds, the counter split, the float conversion and compare): the
#: count ``PERF.md`` row 6 uses
THREEFRY_OPS_PER_ELEMENT = 85
