"""The modulated SIREN, plainly (Mehta et al., "Modulated periodic
activations for generalizable local functional representations", ICCV 2021,
as the reference MRI repository configures it): a conv encoder gives a latent
per 32x32 patch, a modulator MLP turns it into one FiLM vector per SIREN
layer, and the SIREN maps the 24x24 coordinate grid of the patch's centre to
intensities.

- encoder (``custom``): conv 3x3/2 (1->16), conv 3x3/2 (16->32), conv 8x8
  valid (32->64), LeakyReLU(0.2) after each, flatten (channels last), dense
  to the latent;
- modulator: ``m_0 = relu(W_0 z + b_0)``, ``m_i = relu(W_i [m_{i-1}, z] +
  b_i)``;
- SIREN: coordinates ``linspace(-1, 1, 24)`` on an ij grid; layer 0 ``sin(30
  (W x + b))``, hidden layer i ``sin(W x + b)``; after each hidden layer's
  sine its dropout, then the product with ``m_i``; with ``residual`` the
  hidden layers after the first add their input; the output layer ``sin(W x
  + b)`` with no dropout and no modulation.

Weights come as a dict of float32 tensors named as the benchmark names them
(``net.layers.i.weight`` (out, in), ``modulator.layers.i.*``,
``encoder.encoder.conv1.*`` ...). Everything runs in float32 with TF32 off.
``sines`` gives the polynomial the configuration states for the hidden and
output sines (degree 5, 7 or 9, the minimax coefficients below over [-pi,
pi] after reduction by 2 pi); ``None`` is ``torch.sin``. Layer 0 is always
``torch.sin``. ``cosine_grad``: the polynomial sine's gradient is the same
polynomial's cosine, as the configuration's fused route defines it.

``quant`` (the control, the reference a precision below the configuration's
bf16): every tensor a layer hands on rounded to float8 e4m3 with one scale
per tensor (its absolute maximum at 448): each product's two operands and
its result, each hidden layer's sine, its modulated output and the residual
sum; the products taken in float32. The first SIREN layer, a function of
the fixed coordinates alone, stays float32. The gradient handed back through
each of those results is rounded to float8 e5m2 with one scale per tensor
(its absolute maximum at 57344), as FP8 training recipes take e4m3 forward
and e5m2 backward; what a product's backward puts out (its inputs' and its
weight's gradients) stays float32 until the next rounding.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_TWO_PI, _INV_TWO_PI, _HALF_PI = 6.283185307179586, 0.15915494309189535, 1.5707963267948966
_POLY = {
    9: (9.999793973572e-01, -1.666243985636e-01, 8.308990402314e-03, -1.926507745066e-04,
        2.147913009143e-06),
    7: (9.992763920561e-01, -1.656675056348e-01, 7.958186419379e-03, -1.450852979995e-04),
    5: (9.8444443e-01, -1.5347773e-01, 5.4669000e-03),
}


def _poly_sine(x: torch.Tensor, degree: int) -> torch.Tensor:
    v = x - _TWO_PI * torch.floor(x.detach() * _INV_TWO_PI + 0.5)
    v2 = v * v
    coeffs = _POLY[degree]
    p = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        p = c + v2 * p
    return v * p


class _CosineGrad(torch.autograd.Function):
    """The polynomial sine whose derivative is the same polynomial's cosine,
    ``sine(x + pi / 2)``, and not the polynomial's own derivative."""

    @staticmethod
    def forward(ctx, x, degree):
        ctx.save_for_backward(x)
        ctx.degree = degree
        return _poly_sine(x, degree)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _poly_sine(x + _HALF_PI, ctx.degree), None


def sine(x: torch.Tensor, degree: int | None, cosine_grad: bool = False) -> torch.Tensor:
    """``sin(x)``, or the polynomial of ``degree``; with ``cosine_grad`` its
    gradient is the polynomial's cosine."""
    if degree is None:
        return torch.sin(x)
    if cosine_grad:
        return _CosineGrad.apply(x, degree)
    return _poly_sine(x, degree)


def _fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """e4m3 forward; with ``grad``, the gradient handed back e5m2."""

    @staticmethod
    def forward(ctx, x, grad):
        ctx.grad = grad
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return (_fp8(g, torch.float8_e5m2, 57344.0) if ctx.grad else g), None


def _q(x: torch.Tensor, quant: bool) -> torch.Tensor:
    """A product's operand: rounded forward only."""
    return _Fp8.apply(x, False) if quant else x


def _qh(x: torch.Tensor, quant: bool) -> torch.Tensor:
    """A tensor a layer hands on: rounded forward and its gradient backward."""
    return _Fp8.apply(x, True) if quant else x


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _dense(x, p, name, quant):
    y = F.linear(_q(x, quant), _q(p[f"{name}.weight"], quant), p[f"{name}.bias"])
    return _qh(y, quant)


def _conv(x, p, name, stride, padding, quant):
    y = F.conv2d(_q(x, quant), _q(p[f"{name}.weight"], quant), p[f"{name}.bias"],
                 stride=stride, padding=padding)
    return _qh(y, quant)


def encode(p: dict, patches: torch.Tensor, quant: bool = False) -> torch.Tensor:
    e = "encoder.encoder"
    x = patches.float()[:, None]
    x = F.leaky_relu(_conv(x, p, f"{e}.conv1", 2, 1, quant), 0.2)
    x = F.leaky_relu(_conv(x, p, f"{e}.conv2", 2, 1, quant), 0.2)
    x = F.leaky_relu(_conv(x, p, f"{e}.conv3", 1, 0, quant), 0.2)
    return _dense(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1), p, f"{e}.fc", quant)


def modulations(p: dict, z: torch.Tensor, layers: int, quant: bool = False) -> list:
    mods, x = [], z
    for i in range(layers):
        x = torch.relu(_dense(x, p, f"modulator.layers.{i}", quant))
        mods.append(x)
        x = torch.cat([x, z], dim=-1)
    return mods


def coords(size: int, device) -> torch.Tensor:
    lin = torch.linspace(-1.0, 1.0, size, dtype=torch.float32, device=device)
    ii, jj = torch.meshgrid(lin, lin, indexing="ij")
    return torch.stack([ii, jj], dim=-1).reshape(size * size, 2)


def forward(p: dict, patches: torch.Tensor, *, layers: int, residual: bool = False,
            sines: tuple = (None, None), w0: float = 1.0, w0_initial: float = 30.0,
            siren: int = 24, drop=None, quant: bool = False,
            cosine_grad: bool = False, first_in_compute_type: bool = False) -> torch.Tensor:
    """(B, 32, 32) patches -> (B, siren, siren). ``drop(x, layer)`` applies
    hidden layer ``layer``'s dropout (None: eval, no dropout)."""
    batch = patches.shape[0]
    mods = modulations(p, encode(p, patches, quant), layers, quant)
    c = coords(siren, patches.device)
    pre0 = (_dense(c, p, "net.layers.0", quant) if first_in_compute_type
            else F.linear(c, p["net.layers.0.weight"], p["net.layers.0.bias"]))
    base = torch.sin(w0_initial * pre0)
    x = base[None].expand(batch, -1, -1)
    if drop is not None:
        x = drop(x, 0)
    x = _qh(x * mods[0][:, None, :], quant)
    for i in range(1, layers):
        h = _qh(sine(w0 * _dense(x, p, f"net.layers.{i}", quant), sines[0], cosine_grad), quant)
        if drop is not None:
            h = drop(h, i)
        h = _qh(h * mods[i][:, None, :], quant)
        x = _qh(x + h, quant) if residual else h
    out = sine(w0 * _dense(x, p, "net.last_layer", quant), sines[1], cosine_grad)
    return out[..., 0].reshape(batch, siren, siren)
