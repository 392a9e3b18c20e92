"""Phantom MRI volumes made on the device from a seed (a batched PyTorch
copy of the repository's ``data/synthetic.py`` phantom): a head ellipse of
intensity 0.35 with ``ellipses`` random ellipses added inside it,
optionally band-limited texture, min-max to [0, 1] per slice; the centred
orthonormal k-space of the image, optionally times a smooth phase map (four
random 2-D cosines, at most two cycles across the field of view).

Every draw comes from one ``torch.Generator`` on the device, in a few large
calls, so the same seed gives the same volumes and set-up stays short.
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    return g


def images(n: int, height: int, width: int, gen: torch.Generator, *, ellipses: int = 8,
           texture: float = 0.0) -> torch.Tensor:
    """(n, H, W) float32 magnitude slices in [0, 1]."""
    dev = gen.device
    yy = ((torch.arange(height, device=dev) - height / 2) / (height / 2))[:, None]
    xx = ((torch.arange(width, device=dev) - width / 2) / (width / 2))[None, :]
    outer = (((yy / 0.9) ** 2 + (xx / 0.7) ** 2) < 1.0).float()
    img = 0.35 * outer.expand(n, height, width).clone()
    u = torch.rand((6, n, ellipses, 1, 1), generator=gen, device=dev)
    cy, cx = u[0] - 0.5, u[1] - 0.5
    ry, rx = 0.08 + 0.32 * u[2], 0.08 + 0.32 * u[3]
    theta, amp = math.pi * u[4], -0.4 + u[5]
    cos, sin = torch.cos(theta), torch.sin(theta)
    for e in range(ellipses):
        dy, dx = yy - cy[:, e], xx - cx[:, e]
        yr = dy * cos[:, e] + dx * sin[:, e]
        xr = -dy * sin[:, e] + dx * cos[:, e]
        img += amp[:, e] * (((yr / ry[:, e]) ** 2 + (xr / rx[:, e]) ** 2) < 1.0)
    if texture > 0.0:
        noise = torch.randn((n, height, width), generator=gen, device=dev)
        fy = torch.fft.fftfreq(height, device=dev)[:, None]
        fx = torch.fft.fftfreq(width, device=dev)[None, :]
        lp = torch.exp(-(fy**2 + fx**2) / (2 * 0.06**2))
        smooth = torch.fft.ifft2(torch.fft.fft2(noise) * lp).real
        smooth /= smooth.abs().amax((-2, -1), keepdim=True).clamp_min(1e-12)
        img += texture * smooth
    img *= outer
    img -= img.amin((-2, -1), keepdim=True)
    top = img.amax((-2, -1), keepdim=True)
    return torch.where(top > 0, img / torch.where(top > 0, top, 1.0), img)


def phase_maps(n: int, height: int, width: int, gen: torch.Generator,
               components: int = 4) -> torch.Tensor:
    dev = gen.device
    yy = (torch.arange(height, device=dev) / height)[:, None]
    xx = (torch.arange(width, device=dev) / width)[None, :]
    u = torch.rand((4, n, components, 1, 1), generator=gen, device=dev)
    fy, fx = -2.0 + 4.0 * u[0], -2.0 + 4.0 * u[1]
    amp, off = 0.4 + 1.2 * u[2], 2 * math.pi * u[3]
    return (amp * torch.cos(2 * math.pi * (fy * yy + fx * xx) + off)).sum(1)


def kspace(imgs: torch.Tensor, phase: torch.Tensor | None = None) -> torch.Tensor:
    """(..., H, W) images -> complex64 centred orthonormal k-space."""
    x = imgs.to(torch.complex64)
    if phase is not None:
        x = x * torch.polar(torch.ones_like(phase), phase)
    x = torch.fft.ifftshift(x, dim=(-2, -1))
    x = torch.fft.fft2(x, dim=(-2, -1), norm="ortho")
    return torch.fft.fftshift(x, dim=(-2, -1))


def volumes(count: int, slices: int, size: int, gen: torch.Generator, *, texture: float = 0.0,
            phase: bool = False, ellipses: int = 8) -> torch.Tensor:
    """(count, slices, size, size) complex64 k-space on the generator's
    device."""
    n = count * slices
    img = images(n, size, size, gen, ellipses=ellipses, texture=texture)
    ph = phase_maps(n, size, size, gen) if phase else None
    return kspace(img, ph).reshape(count, slices, size, size)
