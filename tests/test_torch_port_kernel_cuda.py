"""The hand-written CUDA kernel (``ops/csrc/siren_forward.cu``) against its
plain PyTorch version, on the card. Skips without one.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_port_kernel_cuda.py -q

Tolerances: the kernel and the plain version take the same bf16 inputs and
accumulate in f32 in a different order, so a pre-activation may differ in
its last bits and, rarely, round to the neighbouring bf16 value; that moves
an output by up to ~1e-4. Max 1e-3 / mean 1e-5 leaves a margin. The bf16
polynomial (``sin_bf16``) amplifies such flips: 2e-2 / 1e-3.
"""

import pytest
import torch

from mri_inr_tpu_torch.models.modulated_siren import ModulatedSiren, coordinate_grid
from mri_inr_tpu_torch.ops import siren_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(device, hidden, layers, siren, batch, activation="sine"):
    g = torch.Generator().manual_seed(0)
    model = ModulatedSiren(dim_hidden=hidden, latent_dim=hidden,
                           num_layers=layers, dropout=0.0, siren_patch_size=siren,
                           activation=activation, generator=g, device=device).eval()
    tiles = torch.rand((batch, 32, 32), generator=g).to(device)
    with torch.no_grad():
        kp = siren_kernel.extract_kernel_params(model, coordinate_grid(siren, device))
        mods = siren_kernel.compute_modulations(kp, model.encode(tiles), num_layers=layers)
        cut = (layers - 1) * hidden
        mods = torch.cat([mods[:, :cut], mods[:, cut:] * kp.last_w], dim=1).contiguous()
    return mods, kp


CASES = [
    # (hidden, layers, siren, batch, activation, knobs, max, mean)
    (256, 5, 24, 96, "sine", dict(sin5=True), 1e-3, 1e-5),
    (256, 5, 24, 96, "sine", dict(sin7=True), 1e-3, 1e-5),
    (256, 5, 24, 96, "sine", dict(), 1e-3, 1e-5),
    (256, 5, 24, 96, "morlet", dict(sin5=True), 1e-3, 1e-5),
    (256, 5, 24, 96, "sine", dict(sin_bf16=True), 2e-2, 1e-3),
    (64, 3, 20, 37, "sine", dict(sin5=True), 1e-3, 1e-5),  # S=400: ragged tile
    (128, 2, 24, 5, "morlet", dict(), 1e-3, 1e-5),
    (192, 4, 24, 9, "sine", dict(sin7=True, sin_bf16=True), 2e-2, 1e-3),
]


@pytest.mark.parametrize("hidden,layers,siren,batch,activation,knobs,tol_max,tol_mean", CASES)
def test_kernel_matches_plain_version(device, hidden, layers, siren, batch,
                                      activation, knobs, tol_max, tol_mean):
    mods, kp = _inputs(device, hidden, layers, siren, batch, activation)
    args = (mods, kp.base, kp.s_w, kp.s_b, kp.last_b)
    kw = dict(num_layers=layers, activation=activation, **knobs)
    before = siren_kernel.siren_forward_cuda.launches
    got = siren_kernel.siren_forward_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert siren_kernel.siren_forward_cuda.launches == before + 1
    want = siren_kernel.siren_forward_reference(*args, **kw)
    assert got.shape == want.shape == (batch, siren * siren)
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    assert err.max().item() <= tol_max
    assert err.mean().item() <= tol_mean


def test_dispatch_goes_to_the_kernel(device):
    mods, kp = _inputs(device, 64, 3, 24, 4)
    before = siren_kernel.siren_forward_cuda.launches
    siren_kernel.siren_forward(mods, kp.base, kp.s_w, kp.s_b, kp.last_b, num_layers=3)
    assert siren_kernel.siren_forward_cuda.launches == before + 1


def test_kernel_rejects_bad_inputs(device):
    mods, kp = _inputs(device, 64, 3, 24, 4)
    with pytest.raises(ValueError, match="s_w"):
        siren_kernel.siren_forward_cuda(mods, kp.base, kp.s_w.float(), kp.s_b,
                                        kp.last_b, num_layers=3)
    with pytest.raises(ValueError, match="mods"):
        siren_kernel.siren_forward_cuda(mods[:, ::2], kp.base, kp.s_w, kp.s_b,
                                        kp.last_b, num_layers=3)
