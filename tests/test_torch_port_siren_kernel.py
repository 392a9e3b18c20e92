"""The port's fused forward against the JAX package's at full width (H=256,
L=5, S=576): the plain PyTorch version of the CUDA kernel against the Pallas
kernel in interpret mode, same weights and latents.

Both round activations to bf16 at the same points and multiply bf16 inputs
exactly in f32, so they differ only by summation order; a pre-activation can
then round to the neighbouring bf16 value, rarely. Measured: max ~3.5e-6,
mean ~4e-9. Bar: max 1e-4, mean 1e-6.

``sin_bf16`` has a small systematic gap (measured max ~4e-5 / mean ~1.7e-5;
bar 1e-3 / 1e-4). Its source: XLA on the CPU allows excess precision by
default, and inside the interpreted kernel it drops the bf16 rounding of the
polynomial's last product where that product is widened to f32 straight
after (the last layer's ``act(...).astype(f32)``). Skipping that one
rounding in the port's version takes the mean gap from 7e-3 to 1.6e-5 on a
one-layer probe. The port rounds every bf16 operation, as the JAX code is
written and as JAX does outside the kernel (``fast_sin7_bf16`` on its own is
bit-identical, tests/test_torch_port_fast_math.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.models.modulated_siren import ModulatedSiren as JaxModel
from mri_inr_tpu.models.modulated_siren import coordinate_grid as jax_grid
from mri_inr_tpu.ops import siren_kernel as jsk
from mri_inr_tpu_torch.interop import load_flax_params
from mri_inr_tpu_torch.models.modulated_siren import ModulatedSiren, coordinate_grid
from mri_inr_tpu_torch.ops import siren_kernel as tsk

# the test workers share the cores: one torch thread each, so no idle
# OpenMP pool spins against the other workers
torch.set_num_threads(1)

WIDTHS = dict(dim_hidden=256, latent_dim=256, num_layers=5, dropout=0.0)


def _setup(activation):
    tiles = np.random.default_rng(3).uniform(size=(16, 32, 32)).astype(np.float32)
    jm = JaxModel(activation=activation, **WIDTHS)
    params = jax.device_get(jax.jit(jm.init)(jax.random.key(0), jnp.asarray(tiles))["params"])
    tm = ModulatedSiren(activation=activation, device="cpu", **WIDTHS).eval()
    load_flax_params(tm, params)
    latents = np.array(jm.apply({"params": params}, jnp.asarray(tiles), method=jm.encode))
    jkp = jsk.extract_kernel_params(params, jax_grid(24), num_layers=5,
                                    activation=activation)
    with torch.no_grad():
        tkp = tsk.extract_kernel_params(tm, coordinate_grid(24))
    return dict(jm=jm, params=params, tm=tm, tiles=tiles, latents=latents,
                jkp=jkp, tkp=tkp)


@pytest.fixture(scope="module")
def sine():
    return _setup("sine")


@pytest.fixture(scope="module")
def morlet():
    return _setup("morlet")


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("which", ["sine", "morlet"])
def test_extract_kernel_params(which, request):
    """Weights are repacked bit for bit. ``base`` goes through each
    framework's own exact ``sin`` and ``exp``, which differ in the last
    ulp: 1e-6."""
    s = request.getfixturevalue(which)
    for name in tsk.SirenKernelParams._fields:
        want = np.asarray(getattr(s["jkp"], name).astype(jnp.float32))
        got = _np(getattr(s["tkp"], name))
        assert got.shape == want.shape, name
        assert getattr(s["tkp"], name).dtype == (
            torch.bfloat16 if name in ("m0_w", "mh_w", "mz_w", "s_w") else torch.float32)
        if name == "base":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_compute_modulations(sine):
    want = np.asarray(jsk.compute_modulations(sine["jkp"], jnp.asarray(sine["latents"])))
    with torch.no_grad():
        got = tsk.compute_modulations(sine["tkp"], torch.from_numpy(sine["latents"])).numpy()
    assert got.shape == (16, 5 * 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _same_kernel_params(s):
    """The JAX repacking as torch tensors, so both chains start from
    bit-identical inputs (base included)."""
    return tsk.SirenKernelParams(*[
        torch.from_numpy(np.array(getattr(s["jkp"], f).astype(jnp.float32)))
        .to(getattr(s["tkp"], f).dtype)
        for f in tsk.SirenKernelParams._fields
    ])


CHAIN_CASES = [
    ("sine", dict(sin5=True), 1e-4, 1e-6),
    ("sine", dict(sin7=True), 1e-4, 1e-6),
    ("sine", dict(), 1e-4, 1e-6),
    ("morlet", dict(sin5=True), 1e-4, 1e-6),
    ("morlet", dict(), 1e-4, 1e-6),
    ("sine", dict(sin_bf16=True), 1e-3, 1e-4),
    ("morlet", dict(sin_bf16=True), 1e-3, 1e-4),
    ("sine", dict(sin5=True, sin_bf16=True), 1e-4, 1e-6),
]


@pytest.mark.parametrize("which,knobs,tol_max,tol_mean", CHAIN_CASES)
def test_plain_version_matches_pallas_interpret(which, knobs, tol_max, tol_mean, request):
    s = request.getfixturevalue(which)
    want = np.asarray(jsk.fused_siren_forward(
        s["jkp"], jnp.asarray(s["latents"]), activation=which, interpret=True,
        block_b=16, **knobs))
    before = tsk.siren_forward_cuda.launches
    with torch.no_grad():
        got = tsk.fused_siren_forward(
            _same_kernel_params(s), torch.from_numpy(s["latents"]),
            activation=which, block_b=16, **knobs).numpy()
    assert tsk.siren_forward_cuda.launches == before  # CPU: plain version
    assert got.shape == want.shape == (16, 576)
    err = np.abs(got - want)
    assert err.max() <= tol_max
    assert err.mean() <= tol_mean


@pytest.mark.parametrize("knobs", [dict(), dict(sin5=True)], ids=["sin7", "sin5"])
def test_fused_forward_matches_jax(sine, knobs):
    """Whole forward from tiles: encoder, repacking (own ``base``),
    modulator and chain."""
    want = np.asarray(jsk.fused_forward(sine["jm"], sine["params"],
                                        jnp.asarray(sine["tiles"]), interpret=True,
                                        block_b=16, **knobs))
    got = tsk.fused_forward(sine["tm"], torch.from_numpy(sine["tiles"]),
                            block_b=16, **knobs).numpy()
    assert got.shape == want.shape == (16, 24, 24)
    err = np.abs(got - want)
    assert err.max() <= 1e-4
    assert err.mean() <= 1e-6


def test_batch_padding(sine):
    """A batch that is not a multiple of ``block_b`` is padded and trimmed;
    rows are independent, so the first 5 of 9 agree."""
    tiles = torch.from_numpy(sine["tiles"])
    full = tsk.fused_forward(sine["tm"], tiles[:9], block_b=4)
    small = tsk.fused_forward(sine["tm"], tiles[:5], block_b=4)
    assert small.shape == (5, 24, 24)
    np.testing.assert_allclose(small.numpy(), full[:5].numpy(), rtol=0, atol=1e-6)


def test_schedule_knobs_are_validated_and_ignored(sine):
    kp, lat = sine["tkp"], torch.from_numpy(sine["latents"])
    with torch.no_grad():
        ref = tsk.fused_siren_forward(kp, lat, block_b=8)
        got = tsk.fused_siren_forward(kp, lat, block_b=8, ksplit=2, streams=2)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        with pytest.raises(ValueError, match="ksplit"):
            tsk.fused_siren_forward(kp, lat, ksplit=4)
        with pytest.raises(ValueError, match="streams"):
            tsk.fused_siren_forward(kp, lat, block_b=8, streams=3)


def test_make_apply_fn_routes(sine):
    tiles = torch.from_numpy(sine["tiles"][:4])
    fused = tsk.make_apply_fn(sine["tm"], device="cpu", sin5=True)
    np.testing.assert_allclose(
        fused(tiles).numpy(),
        tsk.fused_forward(sine["tm"], tiles, block_b=16, sin5=True).numpy(), atol=0)
    with torch.no_grad():
        module_out = sine["tm"](tiles)
    plain = tsk.make_apply_fn(sine["tm"], device="cpu", use_pallas=False)
    torch.testing.assert_close(plain(tiles), module_out, rtol=0, atol=0)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_make_apply_fn_packs_once_and_after_updates(sine, quantized):
    """The fused apply function packs the weights (and W^T, the CUDA kernel's
    operand) when it is made, not on each call; after an optimizer step on
    the model it repacks, and its output is then that of a fresh repack, bit
    for bit."""
    import copy

    tm = copy.deepcopy(sine["tm"])
    tiles = torch.from_numpy(sine["tiles"][:4])
    apply = tsk.make_apply_fn(tm, device="cpu", sin5=True, quantized=quantized)
    first = [apply(tiles) for _ in range(3)]
    assert apply.pack.packs == 1
    assert all(torch.equal(x, first[0]) for x in first)
    kp, _, s_wt = apply.pack()
    assert s_wt.is_contiguous() and torch.equal(s_wt, kp.s_w.transpose(1, 2))

    opt = torch.optim.SGD(tm.parameters(), lr=0.5)
    tm(tiles).square().mean().backward()
    opt.step()
    after = apply(tiles)
    assert apply.pack.packs == 2
    fresh = tsk.fused_forward(tm, tiles, block_b=16, sin5=True, quantized=quantized)
    torch.testing.assert_close(after, fresh, rtol=0, atol=0)
    assert not torch.equal(after, first[0])
    apply(tiles)
    assert apply.pack.packs == 2
    with torch.no_grad():  # a parameter replaced by a new tensor repacks too
        tm.net.last_layer.bias = torch.nn.Parameter(tm.net.last_layer.bias + 1.0)
    torch.testing.assert_close(
        apply(tiles), tsk.fused_forward(tm, tiles, block_b=16, sin5=True, quantized=quantized),
        rtol=0, atol=0)
    assert apply.pack.packs == 3


def test_residual_models_take_the_module_path():
    tm = ModulatedSiren(dim_hidden=64, latent_dim=32, num_layers=3, residual=True,
                        device="cpu")
    tiles = torch.rand(3, 32, 32, generator=torch.Generator().manual_seed(0))
    apply = tsk.make_apply_fn(tm, device="cpu")
    assert apply.func is tsk._module_apply
    with torch.no_grad():
        torch.testing.assert_close(apply(tiles), tm(tiles), rtol=0, atol=0)


def test_quantized_takes_the_int8_chain(sine):
    """``quantized=True`` runs (tests/test_torch_port_int8_kernel.py holds it
    to the JAX package); its output is near the bf16 chain's, not equal."""
    tiles = torch.from_numpy(sine["tiles"][:2])
    got = tsk.fused_forward(sine["tm"], tiles, quantized=True)
    ref = tsk.fused_forward(sine["tm"], tiles)
    assert got.shape == ref.shape == (2, 24, 24)
    assert 0 < float((got - ref).abs().max()) < 2e-2


def test_make_apply_fn_checks_the_model_device(sine):
    with pytest.raises((ValueError, RuntimeError)):
        tsk.make_apply_fn(sine["tm"], device="cuda")
