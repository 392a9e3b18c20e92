"""The port's int8 SIREN chain against the JAX package's at full width
(H=256, L=5, S=576, 9 tiles: the setup of tests/test_siren_kernel.py): the
quantised weights and the per-patch factors, then the plain PyTorch version
of the CUDA kernel against the Pallas int8 kernel in interpret mode.

Both chains multiply the same int8 operands exactly, so they can differ
only where the last bits of a sine, an exponential or a factor move a
``floor`` across an integer: one quantum, about max(m) / 127 * max|w| ~ 1e-3
in one pre-activation, which reaches the output attenuated.

- Chain alone, the same factors and weights into both: no ``floor`` moved;
  measured max 1.5e-8 / mean 9.3e-10 (sine) and 1.5e-8 / 7.6e-10 (Morlet).
  Bar: max 1e-5, mean 1e-7.
- Whole forward from tiles, each side with its own ``base`` and factors (fq
  differs by up to 5.3e-5, gd by 4.5e-7 relative, so a few ``floor``s move):
  measured max 1.2e-4 / mean 2.5e-8 (sine), 2.1e-5 / 5.2e-9 (Morlet). Bar:
  max 1e-3, mean 1e-6.
- Against the f32 Flax path the bars are the JAX package's own, max < 5e-3
  and RMS < 1e-3 (measured 4.8e-4 / 1.4e-4).
"""

import warnings

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

torch.set_num_threads(1)

WIDTHS = dict(dim_hidden=256, latent_dim=256, num_layers=5, dropout=0.0)


def _setup(activation):
    tiles = np.random.default_rng(3).uniform(size=(9, 32, 32)).astype(np.float32)
    jm = JaxModel(activation=activation, **WIDTHS)
    params = jax.device_get(jax.jit(jm.init)(jax.random.key(0), jnp.asarray(tiles))["params"])
    tm = ModulatedSiren(activation=activation, device="cpu", **WIDTHS).eval()
    load_flax_params(tm, params)
    latents = np.array(jm.apply({"params": params}, jnp.asarray(tiles), method=jm.encode))
    jkp = jsk.extract_kernel_params(params, jax_grid(24), num_layers=5, activation=activation)
    jikp = jsk.quantize_kernel_params(params, jkp, num_layers=5)
    with torch.no_grad():
        tkp = tsk.extract_kernel_params(tm, coordinate_grid(24))
        tikp = tsk.quantize_kernel_params(tm, tkp)
    return dict(jm=jm, params=params, tm=tm, tiles=tiles, latents=latents, jkp=jkp,
                jikp=jikp, tkp=tkp, tikp=tikp)


@pytest.fixture(scope="module")
def sine():
    return _setup("sine")


@pytest.fixture(scope="module")
def morlet():
    return _setup("morlet")


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def test_quantize_kernel_params(sine):
    """From transplanted weights: the int8 weights are equal as integers,
    the scales within 1e-7 relative (one f32 division each)."""
    j, t = sine["jikp"], sine["tikp"]
    assert t.swq.dtype == torch.int8 and t.swq.shape == (4, 256, 256)
    np.testing.assert_array_equal(t.swq.numpy(), np.asarray(j.swq))
    np.testing.assert_allclose(t.sw_scale.numpy(), np.asarray(j.sw_scale), rtol=1e-7, atol=0)
    assert t.sw_scale.shape == (4, 1, 256)
    assert int(t.swq.abs().max()) == 127
    for name in ("s_b", "last_w", "last_b"):
        np.testing.assert_array_equal(getattr(t, name).detach().numpy(),
                                      np.asarray(getattr(j, name)))


def test_compute_quant_factors(sine):
    """fq, gd, ls against JAX, from the JAX package's repacked weights; ls is
    (B, 1) here and lane-broadcast to (B, 128) there."""
    jfq, jgd, jls = jsk.compute_quant_factors(sine["jkp"], sine["jikp"],
                                              jnp.asarray(sine["latents"]))
    kp = tsk.SirenKernelParams(*[
        _t(getattr(sine["jkp"], f).astype(jnp.float32), getattr(sine["tkp"], f).dtype)
        for f in tsk.SirenKernelParams._fields])
    ikp = sine["tikp"]._replace(sw_scale=_t(sine["jikp"].sw_scale))
    with torch.no_grad():
        fq, gd, ls = tsk.compute_quant_factors(kp, ikp, _t(sine["latents"]))
    assert fq.shape == (9, 5 * 256) and gd.shape == (9, 4 * 256) and ls.shape == (9, 1)
    # the modulations agree to 1e-5 absolute (summation order) and fq = m /
    # (max m / 127) magnifies that by 127 / max m: measured 5.3e-5
    np.testing.assert_allclose(fq.numpy(), np.asarray(jfq), rtol=0, atol=5e-4)
    np.testing.assert_allclose(gd.numpy(), np.asarray(jgd), rtol=1e-5, atol=0)
    np.testing.assert_allclose(ls.numpy(), np.asarray(jls)[:, :1], rtol=1e-5, atol=0)
    assert float(fq.max()) <= 127.0 + 1e-3 and float(fq.min()) >= 0.0


def _jax_factors(s):
    fq, gd, ls = jsk.compute_quant_factors(s["jkp"], s["jikp"], jnp.asarray(s["latents"]))
    return _t(fq), _t(gd), _t(ls)


@pytest.mark.parametrize("which", ["sine", "morlet"])
def test_plain_version_matches_pallas_interpret(which, request):
    """Same factors and weights into both chains (the JAX package's, as
    tensors), so only the chain is compared."""
    s = request.getfixturevalue(which)
    want = np.asarray(jsk.fused_siren_forward_int8(
        s["jkp"], s["jikp"], jnp.asarray(s["latents"]), activation=which, interpret=True,
        block_b=9))
    j = s["jikp"]
    before = tsk.siren_forward_int8_cuda.launches
    with torch.no_grad():
        got = tsk.siren_forward_int8(
            *_jax_factors(s), _t(j.base), _t(j.swq), _t(j.s_b), _t(j.last_w), _t(j.last_b),
            num_layers=5, activation=which).numpy()
    assert tsk.siren_forward_int8_cuda.launches == before  # CPU: plain version
    assert got.shape == want.shape == (9, 576)
    err = np.abs(got - want)
    assert err.max() <= 1e-5
    assert err.mean() <= 1e-7


@pytest.mark.parametrize("which", ["sine", "morlet"])
def test_fused_forward_int8_matches_jax_and_flax(which, request):
    """Whole forward from tiles with ``quantized=True``: against the JAX
    fused int8 forward (own base, own factors: the bars above) and against
    the f32 Flax path (the JAX package's bars)."""
    s = request.getfixturevalue(which)
    tiles = jnp.asarray(s["tiles"])
    want = np.asarray(jsk.fused_forward(s["jm"], s["params"], tiles, interpret=True,
                                        quantized=True, block_b=9))
    got = tsk.fused_forward(s["tm"], torch.from_numpy(s["tiles"]), quantized=True,
                            block_b=9).numpy()
    assert got.shape == want.shape == (9, 24, 24)
    err = np.abs(got - want)
    assert err.max() <= 1e-3
    assert err.mean() <= 1e-6
    flax = np.asarray(s["jm"].apply({"params": s["params"]}, tiles, deterministic=True))
    err = np.abs(got - flax)
    assert err.max() < 5e-3
    assert np.sqrt((err ** 2).mean()) < 1e-3


def test_int8_batch_padding(sine):
    tiles = torch.from_numpy(sine["tiles"])
    full = tsk.fused_forward(sine["tm"], tiles, block_b=4, quantized=True)
    small = tsk.fused_forward(sine["tm"], tiles[:5], block_b=4, quantized=True)
    assert small.shape == (5, 24, 24)
    np.testing.assert_allclose(small.numpy(), full[:5].numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="block_b"):
        tsk.fused_siren_forward_int8(sine["tkp"], sine["tikp"], torch.zeros(2, 256), block_b=0)


def test_quantized_warns_about_ignored_knobs(sine):
    """As in the JAX package: sin_bf16 / ksplit / sin7=False are ignored with
    a warning, sin5 (the eval default) silently."""
    tiles = torch.from_numpy(sine["tiles"][:2])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ref = tsk.fused_forward(sine["tm"], tiles, quantized=True, sin5=True)
    for knobs in (dict(sin_bf16=True), dict(ksplit=2), dict(sin7=False)):
        with pytest.warns(UserWarning, match="ignored"):
            got = tsk.fused_forward(sine["tm"], tiles, quantized=True, **knobs)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_make_apply_fn_quantized_route(sine):
    tiles = torch.from_numpy(sine["tiles"][:3])
    apply = tsk.make_apply_fn(sine["tm"], device="cpu", quantized=True, sin5=True)
    torch.testing.assert_close(
        apply(tiles), tsk.fused_forward(sine["tm"], tiles, quantized=True, block_b=16),
        rtol=0, atol=0)
    bf16 = tsk.make_apply_fn(sine["tm"], device="cpu", sin5=True)(tiles)
    assert 0 < float((apply(tiles) - bf16).abs().max()) < 2e-2


def test_make_apply_fn_quantizes_once(sine, monkeypatch):
    """``make_apply_fn(quantized=True)`` repacks and quantises the weights when
    it is called, not on every slice, and keeps the pack of ``swq`` that the
    CUDA kernel reads."""
    kp, ikp, _ = tsk.WeightPack(sine["tm"], quantized=True)()
    assert torch.equal(ikp.swq, sine["tikp"].swq)
    assert ikp.swq_t.is_contiguous()
    assert torch.equal(ikp.swq_t, tsk.int8_kernel_weights(ikp.swq))
    tiles = torch.from_numpy(sine["tiles"][:3])
    want = tsk.fused_forward(sine["tm"], tiles, quantized=True, block_b=16)
    torch.testing.assert_close(
        tsk.fused_forward(sine["tm"], tiles, quantized=True, block_b=16, packed=(kp, ikp)),
        want, rtol=0, atol=0)
    apply = tsk.make_apply_fn(sine["tm"], device="cpu", quantized=True)

    def refuse(*args, **kwargs):
        raise AssertionError("weights repacked on a call of the apply function")

    monkeypatch.setattr(tsk, "quantize_kernel_params", refuse)
    monkeypatch.setattr(tsk, "extract_kernel_params", refuse)
    torch.testing.assert_close(apply(tiles), want, rtol=0, atol=0)


def test_plain_version_products_are_exact(sine):
    """The float32 stand-in for the integer product equals an int64 product."""
    g = torch.Generator().manual_seed(0)
    xq = torch.randint(-127, 128, (64, 256), generator=g)
    wq = sine["tikp"].swq[0]
    want = xq @ wq.long()
    got = xq.float() @ wq.float()
    assert torch.equal(got.long(), want)


@pytest.mark.parametrize("hidden", [64, 192, 256])
def test_kernel_order_puts_a_threads_own_columns_in_its_fragment(hidden):
    """The CUDA kernel's accumulator map (thread t of a quad holds columns
    8j + 2t, + 1 of its rows) against the int8 A-fragment map of wgmma k32
    (register u of a row holds bytes 16u + 4t .. + 3 of each 32-block): the
    epilogue packs columns c, c + 1, c + 8, c + 9 (c = 8 (4kk + 2u) + 2t)
    into bytes 0..3 of that register, and the K order holds exactly those
    columns there."""
    perm = tsk.int8_k_order(hidden)
    assert sorted(perm.tolist()) == list(range(hidden))
    for kk in range(hidden // 32):
        for u in range(2):
            for t in range(4):
                c = 8 * (4 * kk + 2 * u) + 2 * t
                got = perm[32 * kk + 16 * u + 4 * t : 32 * kk + 16 * u + 4 * t + 4].tolist()
                assert got == [c, c + 1, c + 8, c + 9]


def _kernel_order_chain(fq, gd, ls, base, pack, s_b, last_w, last_b, num_layers):
    """siren_forward_int8_reference's chain, operation for operation, with
    the kernel's weight pack: (out, in) weights, and each layer input past
    the first in the kernel's contraction order."""
    batch, hidden = fq.shape[0], base.shape[1]
    perm = tsk.int8_k_order(hidden)

    def rows(t, layer):
        return t[:, layer * hidden : (layer + 1) * hidden].reshape(batch, 1, hidden)

    xq = torch.floor(base[None] * rows(fq, 0) + 0.5)
    for i in range(num_layers - 1):
        x = xq if i == 0 else xq[..., perm]
        acc = x @ pack[i].float().t()
        s3 = tsk.fast_sin(acc * rows(gd, i) + s_b[i].reshape(1, 1, hidden))
        if i < num_layers - 2:
            xq = torch.floor(s3 * rows(fq, i + 1) + 0.5)
    r = (s3 * rows(fq, num_layers - 1) * last_w.reshape(1, 1, hidden)).sum(-1)
    return tsk.fast_sin(r * ls[:, :1] + last_b[0, 0])


def test_plain_chain_in_the_kernel_order_gives_the_same_bits(sine):
    """The kernel's weight pack with its permuted activations computes the
    plain version's integer products exactly, so the chain's output is the
    same bit for bit."""
    i = sine["tikp"]
    with torch.no_grad():
        fq, gd, ls = tsk.compute_quant_factors(sine["tkp"], i, _t(sine["latents"]))
        want = tsk.siren_forward_int8_reference(fq, gd, ls, i.base, i.swq, i.s_b, i.last_w,
                                                 i.last_b, num_layers=5)
        pack = tsk.int8_kernel_weights(i.swq)
        assert torch.equal(pack[0], i.swq[0].t())  # layer 0 in the natural order
        assert not torch.equal(pack[1], i.swq[1].t())
        got = _kernel_order_chain(fq, gd, ls, i.base, pack, i.s_b, i.last_w, i.last_b, 5)
    assert torch.equal(got, want)


def test_int8_cuda_wrapper_refuses_cpu_tensors(sine):
    i = sine["tikp"]
    with torch.no_grad():
        fq, gd, ls = tsk.compute_quant_factors(sine["tkp"], i, _t(sine["latents"]))
    with pytest.raises(ValueError, match="CUDA"):
        tsk.siren_forward_int8_cuda(fq, gd, ls, i.base, i.swq, i.s_b, i.last_w, i.last_b)
