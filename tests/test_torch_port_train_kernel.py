"""The port's fused training chain (``ops/siren_train_kernel.py``) against the
JAX package's (``mri_inr_tpu/ops/siren_train_kernel.py``) on the CPU: the
Pallas kernels run in interpret mode, the port runs the plain PyTorch
versions of its CUDA kernels. Inputs come from numpy seeds and both sides get
the same dropout seed, so the hash masks are the same bits.

Sizes: H=64, latent 32, L=5 and L=3, B=13 and 16.

Tolerances, each stated where it is used:
- masks: identical;
- chain forward: <= 1e-6 with f32 products; with bf16 products max <= 1e-4,
  mean <= 1e-6 (summation order can flip a bf16 rounding, rarely);
- chain gradients vs ``jax.grad``: < 1e-4 * max(|g|, 1) with f32 products
  (the JAX package's own bar); < 1e-3 * max(|g|, 1) with bf16 products
  (measured <= 3.1e-5: rounding flips and dsw's final bf16 cast);
- hand-written backward vs torch autograd of the plain forward: the cosine
  polynomial against the sine polynomial's own derivative, < 1e-4 * max(|g|,
  1) at degree 9 and < 3e-2 * max(|g|, 1) with ``sin5``, as in the JAX tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.models.modulated_siren import ModulatedSiren as JaxModel
from mri_inr_tpu.models.modulated_siren import coordinate_grid as jax_grid
from mri_inr_tpu.ops import siren_kernel as jsk
from mri_inr_tpu.ops import siren_train_kernel as jstk
from mri_inr_tpu_torch.interop import load_flax_params, params_from_flax
from mri_inr_tpu_torch.models.modulated_siren import ModulatedSiren
from mri_inr_tpu_torch.ops import siren_kernel as tsk
from mri_inr_tpu_torch.ops import siren_train_kernel as tstk

# the test workers share the cores: one torch thread each, so no idle
# OpenMP pool spins against the other workers
torch.set_num_threads(1)

HID, LATENT = 64, 32
GRADS = ("dmods", "dbase", "dsw", "dsb", "dlw", "dlb")


def test_hash_constants_match_jax():
    assert tstk._HASH_M - 2**32 == jstk._HASH_M
    assert tstk._LAYER_STRIDE == jstk._LAYER_STRIDE
    for keep in (0.9, 0.5, 0.999):
        assert tstk._keep_threshold(keep) == jstk._keep_threshold(keep)
    for v in (0, 2**31 - 1, 2**31, 7 * tstk._LAYER_STRIDE, -5):
        assert tstk._wrap_i32(v) == jstk._wrap_i32(v)


@pytest.mark.parametrize("seed,layer,keep", [
    (0, 0, 0.9), (12345, 3, 0.9), (2**23 - 1, 4, 0.5), (77, 7, 0.8),
    (2**23 - 1, 2, 0.9),  # layer 2: 2 * 1315423911 wraps past 2^31
    (999, 1, 0.999),
])
def test_dropout_mask_is_the_jax_mask(seed, layer, keep):
    """Bit-identical to the JAX hash, including a seed near 2^23 and layers
    whose offset wraps in int32."""
    batch, seq, hid = 3, 20, 64
    idx = jstk._elem_iota(batch * seq, hid, jnp.int32(0))
    want = np.asarray(jstk._dropout_mask(idx, jnp.int32(seed), layer, keep))
    got = tstk.dropout_mask(torch.tensor([float(seed)]), layer, keep, (batch, seq, hid))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().reshape(batch * seq, hid), want)
    assert abs(float((got > 0).float().mean()) - keep) < 0.05


def dropout_mask_int64(seed: int, layer: int, keep: float, shape) -> torch.Tensor:
    """The hash written out in int64 with every value masked to 32 bits and
    the multiply in two 16-bit halves, so nothing overflows: the reference
    for the port's int32 version, which relies on wraparound."""
    mask32 = 0xFFFFFFFF
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64)
    v = (idx + seed + tstk._wrap_i32(layer * tstk._LAYER_STRIDE)) & mask32
    lo = (v & 0xFFFF) * tstk._HASH_M
    hi = (((v >> 16) * tstk._HASH_M) & 0xFFFF) << 16
    h = (lo + hi) & mask32
    h = h ^ (h >> 16)
    signed = torch.where(h >= 2**31, h - 2**32, h)
    kept = signed < tstk._keep_threshold(keep)
    return torch.where(kept, float(np.float32(1.0 / keep)), 0.0).reshape(shape)


@pytest.mark.parametrize("seed,layer,keep,shape", [
    (0, 0, 0.9, (3, 20, 64)), (2**23 - 1, 2, 0.9, (400, 576, 8)),
    (4242, 7, 0.5, (5, 577, 33)), (1, 11, 0.999, (2, 3, 1)), (2**22, 4, 0.3, (64, 576, 64)),
])
def test_dropout_mask_int32_equals_the_int64_hash(seed, layer, keep, shape):
    got = tstk.dropout_mask(torch.tensor([float(seed)]), layer, keep, shape)
    assert got.dtype == torch.float32
    assert torch.equal(got, dropout_mask_int64(seed, layer, keep, shape))


def test_dropout_mask_keep_rate():
    m = tstk.dropout_mask(torch.tensor([999.0]), 2, 0.9, (16, 256, 256))
    assert abs(float((m > 0).float().mean()) - 0.9) < 2e-3


def _jax_setup(layers, batch, activation):
    jm = JaxModel(dim_hidden=HID, latent_dim=LATENT, num_layers=layers, dropout=0.1,
                  activation=activation, compute_dtype=jnp.float32)
    tiles = np.random.default_rng(3).uniform(size=(batch, 32, 32)).astype(np.float32)
    params = jax.device_get(jm.init(jax.random.key(0), jnp.asarray(tiles[:2]))["params"])
    return jm, params, tiles


def _chain_inputs(layers, batch, activation, jmm):
    jm, params, tiles = _jax_setup(layers, batch, activation)
    jkp = jsk.extract_kernel_params(params, jax_grid(24), num_layers=layers,
                                    activation=activation, mm_dtype=jmm)
    latent = jm.apply({"params": params}, jnp.asarray(tiles), method=jm.encode)
    jmods = jsk.compute_modulations(jkp, latent, num_layers=layers)
    return jkp, jmods


def _to_torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


CHAIN_CASES = [
    # layers, batch, activation, sin5
    (5, 13, "sine", False),
    (5, 13, "sine", True),
    (5, 13, "morlet", False),
    (5, 13, "morlet", True),
    (3, 16, "sine", True),
    (3, 16, "morlet", False),
]


@pytest.mark.parametrize("mm", ["f32", "bf16"])
@pytest.mark.parametrize("layers,batch,activation,sin5", CHAIN_CASES)
def test_chain_forward_and_gradients_match_jax(layers, batch, activation, sin5, mm):
    jmm, tmm = (jnp.float32, torch.float32) if mm == "f32" else (jnp.bfloat16, torch.bfloat16)
    jkp, jmods = _chain_inputs(layers, batch, activation, jmm)
    seed = 12345
    jseed = jnp.array([float(seed)], jnp.float32)
    w = np.cos(np.arange(batch * 576, dtype=np.float32)).reshape(batch, 576)

    def chain(mods, base, s_w, s_b, lw, lb):
        kp = jkp._replace(base=base, s_w=s_w, s_b=s_b, last_w=lw, last_b=lb)
        return jstk.siren_chain_train(kp, mods, jseed, num_layers=layers,
                                      activation=activation, dropout_rate=0.1,
                                      interpret=True, sin5=sin5)

    jargs = (jmods, jkp.base, jkp.s_w, jkp.s_b, jkp.last_w, jkp.last_b)
    want = np.asarray(chain(*jargs))
    want_g = jax.grad(lambda *a: jnp.sum(chain(*a) * jnp.asarray(w)),
                      argnums=tuple(range(6)))(*jargs)

    leaves = [_to_torch(jmods), _to_torch(jkp.base), _to_torch(jkp.s_w, tmm),
              _to_torch(jkp.s_b), _to_torch(jkp.last_w), _to_torch(jkp.last_b)]
    for t in leaves:
        t.requires_grad_(True)
    kp = tsk.SirenKernelParams(leaves[1], None, None, None, None, None, *leaves[2:])
    before = (tstk.siren_chain_train_fwd_cuda.launches,
              tstk.siren_chain_train_bwd_cuda.launches)
    out = tstk.siren_chain_train(kp, leaves[0], seed, num_layers=layers,
                                 activation=activation, dropout_rate=0.1, sin5=sin5)
    (out * torch.from_numpy(w)).sum().backward()
    # CPU tensors: the plain versions ran, no kernel was launched
    assert before == (tstk.siren_chain_train_fwd_cuda.launches,
                      tstk.siren_chain_train_bwd_cuda.launches)

    err = np.abs(out.detach().numpy() - want)
    if mm == "f32":
        assert err.max() <= 1e-6
    else:
        assert err.max() <= 1e-4 and err.mean() <= 1e-6
    assert leaves[2].grad.dtype == tmm  # dsw leaves the op in s_w's dtype
    bar = 1e-4 if mm == "f32" else 1e-3
    for name, t, g in zip(GRADS, leaves, want_g):
        g = np.asarray(jnp.asarray(g, jnp.float32))
        got = t.grad.float().numpy()
        assert got.shape == g.shape, name
        assert np.abs(got - g).max() < bar * max(np.abs(g).max(), 1.0), name


@pytest.mark.parametrize("layers,batch,activation,sin5", CHAIN_CASES)
def test_written_out_backward_matches_autograd(layers, batch, activation, sin5):
    """``siren_chain_train_bwd_reference`` (cosine polynomial) against torch
    autograd through ``siren_chain_train_fwd_reference`` (derivative of the
    sine polynomial), f32 products, dropout 0.1, for the JAX tests' loss
    ``mean(out ** 2)``."""
    jkp, jmods = _chain_inputs(layers, batch, activation, jnp.float32)
    args = [_to_torch(a) for a in (jmods, jkp.base, jkp.s_w, jkp.s_b, jkp.last_w,
                                   jkp.last_b)]
    seed = torch.tensor([777.0])
    kw = dict(num_layers=layers, activation=activation, dropout_rate=0.1, sin5=sin5)
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = tstk.siren_chain_train_fwd_reference(seed, *leaves, **kw)
    out.square().mean().backward()
    g = 2.0 * out.detach() / out.numel()
    written = tstk.siren_chain_train_bwd_reference(seed, *args, g, **kw)
    bar = 3e-2 if sin5 else 1e-4
    # this loss's gradients are far below 1, so also hold the gap against
    # max |g| itself: 1e-3 at degree 9, 1e-1 with sin5
    rel = 1e-1 if sin5 else 1e-3
    for name, a, t in zip(GRADS, written, leaves):
        assert a.shape == t.grad.shape, name
        gap, top = (a - t.grad).abs().max().item(), t.grad.abs().max().item()
        assert gap < bar * max(top, 1.0), (name, gap)
        assert gap < rel * top, (name, gap, top)


def test_dropout_off_and_seed_behaviour():
    jkp, jmods = _chain_inputs(3, 16, "sine", jnp.bfloat16)
    args = [_to_torch(jmods), _to_torch(jkp.base), _to_torch(jkp.s_w, torch.bfloat16),
            _to_torch(jkp.s_b), _to_torch(jkp.last_w), _to_torch(jkp.last_b)]
    kw = dict(num_layers=3, dropout_rate=0.1)
    a = tstk.siren_chain_train_fwd_reference(torch.tensor([111.0]), *args, **kw)
    b = tstk.siren_chain_train_fwd_reference(torch.tensor([112.0]), *args, **kw)
    c = tstk.siren_chain_train_fwd_reference(torch.tensor([111.0]), *args, **kw)
    assert torch.equal(a, c) and not torch.equal(a, b)
    # rate 0: the seed does not matter
    d = tstk.siren_chain_train_fwd_reference(torch.tensor([1.0]), *args, num_layers=3)
    e = tstk.siren_chain_train_fwd_reference(torch.tensor([2.0]), *args, num_layers=3)
    assert torch.equal(d, e)
    with pytest.raises(ValueError, match="dropout_rate"):
        tstk.siren_chain_train_fwd_reference(torch.tensor([1.0]), *args, num_layers=3,
                                             dropout_rate=1.0)


def test_schedule_knobs_are_validated_and_ignored():
    jkp, jmods = _chain_inputs(3, 16, "sine", jnp.bfloat16)
    kp = tsk.SirenKernelParams(_to_torch(jkp.base), None, None, None, None, None,
                               _to_torch(jkp.s_w, torch.bfloat16), _to_torch(jkp.s_b),
                               _to_torch(jkp.last_w), _to_torch(jkp.last_b))
    mods = _to_torch(jmods)
    ref = tstk.siren_chain_train(kp, mods, 5, num_layers=3, dropout_rate=0.1)
    got = tstk.siren_chain_train(kp, mods, 5, num_layers=3, dropout_rate=0.1, block_b=4,
                                 bwd_block_b=8, dw_partials=False)
    assert torch.equal(ref, got)
    with pytest.raises(ValueError, match="block_b"):
        tstk.siren_chain_train(kp, mods, 5, num_layers=3, block_b=0)
    with pytest.raises(ValueError, match="bwd_block_b"):
        tstk.siren_chain_train(kp, mods, 5, num_layers=3, bwd_block_b=-2)


def test_cuda_wrappers_refuse_cpu_tensors():
    z = torch.zeros
    args = (z(1), z(2, 3 * 64), z(576, 64), z(2, 64, 64, dtype=torch.bfloat16),
            z(2, 1, 64), z(1, 64), z(1, 1))
    with pytest.raises(ValueError, match="CUDA"):
        tstk.siren_chain_train_fwd_cuda(*args, num_layers=3)
    with pytest.raises(ValueError, match="CUDA"):
        tstk.siren_chain_train_bwd_cuda(*args, z(2, 576), num_layers=3)


def test_transposed_weights_are_made_or_checked():
    """Both train kernels read W^T, (out, in) per layer: made from ``s_w``
    where the caller passes none, else checked."""
    s_w = torch.arange(2 * 64 * 64, dtype=torch.float32).reshape(2, 64, 64).bfloat16()
    cpu = torch.device("cpu")
    made = tstk._transposed(s_w, None, cpu)
    assert made.is_contiguous() and torch.equal(made, s_w.transpose(1, 2))
    assert tstk._transposed(s_w, made, cpu) is made
    with pytest.raises(ValueError, match="s_wt"):
        tstk._transposed(s_w, s_w.transpose(1, 2), cpu)  # not contiguous
    with pytest.raises(ValueError, match="s_wt"):
        tstk._transposed(s_w, made.float(), cpu)


@pytest.mark.parametrize("layers,batch,activation,sin5,mm", [
    (5, 13, "sine", True, "bf16"),
    (5, 13, "sine", False, "f32"),
    (3, 16, "morlet", True, "bf16"),
    (3, 16, "sine", False, "f32"),
])
def test_fused_train_apply_whole_model_gradients_match_jax(layers, batch, activation, sin5,
                                                           mm):
    """Gradients of one loss into the whole transplanted model (encoder,
    modulator, every SIREN layer) through ``fused_train_apply`` on both
    sides, compared in ``params_from_flax`` layout. Bars: 1e-4 * max(|g|, 1)
    with f32 products, 1e-3 * max(|g|, 1) with bf16 products, and per leaf
    1e-4 * max |g| (f32), 1e-2 * max |g| (bf16)."""
    jmm, tmm = (jnp.float32, torch.float32) if mm == "f32" else (jnp.bfloat16, torch.bfloat16)
    jm, params, tiles = _jax_setup(layers, batch, activation)
    target = np.random.default_rng(5).uniform(size=(batch, 24, 24)).astype(np.float32)
    key = jax.random.key(7)
    seed = int(jax.random.randint(key, (1,), 0, 2**23)[0])  # what the JAX op draws

    def loss(p):
        pred = jstk.fused_train_apply(jm, p, jnp.asarray(tiles), key, interpret=True,
                                      mm_dtype=jmm, sin5=sin5)
        return jnp.mean((pred - jnp.asarray(target)) ** 2)

    want_loss, want = jax.value_and_grad(loss)(params)
    want = params_from_flax(jax.device_get(want))

    tm = ModulatedSiren(dim_hidden=HID, latent_dim=LATENT, num_layers=layers, dropout=0.1,
                        activation=activation, device="cpu")
    load_flax_params(tm, params)
    pred = tstk.fused_train_apply(tm, torch.from_numpy(tiles), seed, mm_dtype=tmm, sin5=sin5)
    got_loss = torch.mean((pred - torch.from_numpy(target)) ** 2)
    got_loss.backward()
    assert abs(got_loss.item() - float(want_loss)) <= 1e-5
    bar = 1e-4 if mm == "f32" else 1e-3
    # a mean-square loss leaves every gradient far below 1, where the bar
    # above is absolute, so each leaf's gap is also held against its own
    # max |g|: the worst leaf showed 2.0e-6 of it with f32 products and
    # 3.5e-3 with bf16 products
    rel = 1e-4 if mm == "f32" else 1e-2
    names = dict(tm.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        assert p.grad is not None and p.grad.abs().max() > 0, name
        g = want[name].numpy()
        gap, top = np.abs(p.grad.numpy() - g).max(), np.abs(g).max()
        assert gap < bar * max(top, 1.0), (name, gap)
        assert gap < rel * top, (name, gap, top)


def test_fused_train_apply_deterministic_is_dropout_free():
    jm, params, tiles = _jax_setup(3, 16, "sine")
    tm = ModulatedSiren(dim_hidden=HID, latent_dim=LATENT, num_layers=3, dropout=0.1,
                        device="cpu")
    load_flax_params(tm, params)
    x = torch.from_numpy(tiles)
    with torch.no_grad():
        a = tstk.fused_train_apply(tm, x, 1, deterministic=True, sin5=True)
        b = tstk.fused_train_apply(tm, x, 2, deterministic=True, sin5=True)
        c = tstk.fused_train_apply(tm, x, 2, sin5=True)
        # the eval forward with the same sine degree in the hidden layers
        # ends in a degree-7 sine, the train forward in degree 5
        d = tsk.fused_forward(tm, x, sin5=True)
    assert a.shape == (16, 24, 24)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert (a - d).abs().max() < 2e-2
