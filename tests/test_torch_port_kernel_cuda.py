"""The hand-written CUDA kernels (``ops/csrc/siren_forward.cu``,
``siren_forward_int8.cu``, ``siren_train_fwd.cu``, ``siren_train_bwd.cu``,
``dft2c.cu``, ``threefry_dropout.cu``) against their plain PyTorch versions,
on the card. Skips without one.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_port_kernel_cuda.py -q

Tolerances: the kernel and the plain version take the same bf16 inputs and
accumulate in f32 in a different order, so a pre-activation may differ in
its last bits and, rarely, round to the neighbouring bf16 value; that moves
an output by up to ~1e-4. Max 1e-3 / mean 1e-5 leaves a margin. The bf16
polynomial (``sin_bf16``) amplifies such flips: 2e-2 / 1e-3.

The train kernels regenerate the plain version's dropout masks bit for bit,
so the forward keeps the same bars. The backward's outputs are sums over up
to B*S rows taken in another order (split-K partials for dW, per-tile
records for dmods, dsb, dlw and dlb, partials of a few patches for dbase),
on top of the same rare bf16 flips: each output is held to ``2e-3 *
max(|plain|, 1)``. Every sum runs in a fixed order, so all six gradients must repeat bit
for bit across two calls.

Cases beyond the main paths' shapes: an odd number of 64-row tiles (one
patch at S=576: the persistent block's second consumer takes a tile of
zeros), a single tile (S=64), a batch that gives every persistent block many
tile pairs (B=600 at H=256), a batch whose last group of patches in the
backward's chain kernel is short (B=598: groups of 4), pre-activations near 150 (hidden biases
shifted by 150: the range reduction takes about 24 periods) and a deeper
chain (L=7). The large pre-activations come from shifted biases, not from
weights multiplied up: at 50 times the weights the chain amplifies rounding
so much that the plain version summed in f32 and in f64 differs by 4e-2.

The int8 kernel's products are exact in both versions, so they differ only
where a sine's last bits (the kernel fuses multiply-adds, the plain version
does not) move a ``floor`` across an integer: one quantum in one
pre-activation, rarely. Max 1e-3 / mean 1e-5. Its cases cover the
persistent block's edges as the bf16 kernel's do: an odd tile count (B=1 at
S=576), fewer tiles than two per SM, one tile a patch, many tile pairs a
block, a deeper chain, and L=2 (no epilogue before the last layer) at H=64
and H=192 (whose second weight slab is half zeros).

The FFT kernel runs the plain version's stages with fused multiply-adds
and another radix-R butterfly than its length-R DFT products: 2e-5 *
max(|plain|, 1), the JAX package's bar against the FFT, against both the
plain version and ``torch.fft``.

The dropout kernel's masks are integer hashes compared in float32 exactly
as the plain version compares them: equal, bit for bit, at every size,
offset and key, and read from the key's memory when the kernel runs.
"""

import pytest
import torch

from mri_inr_tpu_torch.models.modulated_siren import ModulatedSiren, coordinate_grid
from mri_inr_tpu_torch.ops import dropout, fft_kernel, siren_kernel
from mri_inr_tpu_torch.ops import siren_train_kernel as stk

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _shifted(kp, shift):
    """The hidden biases plus ``shift``: every pre-activation near it."""
    return kp._replace(s_b=kp.s_b + shift) if shift else kp


def _inputs(device, hidden, layers, siren, batch, activation="sine", shift=0.0):
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
    return mods, _shifted(kp, shift)


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
    (256, 5, 24, 1, "sine", dict(sin7=True, sin5=True), 1e-3, 1e-5),  # 9 tiles: odd
    (128, 4, 8, 1, "sine", dict(sin5=True), 1e-3, 1e-5),  # S=64: a single tile
    (256, 5, 24, 600, "sine", dict(sin7=True, sin5=True), 1e-3, 1e-5),  # many pairs a block
    (256, 5, 24, 24, "sine", dict(sin5=True, shift=150.0), 1e-3, 1e-5),  # large periods
    (256, 5, 24, 24, "sine", dict(shift=150.0), 1e-3, 1e-5),
    (256, 7, 24, 8, "sine", dict(sin7=True, sin5=True), 1e-3, 1e-5),  # L=7
]


@pytest.mark.parametrize("hidden,layers,siren,batch,activation,knobs,tol_max,tol_mean", CASES)
def test_kernel_matches_plain_version(device, hidden, layers, siren, batch,
                                      activation, knobs, tol_max, tol_mean):
    knobs = dict(knobs)
    mods, kp = _inputs(device, hidden, layers, siren, batch, activation,
                       knobs.pop("shift", 0.0))
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
    a = siren_kernel.siren_forward(mods, kp.base, kp.s_w, kp.s_b, kp.last_b, num_layers=3)
    b = siren_kernel.siren_forward(mods, kp.base, kp.s_w, kp.s_b, kp.last_b, num_layers=3,
                                   s_wt=kp.s_w.transpose(1, 2).contiguous())
    assert siren_kernel.siren_forward_cuda.launches == before + 2
    assert torch.equal(a, b)


def test_packed_apply_function_on_the_card(device):
    """make_apply_fn packs once, launches the kernel on every call and
    repacks after an optimizer step."""
    g = torch.Generator().manual_seed(5)
    model = ModulatedSiren(dim_hidden=128, latent_dim=64, num_layers=3, generator=g,
                           device=device)
    tiles = torch.rand((6, 32, 32), generator=g).to(device)
    apply = siren_kernel.make_apply_fn(model, sin5=True, device=device)
    before = siren_kernel.siren_forward_cuda.launches
    first = apply(tiles)
    assert torch.equal(apply(tiles), first)
    assert apply.pack.packs == 1
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    model(tiles).square().mean().backward()
    opt.step()
    after = apply(tiles)
    torch.cuda.synchronize()
    assert apply.pack.packs == 2
    assert siren_kernel.siren_forward_cuda.launches == before + 3
    assert torch.equal(after, siren_kernel.fused_forward(model, tiles, block_b=16, sin5=True))


def test_kernel_rejects_bad_inputs(device):
    mods, kp = _inputs(device, 64, 3, 24, 4)
    with pytest.raises(ValueError, match="s_w"):
        siren_kernel.siren_forward_cuda(mods, kp.base, kp.s_w.float(), kp.s_b,
                                        kp.last_b, num_layers=3)
    with pytest.raises(ValueError, match="mods"):
        siren_kernel.siren_forward_cuda(mods[:, ::2], kp.base, kp.s_w, kp.s_b,
                                        kp.last_b, num_layers=3)
    with pytest.raises(ValueError, match="s_wt"):
        siren_kernel.siren_forward_cuda(mods, kp.base, kp.s_w, kp.s_b, kp.last_b,
                                        num_layers=3, s_wt=kp.s_w.transpose(1, 2))


# ----------------------------------------------------------- train kernels
def _train_inputs(device, hidden, layers, siren, batch, activation, shift=0.0):
    g = torch.Generator().manual_seed(1)
    model = ModulatedSiren(dim_hidden=hidden, latent_dim=hidden, num_layers=layers,
                           siren_patch_size=siren, activation=activation, generator=g,
                           device=device)
    tiles = torch.rand((batch, 32, 32), generator=g).to(device)
    cot = torch.randn((batch, siren * siren), generator=g).to(device)
    with torch.no_grad():
        kp = siren_kernel.extract_kernel_params(model, coordinate_grid(siren, device))
        mods = siren_kernel.compute_modulations(kp, model.encode(tiles),
                                                num_layers=layers).contiguous()
    kp = _shifted(kp, shift)
    seed = torch.tensor([4321.0], device=device)
    return (seed, mods, kp.base, kp.s_w, kp.s_b, kp.last_w, kp.last_b), cot


TRAIN_CASES = [
    # (hidden, layers, siren, batch, activation, sin5, dropout, shift)
    (256, 5, 24, 24, "sine", True, 0.1, 0.0),
    (256, 5, 24, 24, "sine", False, 0.1, 0.0),
    (256, 5, 24, 24, "morlet", True, 0.1, 0.0),
    (256, 5, 24, 24, "sine", True, 0.0, 0.0),
    (64, 3, 20, 37, "sine", True, 0.1, 0.0),  # S=400: ragged tile
    (64, 5, 24, 9, "morlet", False, 0.0, 0.0),
    (128, 2, 24, 5, "morlet", False, 0.1, 0.0),
    (128, 4, 24, 7, "sine", False, 0.0, 0.0),
    (192, 4, 24, 9, "sine", True, 0.1, 0.0),
    (192, 3, 20, 6, "morlet", True, 0.0, 0.0),
    (256, 7, 24, 8, "sine", True, 0.1, 0.0),  # deeper than a whole-chain tile ring held
    (256, 5, 24, 1, "sine", True, 0.1, 0.0),  # 9 tiles: odd
    (128, 3, 8, 1, "sine", True, 0.1, 0.0),  # S=64: a single tile
    (256, 5, 24, 600, "sine", True, 0.1, 0.0),  # many pairs a block
    (256, 5, 24, 598, "sine", True, 0.1, 0.0),  # the backward's last patch group ragged
    (256, 5, 24, 24, "sine", True, 0.1, 150.0),  # large periods
    (256, 5, 24, 24, "sine", False, 0.1, 150.0),
]


@pytest.mark.parametrize("hidden,layers,siren,batch,activation,sin5,rate,shift", TRAIN_CASES)
def test_train_forward_matches_plain_version(device, hidden, layers, siren, batch,
                                             activation, sin5, rate, shift):
    args, _ = _train_inputs(device, hidden, layers, siren, batch, activation, shift)
    kw = dict(num_layers=layers, activation=activation, dropout_rate=rate, sin5=sin5)
    before = stk.siren_chain_train_fwd_cuda.launches
    got = stk.siren_chain_train_fwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert stk.siren_chain_train_fwd_cuda.launches == before + 1
    want = stk.siren_chain_train_fwd_reference(*args, **kw)
    assert got.shape == want.shape == (batch, siren * siren)
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    assert err.max().item() <= 1e-3
    assert err.mean().item() <= 1e-5


@pytest.mark.parametrize("hidden,layers,siren,batch,activation,sin5,rate,shift", TRAIN_CASES)
def test_train_backward_matches_plain_version(device, hidden, layers, siren, batch,
                                              activation, sin5, rate, shift):
    args, cot = _train_inputs(device, hidden, layers, siren, batch, activation, shift)
    kw = dict(num_layers=layers, activation=activation, dropout_rate=rate, sin5=sin5)
    before = stk.siren_chain_train_bwd_cuda.launches
    got = stk.siren_chain_train_bwd_cuda(*args, cot, **kw)
    torch.cuda.synchronize()
    assert stk.siren_chain_train_bwd_cuda.launches == before + 1
    want = stk.siren_chain_train_bwd_reference(*args, cot, **kw)
    for name, a, b in zip(("dmods", "dbase", "dsw", "dsb", "dlw", "dlb"), got, want):
        assert a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        gap = (a - b).abs().max().item()
        assert gap <= 2e-3 * max(b.abs().max().item(), 1.0), (name, gap)
    again = stk.siren_chain_train_bwd_cuda(*args, cot, **kw)
    assert torch.equal(again[0], got[0]), "dmods differs between two calls"
    assert torch.equal(again[2], got[2]), "dsw differs between two calls"


@pytest.mark.parametrize("hidden,layers,siren,batch,activation,sin5", [
    (256, 5, 24, 400, "sine", True),  # the training batch
    (64, 3, 20, 37, "morlet", False),  # S=400: ragged tile
])
def test_train_backward_repeats_bit_for_bit(device, hidden, layers, siren, batch, activation,
                                            sin5):
    """Two calls on the same inputs give the same six gradients, dbase (a
    sum over the patches) included."""
    args, cot = _train_inputs(device, hidden, layers, siren, batch, activation)
    kw = dict(num_layers=layers, activation=activation, dropout_rate=0.1, sin5=sin5)
    first = stk.siren_chain_train_bwd_cuda(*args, cot, **kw)
    again = stk.siren_chain_train_bwd_cuda(*args, cot, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("dmods", "dbase", "dsw", "dsb", "dlw", "dlb"), first, again):
        assert torch.equal(a, b), f"{name} differs between two calls"


def test_train_op_dispatches_to_both_kernels(device):
    """autograd through the op on CUDA tensors launches each kernel once and
    returns dsw in s_w's dtype."""
    args, cot = _train_inputs(device, 64, 3, 24, 4, "sine")
    seed, mods, base, s_w, s_b, last_w, last_b = args
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (mods, base, s_w, s_b, last_w, last_b)]
    kp = siren_kernel.SirenKernelParams(leaves[1], None, None, None, None, None,
                                        leaves[2], leaves[3], leaves[4], leaves[5])
    f0, b0 = stk.siren_chain_train_fwd_cuda.launches, stk.siren_chain_train_bwd_cuda.launches
    out = stk.siren_chain_train(kp, leaves[0], seed, num_layers=3, dropout_rate=0.1, sin5=True)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    assert stk.siren_chain_train_fwd_cuda.launches == f0 + 1
    assert stk.siren_chain_train_bwd_cuda.launches == b0 + 1
    assert leaves[2].grad.dtype == torch.bfloat16
    for name, t in zip(("mods", "base", "s_w", "s_b", "last_w", "last_b"), leaves):
        assert t.is_leaf and t.grad is not None, name
        assert torch.isfinite(t.grad.float()).all(), name


def test_train_kernels_reject_bad_inputs(device):
    args, cot = _train_inputs(device, 64, 3, 24, 4, "sine")
    seed, mods, base, s_w, s_b, last_w, last_b = args
    with pytest.raises(ValueError, match="s_w"):
        stk.siren_chain_train_fwd_cuda(seed, mods, base, s_w.float(), s_b, last_w, last_b,
                                       num_layers=3)
    with pytest.raises(ValueError, match="g"):
        stk.siren_chain_train_bwd_cuda(*args, cot[:, ::2], num_layers=3)
    with pytest.raises(ValueError, match="dropout_rate"):
        stk.siren_chain_train_fwd_cuda(*args, num_layers=3, dropout_rate=1.0)


# ------------------------------------------------------------- int8 kernel
def _int8_inputs(device, hidden, layers, siren, batch, activation):
    g = torch.Generator().manual_seed(2)
    model = ModulatedSiren(dim_hidden=hidden, latent_dim=hidden, num_layers=layers,
                           dropout=0.0, siren_patch_size=siren, activation=activation,
                           generator=g, device=device).eval()
    tiles = torch.rand((batch, 32, 32), generator=g).to(device)
    with torch.no_grad():
        kp = siren_kernel.extract_kernel_params(model, coordinate_grid(siren, device))
        ikp = siren_kernel.quantize_kernel_params(model, kp)
        fq, gd, ls = siren_kernel.compute_quant_factors(kp, ikp, model.encode(tiles),
                                                        num_layers=layers)
    return (fq.contiguous(), gd.contiguous(), ls, ikp.base, ikp.swq, ikp.s_b, ikp.last_w,
            ikp.last_b)


INT8_CASES = [
    # (hidden, layers, siren, batch, activation)
    (256, 5, 24, 96, "sine"),
    (256, 5, 24, 96, "morlet"),
    (64, 3, 20, 37, "sine"),  # S=400: ragged tile
    (128, 2, 24, 5, "morlet"),
    (192, 4, 24, 9, "sine"),
    (256, 5, 24, 1, "sine"),  # B=1, S=576: 9 tiles, odd: consumer 1 gets a zero tile
    (256, 5, 24, 1, "morlet"),
    (256, 5, 24, 7, "sine"),  # 63 tiles: fewer than two per SM, odd
    (128, 3, 8, 3, "sine"),  # S=64: one tile a patch
    (256, 5, 24, 600, "sine"),  # 5,400 tiles: many pairs a block
    (256, 7, 24, 8, "sine"),  # deeper: the ring holds fewer layers
    (64, 2, 24, 4, "sine"),  # L=2: no epilogue before the last layer
    (192, 2, 24, 9, "morlet"),
]


@pytest.mark.parametrize("hidden,layers,siren,batch,activation", INT8_CASES)
def test_int8_kernel_matches_plain_version(device, hidden, layers, siren, batch, activation):
    args = _int8_inputs(device, hidden, layers, siren, batch, activation)
    kw = dict(num_layers=layers, activation=activation)
    before = siren_kernel.siren_forward_int8_cuda.launches
    got = siren_kernel.siren_forward_int8_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert siren_kernel.siren_forward_int8_cuda.launches == before + 1
    want = siren_kernel.siren_forward_int8_reference(*args, **kw)
    assert got.shape == want.shape == (batch, siren * siren)
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    assert err.max().item() <= 1e-3
    assert err.mean().item() <= 1e-5


def test_int8_dispatch_and_bad_inputs(device):
    args = _int8_inputs(device, 64, 3, 24, 4, "sine")
    before = siren_kernel.siren_forward_int8_cuda.launches
    wide_ls = args[2].expand(-1, 128).contiguous()  # the TPU layout of ls
    a = siren_kernel.siren_forward_int8(*args, num_layers=3)
    b = siren_kernel.siren_forward_int8(*args[:2], wide_ls, *args[3:], num_layers=3)
    assert siren_kernel.siren_forward_int8_cuda.launches == before + 2
    assert torch.equal(a, b)
    c = siren_kernel.siren_forward_int8(
        *args, num_layers=3, swq_t=siren_kernel.int8_kernel_weights(args[4]))
    assert siren_kernel.siren_forward_int8_cuda.launches == before + 3
    assert torch.equal(a, c)
    with pytest.raises(ValueError, match="swq"):
        siren_kernel.siren_forward_int8_cuda(*args[:4], args[4].float(), *args[5:],
                                             num_layers=3)
    with pytest.raises(ValueError, match="swq_t"):
        siren_kernel.siren_forward_int8_cuda(*args, num_layers=3,
                                             swq_t=args[4].transpose(1, 2))


# -------------------------------------------------------------- DFT kernel
DFT_SHAPES = [(3, 64, 64), (3, 96, 64), (3, 63, 33), (2, 320, 320), (2, 640, 320),
              (1, 17, 640), (5, 1, 1), (2, 640, 368), (2, 640, 372), (2, 37, 41)]


@pytest.mark.parametrize("shape", DFT_SHAPES, ids=str)
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
@pytest.mark.parametrize("magnitude", [False, True], ids=["complex", "magnitude"])
def test_dft_kernel_matches_plain_version_and_fft(device, shape, inverse, magnitude):
    g = torch.Generator().manual_seed(3)
    x = torch.randn((*shape, 2), generator=g).to(device)
    before = fft_kernel.dft2c_ri_cuda.launches
    got = fft_kernel.dft2c_ri(x, inverse=inverse, magnitude=magnitude)
    torch.cuda.synchronize()
    assert fft_kernel.dft2c_ri_cuda.launches == before + 1
    want = fft_kernel.dft2c_ri_reference(x, inverse=inverse, magnitude=magnitude)
    assert got.shape == want.shape == ((*shape,) if magnitude else (*shape, 2))
    bar = 2e-5 * max(want.abs().max().item(), 1.0)
    assert (got - want).abs().max().item() <= bar
    c = torch.fft.ifftshift(torch.view_as_complex(x), dim=(-2, -1))
    c = (torch.fft.ifft2 if inverse else torch.fft.fft2)(c, norm="ortho")
    c = torch.fft.fftshift(c, dim=(-2, -1))
    lib = c.abs() if magnitude else torch.view_as_real(c)
    assert (got - lib).abs().max().item() <= bar


def test_dft_kernel_takes_views_and_refuses_large_sizes(device):
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 4, 32, 48, 2), generator=g).to(device)
    got = fft_kernel.dft2c_ri_cuda(x[:, 1:3], magnitude=True)  # not contiguous
    want = fft_kernel.dft2c_ri_reference(x[:, 1:3], magnitude=True)
    assert got.shape == (2, 2, 32, 48)
    assert (got - want).abs().max().item() <= 2e-5 * max(want.abs().max().item(), 1.0)
    with pytest.raises(ValueError, match="DFT_MAX_DIM"):
        fft_kernel.dft2c_ri_cuda(torch.zeros((1, 8, 641, 2), device=device))


DROPOUT_CASES = [((400, 576, 256), 0), ((3, 5, 7), 0), ((1,), 0), ((2, 576, 16), 3),
                 ((4, 1001), 2**32 - 5), ((200, 576, 256), 200 * 576 * 256)]


@pytest.mark.parametrize("shape,offset", DROPOUT_CASES, ids=str)
@pytest.mark.parametrize("keep", [0.9, 0.5])
def test_dropout_kernel_matches_plain_version(device, shape, offset, keep):
    g = torch.Generator().manual_seed(sum(shape) + offset % 997)
    keys = torch.randint(-2**31, 2**31, (2,), generator=g, dtype=torch.int64).to(torch.int32)
    before = dropout.threefry_keep_mask_cuda.launches
    got = dropout.threefry_keep_mask(keys.to(device), shape, keep, offset)
    assert dropout.threefry_keep_mask_cuda.launches == before + 1
    want = dropout.threefry_keep_mask_reference(keys.to(device), shape, keep, offset)
    assert got.dtype == torch.bool and tuple(got.shape) == tuple(shape)
    assert torch.equal(got, want)


def test_dropout_kernel_reads_its_key_when_it_runs(device):
    """A CUDA graph that launches the kernel draws the mask of the key
    staged before each replay."""
    keys = torch.tensor([1, 2], dtype=torch.int32, device=device)
    dropout.threefry_keep_mask_cuda(keys, (8, 576, 64), 0.9)  # built and loaded
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dropout.threefry_keep_mask_cuda(keys, (8, 576, 64), 0.9)
    masks = []
    for k in ([1, 2], [3, 4], [1, 2]):
        keys.copy_(torch.tensor(k, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want = dropout.threefry_keep_mask_reference(keys.cpu(), (8, 576, 64), 0.9)
        assert torch.equal(out.cpu(), want)
        masks.append(out.clone())
    assert not torch.equal(masks[0], masks[1]) and torch.equal(masks[0], masks[2])


def test_dropout_kernel_refuses_a_key_on_the_cpu(device):
    with pytest.raises(ValueError, match="CUDA key"):
        dropout.threefry_keep_mask_cuda(torch.zeros(2, dtype=torch.int32), (4,), 0.9)
    with pytest.raises(ValueError, match="int32"):
        dropout.threefry_keep_mask_cuda(torch.zeros(2, device=device), (4,), 0.9)
