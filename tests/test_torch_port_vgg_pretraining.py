"""The port's VGG autoencoder pretraining (``train_encoder --model vgg``)
against the JAX package's on the CPU.

- The seeded init (``train_encoder.build_autoencoder("vgg", seed=...)``)
  has Flax's per-layer distribution: every kernel's std is
  ``1/sqrt(fan_in)`` (``fan_in = cin * kh * kw``, the transposed convs'
  too) within five standard errors of a sample std, its mean is zero within
  five standard errors, no element lies beyond the truncation at 2 sigma of
  the underlying normal and the largest comes within 5% of it, every bias
  is zero and ``trunk.conv_0`` has none. The Flax init of the JAX
  ``VGGAutoencoder`` is held to the same bars: the two draw from one
  distribution, not equal values.
- ``tests/vgg_ae_cross_package.py:card_autoencoder`` draws on the CPU the
  weights the card's torch 2.11 draws at a seed: the sums of the VGG
  autoencoder's initial weights at seeds 0-7 equal, within 1e-12, those
  ``scripts/torch_vgg_splice_probe.py --ae-draws`` recorded on an NVIDIA
  H100 (``runs/vgg_ae_probe/ae_draws_card.json``). The port's own
  ``build_autoencoder`` goes through ``nn.init.trunc_normal_``, which torch
  2.13 draws by rejection and torch 2.11 by the inverse CDF (an open
  fault of the port's seeded init, not pinned here).
- Three Adam steps (lr 1e-3) from the Flax init transplanted by
  ``interop.params_from_flax``, on a batch at 32x32 drawn from a numpy seed
  (uniform on [0, 0.5]: residuals of nonzero mean, as MRI tiles give),
  against ``optax.adam``, over three draws of batch and seed: each step's
  loss within 1e-6 (measured 1.5e-7 at most); the first step's gradients,
  from equal parameters, within 1e-3 of each tensor's largest gradient
  (measured 4.7e-4 at most, in a decoder conv whose largest gradient is
  1e-9: at this init the reconstruction is flat to about one f32 ulp of
  0.5, so the gradients below the output conv are small sums of terms of
  both signs); after three steps, at most 0.05% of the 32.4 million
  parameters more than 1e-5 from optax's (measured 0, 5,623 and 30
  elements, every one with a gradient of 1e-6 or less, which Adam's
  normalised step turns into a move of about lr either way) and none more
  than 4e-3 (Adam's largest move in three steps; measured 7.2e-4); and
  JAX's gradients through the port's Adam give optax's parameters within
  1e-7 (the optimizer alone).
- ``interop.params_to_flax`` returns copies: an in-place update of the
  module (an optimizer step) leaves the tree it returned as it was. Before,
  every 1-D array (the biases) was a view of the live tensor, so a JAX step
  run after a port step on a tree taken before it saw the port's updated
  biases.
- ``train_encoder.train``'s ``on_step`` sees every step: the steps an epoch
  times the epochs, and the mean of each epoch's step losses is its
  logged loss.
"""

import argparse
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mri_inr_tpu.models import encoder as jenc
from mri_inr_tpu_torch import interop
from mri_inr_tpu_torch.cli import train_encoder as te
from mri_inr_tpu_torch.models import encoder as tenc
from mri_inr_tpu_torch.train.trainer import make_optimizer

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

#: sample-std error of a normal truncated at 2 sigma: sqrt((kurtosis - 1) / 4n)
#: with its kurtosis of 2.3764, i.e. 0.5866 / sqrt(n) relative
TRUNC_STD_ERR = math.sqrt((2.3764 - 1) / 4)
#: std of the underlying normal over the truncated one's (Flax's correction)
TRUNC_CORRECTION = 0.87962566103423978


def _kernels(named: dict[str, np.ndarray]) -> dict[str, tuple[np.ndarray, int]]:
    """name -> (kernel as a flat array, fan_in) for a torch state dict in
    numpy (convs ``(out, in, kh, kw)``, transposed convs ``(in, out, kh,
    kw)``)."""
    out = {}
    for name, w in named.items():
        if not name.endswith("weight"):
            continue
        transposed = ".up_" in name
        fan_in = (w.shape[0] if transposed else w.shape[1]) * w.shape[2] * w.shape[3]
        out[name] = (w.reshape(-1).astype(np.float64), fan_in)
    return out


def _assert_flax_distribution(state: dict[str, np.ndarray]) -> None:
    kernels = _kernels(state)
    assert len(kernels) == 13 + 13 + 1  # trunk convs, decoder convs and ups, out
    for name, (w, fan_in) in kernels.items():
        n, target = w.size, 1.0 / math.sqrt(fan_in)
        bound = 2.0 * target / TRUNC_CORRECTION
        std = w.std()
        assert abs(std / target - 1.0) <= 5 * TRUNC_STD_ERR / math.sqrt(n), (name, std, target)
        assert abs(w.mean()) <= 5 * target / math.sqrt(n), (name, w.mean())
        assert np.abs(w).max() <= bound * (1 + 1e-6), (name, np.abs(w).max(), bound)
        assert np.abs(w).max() >= 0.95 * bound, (name, np.abs(w).max(), bound)
    biases = {k: v for k, v in state.items() if k.endswith("bias")}
    assert "trunk.conv_0.bias" not in state
    assert len(biases) == 12 + 13 + 1
    assert all(not v.any() for v in biases.values())


@pytest.mark.parametrize("side", ["port", "flax"])
def test_vgg_init_has_flax_per_layer_distribution(side):
    if side == "port":
        model, patch = te.build_autoencoder("vgg", seed=3)
        assert patch == 32 and model.trunk.conv_0.bias is None
        state = {k: v.numpy() for k, v in model.state_dict().items()}
        # seeded: the same seed draws the same weights, another seed others
        again, _ = te.build_autoencoder("vgg", seed=3)
        other, _ = te.build_autoencoder("vgg", seed=4)
        w = model.trunk.conv_5.weight
        assert torch.equal(again.trunk.conv_5.weight, w)
        assert not torch.equal(other.trunk.conv_5.weight, w)
    else:
        params = jax.jit(jenc.VGGAutoencoder().init)(jax.random.key(3),
                                                      jnp.zeros((1, 32, 32)))["params"]
        state = {k: v.numpy() for k, v in
                 interop.params_from_flax(jax.device_get(params)).items()}
    _assert_flax_distribution(state)


def _weight_sum(model):
    return float(sum(p.detach().double().sum() for p in model.parameters()))


def test_the_cross_package_tool_draws_the_cards_weights():
    from vgg_ae_cross_package import card_autoencoder

    record = json.loads((REPO / "runs" / "vgg_ae_probe" / "ae_draws_card.json").read_text())
    assert record["device"].startswith("NVIDIA H100") and record["torch"].startswith("2.11")
    card = {r["seed"]: r["initial_weight_sum"] for r in record["runs"]}
    assert sorted(card) == list(range(8))
    for seed, want in card.items():
        got = _weight_sum(card_autoencoder(seed))
        assert abs(got - want) <= 1e-12 * abs(want), (seed, got, want)


# (batch, data seed, init key): the draws the three-step bars are measured on
DRAWS = {"b8_seed0": (8, 0, 0), "b4_seed1": (4, 1, 0), "b6_seed0_key2": (6, 0, 2)}


@pytest.mark.parametrize("draw", list(DRAWS))
def test_three_adam_steps_of_the_vgg_autoencoder_match_optax(draw):
    batch, data_seed, key = DRAWS[draw]
    x = np.random.default_rng(data_seed).uniform(0.0, 0.5, size=(batch, 32, 32)).astype(
        np.float32)
    jm = jenc.VGGAutoencoder()
    params = jax.jit(jm.init)(jax.random.key(key), jnp.asarray(x))["params"]
    start = interop.params_from_flax(jax.device_get(params))
    tm = tenc.VGGAutoencoder()
    tm.load_state_dict(start, strict=True)
    # the same start, stepped by the port's Adam on JAX's gradients
    tm_j = tenc.VGGAutoencoder()
    tm_j.load_state_dict(start, strict=True)
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)
    opt, opt_j = (make_optimizer("adam", 1e-3, m.parameters()) for m in (tm, tm_j))

    @jax.jit
    def jstep(params, opt_state, x):  # train_encoder.py's train_step
        loss, g = jax.value_and_grad(
            lambda p: jnp.mean(jnp.square(jm.apply({"params": p}, x) - x)))(params)
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, g

    xt = torch.from_numpy(x)
    for i in range(3):
        params, opt_state, jloss, jgrads = jstep(params, opt_state, jnp.asarray(x))
        jg = interop.params_from_flax(jax.device_get(jgrads))
        if i == 0:  # from equal parameters: the gradients themselves
            opt.zero_grad(set_to_none=True)
            torch.mean(torch.square(tm(xt) - xt)).backward()
            for name, p in tm.named_parameters():
                scale = jg[name].abs().max().item()
                assert (p.grad - jg[name]).abs().max().item() <= 1e-3 * scale, name
        loss, _ = te.train_step(tm, opt, xt)
        assert abs(float(loss) - float(jloss)) <= 1e-6, (i, float(loss), float(jloss))
        for name, p in tm_j.named_parameters():
            p.grad = jg[name].clone()
        opt_j.step()
    want = interop.params_from_flax(jax.device_get(params))
    moved, apart, total = 0.0, 0, 0
    for name, p in tm.named_parameters():
        gap = (p.detach() - want[name]).abs()
        assert gap.max().item() <= 4e-3, name  # Adam's largest move in three steps
        apart += int((gap > 1e-5).sum())
        total += p.numel()
        np.testing.assert_allclose(dict(tm_j.named_parameters())[name].detach().numpy(),
                                   want[name].numpy(), rtol=0, atol=1e-7, err_msg=name)
        moved = max(moved, (p.detach() - start[name]).abs().max().item())
    assert apart <= 5e-4 * total, (apart, total)
    # Adam moved the weights far more than the bars they are held to
    assert moved > 2e-3


def test_params_to_flax_returns_copies():
    model, _ = te.build_autoencoder("vgg", seed=0)
    tree = interop.params_to_flax(model.state_dict())
    before = jax.tree.map(np.copy, tree)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    for k, v in jax.tree_util.tree_flatten_with_path(before)[0]:
        assert np.array_equal(flat[k], v), jax.tree_util.keystr(k)
    bias = tree["decoder"]["out"]["bias"]
    assert not np.shares_memory(bias, model.decoder.out.bias.detach().numpy())


def test_train_reports_every_step(tmp_path):
    from mri_inr_tpu.data import synthetic as jsyn
    from mri_inr_tpu.data.preprocessing import process_files

    jsyn.write_synthetic_h5(tmp_path, num_files=1, num_slices=2, height=64, width=64)
    meta = process_files(tmp_path)
    model, patch = te.build_autoencoder("conv", latent_dim=16, seed=0)
    seen = []
    args = argparse.Namespace(dataset=str(meta), batch_size=16, lr=1e-3, epochs=2,
                              output=str(tmp_path / "ae"), model="conv")
    res = te.train(args, model, patch, torch.device("cpu"),
                   lambda epoch, x, loss, out: seen.append((epoch, float(loss), out.shape)))
    steps = res["steps_per_epoch"]
    assert [e for e, _, _ in seen] == [0] * steps + [1] * steps
    assert all(shape == (16, 32, 32) for _, _, shape in seen)
    for epoch in range(2):
        mean = np.mean([loss for e, loss, _ in seen if e == epoch])
        assert mean == pytest.approx(res["losses"][epoch], rel=1e-6)
