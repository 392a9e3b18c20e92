"""The port's perceptual loss and the perceptual autoencoder's train step
against the JAX package's on the CPU, from Flax ``init`` variables with
running statistics drawn from a numpy seed.

- the perceptual loss and its gradient with respect to the prediction:
  1e-5; no gradient reaches the frozen encoder, which stays in eval mode;
- one train-mode Adam step (lr 1e-3) of ``PerceptualAutoencoderV2`` (the
  ``train_encoder --model perceptual`` step) against ``optax.adam``: loss
  within 1e-5, gradients within 1e-6 (measured 3.3e-7), running statistics
  within 1e-6; the parameters within 1e-5 where the gradient is above
  rounding noise (|g| >= 1e-6; Adam's first step is ``lr * g / (|g| +
  1e-8)``, so a noise-level gradient's step is unbounded by any bar on g),
  and within 2.4e-7 (two f32 steps at 1.0) everywhere with JAX's gradients
  through the port's Adam.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mri_inr_tpu.models import perceptual as jperc
from mri_inr_tpu.train import losses as jlosses
from mri_inr_tpu_torch import interop
from mri_inr_tpu_torch.models import perceptual as tperc
from mri_inr_tpu_torch.train import losses as tlosses
from mri_inr_tpu_torch.train.trainer import make_optimizer

torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _images(shape, seed=0):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _variables(jm, seed=0):
    """Flax init variables with running statistics drawn from a seed."""
    v = _np(jm.init(jax.random.key(seed), jnp.zeros((2, 24, 24))))
    rng = np.random.default_rng(seed + 100)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(scale=0.1, size=a.shape) if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, size=a.shape)).astype(np.float32),
        v["batch_stats"])
    return {"params": v["params"], "batch_stats": stats}


def _flat_stats(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port(variables):
    tm = tperc.PerceptualAutoencoderV2()
    tm.load_state_dict(interop.variables_from_flax(variables), strict=True)
    return tm


def test_perceptual_loss_and_its_gradient_match_jax():
    enc = jperc.PerceptualEncoderV2()
    variables = _variables(enc, seed=5)
    pred, target = _images((3, 24, 24), seed=6), _images((3, 24, 24), seed=7)
    jloss = jlosses.make_loss_fn("perceptual", variables, 24)
    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(pred), jnp.asarray(target))
    tloss = tlosses.make_loss_fn("perceptual", interop.variables_from_flax(variables), 24)
    p = torch.from_numpy(pred).requires_grad_(True)
    got = tloss(p, torch.from_numpy(target))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=0, atol=1e-5)
    # frozen: no gradient into the encoder, which stays in eval mode
    assert all(q.grad is None and not q.requires_grad for q in tloss.encoder.parameters())
    assert not tloss.encoder.training
    with pytest.raises(ValueError, match="perceptual_encoder_path"):
        tlosses.make_loss_fn("perceptual")


def test_one_adam_step_of_the_autoencoder_matches_optax():
    jm = jperc.PerceptualAutoencoderV2()
    variables = _variables(jm, seed=8)
    x = _images((4, 24, 24), seed=9)
    lr = 1e-3
    tx = optax.adam(lr)

    def loss_of(params):
        out, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.mean(jnp.square(out - x)), upd

    (jl, upd), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(variables["params"])
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    want = {"params": _flat_stats(_np(optax.apply_updates(variables["params"], updates))),
            "batch_stats": _flat_stats(_np(upd["batch_stats"]))}
    jgrads = _flat_stats(_np(grads))

    def step(own_grads: bool):
        tm = _port(variables).train()
        opt = make_optimizer("adam", lr, tm.parameters())
        xt = torch.from_numpy(x)
        loss = torch.mean(torch.square(tm(xt) - xt))
        loss.backward()
        names = {id(p): k for k, p in tm.named_parameters()}
        tg = _flat_stats(interop.params_to_flax({k: p.grad for k, p in tm.named_parameters()}))
        if not own_grads:  # JAX's gradients through the port's Adam
            jt = interop.params_from_flax(_np(grads))
            for p in tm.parameters():
                p.grad.copy_(jt[names[id(p)]])
        opt.step()
        return float(loss.detach()), tg, interop.variables_to_flax(tm.state_dict())

    loss, tg, got = step(own_grads=True)
    np.testing.assert_allclose(loss, float(jl), rtol=0, atol=1e-5)
    for k, g in jgrads.items():
        np.testing.assert_allclose(tg[k], g, rtol=0, atol=1e-6, err_msg=k)
    got_stats = _flat_stats(got["batch_stats"])
    for k, v in want["batch_stats"].items():
        np.testing.assert_allclose(got_stats[k], v, rtol=0, atol=1e-6, err_msg=k)
    # Adam's first step moves an element by lr * g / (|g| + 1e-8): where the
    # gradient is rounding noise (|g| below 1e-6; one BatchNorm scale here has
    # 2.7e-8) no bar on g bounds the step, so the port's own step is held
    # where |g| >= 1e-6, and JAX's gradients through the port's Adam everywhere
    # (BatchNorm scales near 1.0: one f32 step there is 1.2e-7)
    got_params = _flat_stats(got["params"])
    for k, v in want["params"].items():
        sure = np.abs(jgrads[k]) >= 1e-6
        np.testing.assert_allclose(got_params[k][sure], v[sure], rtol=0, atol=1e-5, err_msg=k)
    _, _, same = step(own_grads=False)
    same = _flat_stats(same["params"])
    for k, v in want["params"].items():
        np.testing.assert_allclose(same[k], v, rtol=0, atol=2.4e-7, err_msg=k)
