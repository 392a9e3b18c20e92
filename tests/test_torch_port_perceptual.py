"""The port's perceptual encoders, autoencoders and loss against the JAX
package's on the CPU, from Flax ``init`` variables (with running statistics
drawn from a numpy seed, so eval mode reads them) transplanted by
``interop.variables_from_flax`` (the loss and the Adam step:
``test_torch_port_perceptual_loss.py``).

- V1 / V2 encoders and autoencoders in eval mode: outputs within 1e-5;
- in train mode (batch statistics): the updated running statistics within
  1e-6 of Flax's ``mutable=["batch_stats"]`` (Flax's momentum 0.99 and
  biased batch variance; measured 1.2e-7 to 7.2e-7). The outputs are
  normalised by the batch's own statistics, ``E[x^2] - E[x]^2`` over four
  samples in the FC blocks, which magnifies f32 rounding: both packages sit
  4e-5 to 2e-4 from the same computation in float64 (measured on these
  inputs), so the bar is ``max(1e-5, 2 x`` the JAX output's own distance
  from the port's float64 run``)``, and the port must be no further from
  float64 than JAX is;
- ``variables_to_flax`` undoes ``variables_from_flax``, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.models import perceptual as jperc
from mri_inr_tpu_torch import interop
from mri_inr_tpu_torch.models import perceptual as tperc

torch.set_num_threads(1)

MODELS = {
    "encoder_v2": (jperc.PerceptualEncoderV2, tperc.PerceptualEncoderV2),
    "autoencoder_v2": (jperc.PerceptualAutoencoderV2, tperc.PerceptualAutoencoderV2),
    "encoder_v1": (jperc.PerceptualEncoderV1, tperc.PerceptualEncoderV1),
    "autoencoder_v1": (jperc.PerceptualAutoencoderV1, tperc.PerceptualAutoencoderV1),
}


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


def _port(name, variables):
    tm = MODELS[name][1]()
    tm.load_state_dict(interop.variables_from_flax(variables), strict=True)
    return tm


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_mode_matches_flax(name):
    jm = MODELS[name][0]()
    variables = _variables(jm)
    tm = _port(name, variables).eval()
    x = _images((3, 24, 24), seed=1)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(MODELS))
def test_train_mode_and_running_stats_match_flax(name):
    jm = MODELS[name][0]()
    variables = _variables(jm, seed=2)
    tm = _port(name, variables).train()
    x = _images((4, 24, 24), seed=3)
    want, updates = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    want = np.asarray(want)
    got = tm(torch.from_numpy(x)).detach().numpy()
    exact = MODELS[name][1](compute_dtype=torch.float64).double()
    exact.load_state_dict(interop.variables_from_flax(variables), strict=True)
    exact = exact.train()(torch.from_numpy(x).double()).detach().numpy()
    jax_err, port_err = np.abs(want - exact).max(), np.abs(got - exact).max()
    assert port_err <= jax_err
    assert np.abs(got - want).max() <= max(1e-5, 2 * jax_err)
    new = interop.variables_to_flax(tm.state_dict())["batch_stats"]
    a, b = _flat_stats(_np(updates["batch_stats"])), _flat_stats(new)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-6, err_msg=k)
    # the port's BatchNorm keeps no num_batches_tracked: a strict load both ways
    assert not any("num_batches_tracked" in k for k in tm.state_dict())


def test_running_variance_is_the_biased_one():
    bn = tperc.BatchNorm(3).train()
    x = torch.from_numpy(_images((5, 3, 2, 2), seed=4))
    bn(x)
    batch_var = x.permute(1, 0, 2, 3).reshape(3, -1).var(dim=1, unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.99 * torch.ones(3) + 0.01 * batch_var,
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("name", ["autoencoder_v2", "autoencoder_v1"])
def test_variables_round_trip(name):
    variables = _variables(MODELS[name][0](), seed=10)
    back = interop.variables_to_flax(interop.variables_from_flax(variables))
    for part in ("params", "batch_stats"):
        a, b = _flat_stats(variables[part]), _flat_stats(back[part])
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
