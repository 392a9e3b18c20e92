"""The port's module-path train step (``make_train_step(use_pallas=False)``,
the path every residual model trains on) against the JAX package's Flax
autodiff step, ``mri_inr_tpu/train/trainer.py:make_train_step(use_pallas=
False)``, on the CPU.

From weights the JAX model's ``init`` draws, transplanted into the port's
model, dropout off, ``optimizer: sgd`` at lr 1e-3, three steps on the same
numpy-seeded batch, at ``test_torch_port_trainer.py``'s widths, plain and
residual:

- fp32: each step's loss within 1e-5 and the parameters after three steps
  within 1e-6 (``test_three_sgd_steps_match_jax``'s bars; measured over data
  seeds 0-2: losses 4.2e-7-7.8e-7, parameters 1.9e-9-1.5e-8).
- bf16 compute (both packages' ``from_config(..., precision="bf16")``): each
  step starts both packages from the port's parameters, so one step's gap
  does not compound. Each step's loss within 1e-3 (measured 4.9e-5-5.2e-4,
  the residual model's the larger: bf16 roundings of the forward in each
  framework's order) and every weight within 1e-5 after it (measured
  8.2e-7-2.7e-6). The biases are held against the JAX package's fp32 step
  from the same parameters, within 2e-5 (measured 1.1e-6-8.9e-6): the JAX
  bf16 step on the CPU moves every bias 2.2e-4-2.4e-4 away from its own fp32
  step (a last-layer bias gradient of about 1.46 comes out near 1.23), and
  the port's does not. Held three steps without re-syncing, that gap took
  the losses 3e-3 apart by the third step.

With ``model.dropout=0.1`` both packages drop with Flax's masks from the
step key ``fold_in(key(1), step)`` (the port's ``ops/dropout.py``), and the
same cases hold at the same bars.

``sin5`` is no parameter here: it reaches only the fused kernels
(``mri_inr_tpu/train/trainer.py:_make_forward``), never the module path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.configuration import config as jconfig
from mri_inr_tpu.models import modulated_siren as jms
from mri_inr_tpu.train import losses as jlosses
from mri_inr_tpu.train import trainer as jtrainer
from mri_inr_tpu_torch.configuration import config as tconfig
from mri_inr_tpu_torch.interop import load_flax_params, params_from_flax, params_to_flax
from mri_inr_tpu_torch.models import modulated_siren as tms
from mri_inr_tpu_torch.train import losses as tlosses
from mri_inr_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)

WIDTHS = ("model.dim_hidden=64", "model.latent_dim=32", "model.num_layers=3")


def _models(residual: bool, precision: str, dropout: float = 0.0):
    sets = [*WIDTHS, f"model.dropout={dropout}", f"model.residual={str(residual).lower()}"]
    jm = jms.from_config(jconfig.load_train_configuration(None, sets).model, precision)
    tm = tms.from_config(tconfig.load_train_configuration(None, sets).model, precision,
                         device="cpu")
    return jm, tm


def _batch(data_seed: int):
    data = np.random.default_rng(data_seed)
    fully = data.uniform(size=(16, 32, 32)).astype(np.float32)
    under = data.uniform(size=(16, 32, 32)).astype(np.float32)
    return fully, under


class Steppers:
    """Both packages' module-path SGD steps on one model configuration, from
    the weights the JAX model's ``init`` draws."""

    def __init__(self, residual: bool, precision: str, dropout: float = 0.0):
        jm, self.model = _models(residual, precision, dropout)
        self.jstate = jtrainer.create_train_state(jm, jax.random.key(0),
                                                  jnp.zeros((4, 32, 32)), "sgd", 1e-3)
        load_flax_params(self.model, jax.device_get(self.jstate.params))
        self.tstate = ttrainer.create_train_state(self.model, "sgd", 1e-3)
        self.jstep = jtrainer.make_train_step(jm, jlosses.mse, 32, 24, use_pallas=False)
        self.tstep = ttrainer.make_train_step(self.model, tlosses.mse, 32, 24,
                                              use_pallas=False)

    def step(self, fully, under) -> tuple[float, float]:
        self.jstate, jloss = self.jstep(self.jstate, jnp.asarray(fully), jnp.asarray(under),
                                        jax.random.key(1))
        tloss = self.tstep(self.tstate, torch.from_numpy(fully), torch.from_numpy(under), 1)
        return float(jloss), float(tloss)

    def sync_jax_to_port(self) -> None:
        self.jstate = self.jstate.replace(params=jax.tree.map(
            jnp.asarray, params_to_flax(dict(self.model.named_parameters()))))

    def jax_params(self) -> dict[str, torch.Tensor]:
        return params_from_flax(jax.device_get(self.jstate.params))

    def port_params(self) -> dict[str, torch.Tensor]:
        return {n: p.detach().clone() for n, p in self.model.named_parameters()}


def three_module_steps(residual: bool, data_seed: int = 0, dropout: float = 0.0):
    """(JAX losses, port losses, JAX parameters, port parameters, start)
    after three fp32 SGD steps of both packages' module path."""
    fully, under = _batch(data_seed)
    s = Steppers(residual, "fp32", dropout)
    start = s.port_params()
    losses = [s.step(fully, under) for _ in range(3)]
    assert s.tstate.step == int(s.jstate.step) == 3
    return ([j for j, _ in losses], [t for _, t in losses], s.jax_params(), s.port_params(),
            start)


def _check_three_steps(residual: bool, dropout: float):
    jl, tl, want, got, start = three_module_steps(residual, dropout=dropout)
    for i, (j, t) in enumerate(zip(jl, tl)):
        assert abs(t - j) <= 1e-5, (i, t, j)
    assert tl[2] < tl[0]  # the steps train
    for name, p in got.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    # the three steps moved the weights far more than the bar they are held to
    assert max((p - start[n]).abs().max().item() for n, p in got.items()) > 1e-3
    return jl, tl


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
def test_three_module_path_steps_match_jax(residual):
    _check_three_steps(residual, 0.0)


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
def test_three_module_path_steps_with_dropout_match_jax(residual):
    """Dropout 0.1: both packages drop with the same Flax masks, so the
    steps agree at the dropout-free bars; the masks change the losses."""
    jl, tl = _check_three_steps(residual, 0.1)
    assert abs(tl[0] - three_module_steps(residual)[1][0]) > 1e-4


def _check_bf16_steps(residual: bool, dropout: float):
    fully, under = _batch(0)
    s, ref = Steppers(residual, "bf16", dropout), Steppers(residual, "fp32", dropout)
    start = s.port_params()
    for i in range(3):
        s.sync_jax_to_port()
        ref.model.load_state_dict(s.model.state_dict())
        ref.sync_jax_to_port()
        jloss, tloss = s.step(fully, under)
        ref.step(fully, under)
        assert abs(tloss - jloss) <= 1e-3, (i, tloss, jloss)
        want, got, fp32 = s.jax_params(), s.port_params(), ref.jax_params()
        for name, p in got.items():
            if name.endswith("bias"):
                # the port's bias update is the fp32 step's; the JAX bf16
                # step's is not (the gap this test pins)
                np.testing.assert_allclose(p.numpy(), fp32[name].numpy(), rtol=0, atol=2e-5,
                                           err_msg=name)
            else:
                np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=1e-5,
                                           err_msg=name)
        jax_gap = max((want[n] - fp32[n]).abs().max().item() for n in got if n.endswith("bias"))
        assert jax_gap > 1e-4, (i, jax_gap)
    assert max((p - start[n]).abs().max().item() for n, p in s.port_params().items()) > 1e-3


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
def test_bf16_module_path_steps_match_jax(residual):
    _check_bf16_steps(residual, 0.0)


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
def test_bf16_module_path_steps_with_dropout_match_jax(residual):
    """Dropout 0.1 in bf16: the kept values scaled by Flax's bf16 keep
    probability (0.8984375), at the dropout-free bars."""
    _check_bf16_steps(residual, 0.1)


def test_residual_model_has_its_skip_on_both_sides():
    """The residual cases are not the plain model twice: on the same weights
    and batch the residual model's first loss differs from the plain one's,
    on both sides."""
    plain, residual = three_module_steps(False), three_module_steps(True)
    assert abs(plain[1][0] - residual[1][0]) > 1e-3
    assert abs(plain[0][0] - residual[0][0]) > 1e-3
