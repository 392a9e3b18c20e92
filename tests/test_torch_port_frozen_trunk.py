"""A SIREN on a frozen VGG trunk (``vgg_frozen_corpus``'s setting:
``model.encoder_type=vgg``, ``training.freeze_encoder=true``) trained by the
port's step on both routes against the JAX package's
``mri_inr_tpu/train/trainer.py:make_train_step`` on the CPU: the fused
route (the kernels' plain versions, ``sin5``) against ``make_train_step(
use_pallas=True, interpret=True, sin5=True, freeze_encoder=True)``, the
module route against ``make_train_step(use_pallas=False,
freeze_encoder=True)``, the route the JAX row took. SIREN at H=64, latent
32, L=3, dropout off, fp32, one numpy-seeded batch of 16.

The trunk is the JAX model's seeded Flax init, and for the ill-posed case
every trunk kernel times ``ILL_POSED`` (2.0: thirteen ReLU convs with zero
biases, so the features grow by 2^13), which puts the trunk's feature mean
over the batch at or above 1 (the port's ``vgg_frozen_corpus@seed2`` trunk
had 1.191 when its row went to NaN on the card) and the latent at tens.

- Control, the trunk as drawn: three SGD steps at lr 1e-3 on each route,
  each package on its own: losses within 1e-5, parameters within 1e-6 (the
  bars of ``test_torch_port_trainer.py::test_three_sgd_steps_match_jax``);
  the trunk bit for bit at its init on both sides. The same with
  ``model.dropout=0.1``, as the JAX rows trained: the module route drops
  with Flax's masks under ``fold_in(key(1), step)`` on both sides, the fused
  route with the JAX train CLI's fused seeds (its one-device mesh step,
  rank 0 folded in, as the port's per-step route draws them). On this
  trunk the untrained SIREN's hidden activations are small, so the masks
  move the parameters little, but more than the packages part: without
  them the port lies 5.6e-7 / 6.8e-7 (module / fused) from JAX's dropped
  steps, with them 9.3e-10 / 3.5e-7.
- Ill-posed: five Adam steps of the port (configs/train.yaml's lr 1e-4);
  before each, the JAX package's step from the port's parameters (SGD at lr
  2^20, so its update is its gradient scaled exactly) and from those
  parameters nudged by a relative 1e-6: over the five steps the median gap
  of the port's loss and of its gradients (the largest relative norm over
  the trained tensors) to the JAX package's is below the median gap the
  nudge makes in the JAX package's own. Measured, fused / module: loss
  7.8e-4 / 4.0e-4 against 7.1e-3 / 9.6e-3; gradients 0.26 / 0.13 against
  1.35 / 1.69. The gradient is not defined at f32 precision here, and the
  port is as close to JAX as JAX is to itself. Every value finite, the
  frozen trunk's gradient zero on both sides and its weights unmoved.
- Ill-posed under SGD at lr 1e-4: both packages' losses leave the finite
  range or pass 1e3 within three steps, on both routes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.configuration import config as jconfig
from mri_inr_tpu.models import modulated_siren as jms
from mri_inr_tpu.parallel import mesh as jmesh
from mri_inr_tpu.train import losses as jlosses
from mri_inr_tpu.train import trainer as jtrainer
from mri_inr_tpu_torch.configuration import config as tconfig
from mri_inr_tpu_torch.interop import load_flax_params, params_from_flax, params_to_flax
from mri_inr_tpu_torch.models import modulated_siren as tms
from mri_inr_tpu_torch.train import losses as tlosses
from mri_inr_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)

SETS = ("model.dim_hidden=64", "model.latent_dim=32", "model.num_layers=3",
        "model.encoder_type=vgg")
DROPOUT = 0.1  # the JAX rows' model.dropout (configs/train.yaml)
ILL_POSED = 2.0
TRUNK = "encoder.encoder.trunk."
ROUTES = ["fused", "module"]


def _batch():
    data = np.random.default_rng(0)
    fully = data.uniform(size=(16, 32, 32)).astype(np.float32)
    under = data.uniform(size=(16, 32, 32)).astype(np.float32)
    return fully, under


def _sets(dropout: float = 0.0) -> list[str]:
    return [*SETS, f"model.dropout={dropout}"]


def _jax_model(dropout: float = 0.0):
    return jms.from_config(jconfig.load_train_configuration(None, _sets(dropout)).model)


@pytest.fixture(scope="module")
def jax_model():
    return _jax_model()


def _init(jm, scale: float) -> dict:
    """The JAX model's init (numpy), every trunk kernel times ``scale``."""
    state = jtrainer.create_train_state(jm, jax.random.key(0), jnp.zeros((4, 32, 32)), "sgd",
                                        1e-3)
    params = jax.tree.map(np.asarray, jax.device_get(state.params))
    for layer in params["encoder"]["encoder"]["trunk"].values():
        layer["kernel"] = layer["kernel"] * np.float32(scale)
    return params


def _port_model(params, dropout: float = 0.0) -> torch.nn.Module:
    cfg = tconfig.load_train_configuration(None, _sets(dropout))
    return load_flax_params(tms.from_config(cfg.model, "fp32", device="cpu"), params)


def _jax_step(jm, route: str, optimizer: str, lr: float, params, mesh=None):
    """(the JAX package's jitted step on ``route``, its state at ``params``)."""
    fused = route == "fused"
    step = jtrainer.make_train_step(jm, jlosses.mse, 32, 24, mesh=mesh, use_pallas=fused,
                                    interpret=fused, sin5=fused, freeze_encoder=True)
    state = jtrainer.create_train_state(jm, jax.random.key(0), jnp.zeros((4, 32, 32)),
                                        optimizer, lr)
    p = jax.tree.map(jnp.asarray, params)
    return step, state.replace(params=p, opt_state=state.tx.init(p))


def _port_step(tm, route: str, optimizer: str, lr: float):
    fused = route == "fused"
    state = ttrainer.create_train_state(tm, optimizer, lr)
    step = ttrainer.make_train_step(tm, tlosses.mse, 32, 24, use_pallas=fused, sin5=fused,
                                    freeze_encoder=True)
    return step, state


def test_the_scaled_trunk_is_ill_posed(jax_model):
    _, under = (torch.from_numpy(a) for a in _batch())
    with torch.no_grad():
        for scale, lo, hi in ((1.0, 0.0, 0.1), (ILL_POSED, 1.0, np.inf)):
            tm = _port_model(_init(jax_model, scale))
            feats = tm.encoder.encoder.trunk(under)
            assert lo <= feats.mean().item() < hi, (scale, feats.mean().item())
        assert tm.encode(under).abs().max().item() >= 10.0


@pytest.mark.parametrize("route,dropout", [("fused", 0.0), ("module", 0.0),
                                           ("fused", DROPOUT), ("module", DROPOUT)],
                         ids=["fused", "module", "fused-dropout", "module-dropout"])
def test_frozen_trunk_sgd_steps_match_jax(jax_model, route, dropout):
    """The control: the trunk as drawn, each package on its own, dropout off
    and at the JAX rows' rate."""
    fully, under = _batch()
    params = _init(jax_model, 1.0)
    jm, mesh = jax_model, None
    if dropout:
        jm = _jax_model(dropout)
        # the JAX train CLI's fused step runs under a mesh, one device here
        mesh = jmesh.make_mesh(1) if route == "fused" else None
    jstep, jstate = _jax_step(jm, route, "sgd", 1e-3, params, mesh)
    jbatch = (jnp.asarray(fully), jnp.asarray(under))
    if mesh is not None:
        jbatch = jmesh.shard_batch(mesh, *jbatch)
    tm = _port_model(params, dropout)
    init = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tstep, tstate = _port_step(tm, route, "sgd", 1e-3)
    losses = []
    for i in range(3):
        jstate, jloss = jstep(jstate, *jbatch, jax.random.key(1))
        losses.append(float(tstep(tstate, torch.from_numpy(fully), torch.from_numpy(under), 1)))
        assert abs(losses[-1] - float(jloss)) <= 1e-5, (i, losses[-1], float(jloss))
    assert losses[-1] < losses[0]
    want = params_from_flax(jax.device_get(jstate.params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
        if name.startswith(TRUNK):
            assert torch.equal(p.detach(), init[name]), name
    assert max((p.detach() - init[n]).abs().max().item()
               for n, p in tm.named_parameters()) > 1e-4
    if dropout:  # the masks were drawn: the port without them parts further from JAX
        free = _port_model(params)
        free_step, free_state = _port_step(free, route, "sgd", 1e-3)
        for _ in range(3):
            free_step(free_state, torch.from_numpy(fully), torch.from_numpy(under), 1)
        gap, free_gap = (max((p.detach() - want[n]).abs().max().item()
                             for n, p in m.named_parameters()) for m in (tm, free))
        assert free_gap > gap, (gap, free_gap)


def _nudged(params, eps: float):
    """``params`` with every element outside the trunk times 1 +- eps."""
    rng = np.random.default_rng(7)

    def nudge(path, a):
        if "trunk" in jax.tree_util.keystr(path):
            return a
        return (a * (1 + eps * rng.choice([-1.0, 1.0], size=a.shape))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(nudge, params)


@pytest.mark.parametrize("route", ROUTES)
def test_ill_posed_frozen_trunk_steps_match_jax_to_its_conditioning(jax_model, route):
    fully, under = _batch()
    lr_probe = 2.0 ** 20
    jstep, jstate = _jax_step(jax_model, route, "sgd", lr_probe, _init(jax_model, 1.0))

    def probe(params):
        """The JAX package's loss and gradients at ``params``."""
        new, loss = jstep(jstate.replace(params=jax.tree.map(jnp.asarray, params)),
                          jnp.asarray(fully), jnp.asarray(under), jax.random.key(1))
        grads = jax.tree.map(lambda a, b: (a - np.asarray(b)) / np.float32(lr_probe), params,
                             jax.device_get(new.params))
        return float(loss), params_from_flax(grads)

    tm = _port_model(_init(jax_model, ILL_POSED))
    init = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tstep, tstate = _port_step(tm, route, "adam", 1e-4)
    gaps = {"loss": [], "loss_nudged": [], "grad": [], "grad_nudged": []}
    trained = [n for n, _ in tm.named_parameters() if not n.startswith(TRUNK)]
    for i in range(5):
        params = params_to_flax(dict(tm.named_parameters()))
        jloss, jgrad = probe(params)
        nloss, ngrad = probe(_nudged(params, 1e-6))
        tloss = float(tstep(tstate, torch.from_numpy(fully), torch.from_numpy(under), 1))
        assert all(np.isfinite([tloss, jloss, nloss])), (i, tloss, jloss, nloss)
        got = dict(tm.named_parameters())
        for name in got:
            if name.startswith(TRUNK):
                assert got[name].grad is None or not got[name].grad.any(), name
                assert not jgrad[name].any(), name
        rel = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-30))
        gaps["loss"].append(abs(tloss - jloss) / jloss)
        gaps["loss_nudged"].append(abs(nloss - jloss) / jloss)
        gaps["grad"].append(max(rel(got[n].grad, jgrad[n]) for n in trained))
        gaps["grad_nudged"].append(max(rel(ngrad[n], jgrad[n]) for n in trained))
    med = {k: float(np.median(v)) for k, v in gaps.items()}
    assert med["loss"] < med["loss_nudged"], gaps
    assert med["grad"] < med["grad_nudged"], gaps
    for name, p in tm.named_parameters():
        if name.startswith(TRUNK):
            assert torch.equal(p.detach(), init[name]), name


@pytest.mark.parametrize("route", ROUTES)
def test_ill_posed_frozen_trunk_diverges_under_sgd_in_both_packages(jax_model, route):
    fully, under = _batch()
    params = _init(jax_model, ILL_POSED)
    jstep, jstate = _jax_step(jax_model, route, "sgd", 1e-4, params)
    tstep, tstate = _port_step(_port_model(params), route, "sgd", 1e-4)
    jl, tl = [], []
    for _ in range(3):
        jstate, loss = jstep(jstate, jnp.asarray(fully), jnp.asarray(under), jax.random.key(1))
        jl.append(float(loss))
        tl.append(float(tstep(tstate, torch.from_numpy(fully), torch.from_numpy(under), 1)))
    for losses in (jl, tl):
        assert np.isfinite(losses[0]) and losses[0] < 1.0, (jl, tl)
        assert not all(np.isfinite(losses)) or max(losses) > 1e3, (jl, tl)
