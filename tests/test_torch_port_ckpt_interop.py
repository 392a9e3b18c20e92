"""The checkpoint interop tool (``scripts/torch_checkpoint_interop.py``):
JAX Orbax run directories and encoder directories to the port's files and
back. The round trip is exact on the parameters, Adam's ``mu`` / ``nu`` /
``count`` and the step; the converted model's forward (f32, the module
path) equals the JAX model's within 1e-6; the converted files are what
the port's CLIs read."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.configuration import config as jconfig
from mri_inr_tpu.models import encoder as jenc
from mri_inr_tpu.models import modulated_siren as jms
from mri_inr_tpu.models import perceptual as jperc
from mri_inr_tpu.train import checkpoint as jckpt
from mri_inr_tpu.train import losses as jlosses
from mri_inr_tpu.train import trainer as jtrainer
from mri_inr_tpu_torch import interop
from mri_inr_tpu_torch.train import checkpoint as tckpt
from mri_inr_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPEC = importlib.util.spec_from_file_location("torch_checkpoint_interop",
                                              ROOT / "scripts" / "torch_checkpoint_interop.py")
tool = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(tool)

SETS = ["model.dim_hidden=32", "model.latent_dim=32", "model.num_layers=2",
        "training.lr=1e-3", "training.precision=fp32"]


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX run directory: three Adam steps (the moments and the count are
    not at their initial values), checkpointed by the JAX package."""
    cfg = jconfig.load_train_configuration(None, SETS)
    run = tmp_path_factory.mktemp("jax") / "run_2026-01-01_00-00-00"
    run.mkdir()
    jconfig.save_config_yaml(cfg, run / "config.yaml")
    state = tool._jax_state(cfg)
    step = jtrainer.make_train_step(jms.from_config(cfg.model, cfg.training.precision),
                                    jlosses.mse, 32, 24)
    rng = np.random.default_rng(0)
    fully, under = (jnp.asarray(rng.uniform(size=(8, 32, 32)).astype(np.float32))
                    for _ in range(2))
    for _ in range(3):
        state, _ = step(state, fully, under, jax.random.key(1))
    jckpt.save_state(run, int(state.step), state)
    return cfg, run, state


def test_run_round_trip_is_exact(jax_run, tmp_path):
    cfg, run, state = jax_run
    tool.main(["jax-to-torch", "run", "--run-dir", str(run), "--out", str(tmp_path / "port")])
    payload = torch.load(tmp_path / "port" / "checkpoints" / "step_00000003" / "state.pt",
                         weights_only=True)
    assert payload["step"] == 3
    want = interop.params_from_flax(jax.device_get(state.params))
    names = list(want)
    for name in names:
        assert torch.equal(payload["model"][name], want[name]), name
    adam = tool._adam(state.opt_state)
    mu, nu = (interop.params_from_flax(jax.device_get(t)) for t in (adam.mu, adam.nu))
    model_names = [n for n, _ in tool._port_model(
        tool._configs(run, None)[1].model, "fp32").named_parameters()]
    for i, name in enumerate(model_names):
        st = payload["optimizer"]["state"][i]
        assert torch.equal(st["exp_avg"], mu[name]) and torch.equal(st["exp_avg_sq"], nu[name])
        assert int(st["step"]) == int(adam.count) == 3
    assert (tmp_path / "port" / "config.yaml").read_text() == (run / "config.yaml").read_text()

    tool.main(["torch-to-jax", "run", "--run-dir", str(tmp_path / "port"),
               "--out", str(tmp_path / "back")])
    back = jckpt.restore_state(tmp_path / "back", 3, tool._jax_state(cfg))
    assert int(back.step) == 3
    for a, b in zip(_leaves(state.params) + _leaves(state.opt_state),
                    _leaves(back.params) + _leaves(back.opt_state)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_converted_model_forward_matches_jax(jax_run, tmp_path):
    cfg, run, state = jax_run
    tool.main(["jax-to-torch", "run", "--run-dir", str(run), "--out", str(tmp_path / "port")])
    model = tool._port_model(tool._configs(run, None)[1].model, "fp32")
    tckpt.restore_state(tmp_path / "port", 3, ttrainer.create_train_state(model, "adam", 1e-3))
    tiles = np.random.default_rng(2).uniform(size=(64, 32, 32)).astype(np.float32)
    jm = jms.from_config(cfg.model, cfg.training.precision)
    want = np.asarray(jm.apply({"params": state.params}, jnp.asarray(tiles),
                               deterministic=True))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(tiles)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)  # measured 7.5e-7


def test_the_port_scores_a_converted_run(jax_run, tmp_path):
    """The test CLI restores the converted run directory; its refusal of a
    JAX step directory names the tool."""
    from mri_inr_tpu_torch.cli import test as cli_test

    _, run, _ = jax_run
    with pytest.raises(NotImplementedError, match="torch_checkpoint_interop.py jax-to-torch"):
        cli_test._restore(torch.nn.Linear(1, 1), run / "checkpoints" / "step_00000003")
    tool.main(["jax-to-torch", "run", "--run-dir", str(run), "--out", str(tmp_path / "port")])
    model = tool._port_model(tool._configs(run, None)[1].model, "fp32")
    assert cli_test._restore(model, tmp_path / "port").endswith("step 3")


def _init(kind, latent=16):
    key, x32, x24 = jax.random.key(0), jnp.zeros((2, 32, 32)), jnp.zeros((2, 24, 24))
    if kind == "conv":
        return jenc.ConvAutoencoder(latent_dim=latent).init(key, x32)
    if kind == "vgg":
        return jenc.VGGAutoencoder().init(key, x32)
    cls = (jperc.PerceptualAutoencoderV2 if kind == "perceptual"
           else jperc.PerceptualAutoencoderV1)
    return cls(latent_dim=latent).init(key, x24)


def _nudged(tree):
    """Every leaf moved off its initial value (BatchNorm's mean 0 and var 1
    would round-trip trivially)."""
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.default_rng(3)
    return jax.tree.unflatten(treedef, [np.asarray(x) + rng.uniform(0.1, 0.2, np.shape(x))
                                        .astype(np.float32) for x in leaves])


@pytest.mark.parametrize("kind,whole", [("conv", False), ("conv", True), ("vgg", False),
                                        ("perceptual", False), ("perceptual", True),
                                        ("perceptual_v1", False), ("perceptual_v1", True)])
def test_encoder_round_trip_is_exact(kind, whole, tmp_path):
    """The files ``train_encoder.py`` writes: a conv / VGG autoencoder's
    params (``_full``: under ``params``); a perceptual encoder's params and
    BatchNorm statistics (``_full``: the whole autoencoder's)."""
    import orbax.checkpoint as ocp

    variables = _nudged(jax.device_get(_init(kind)))
    if kind in ("conv", "vgg"):
        tree = {"params": variables["params"]} if whole else variables["params"]
    elif whole:
        tree = variables
    else:
        tree = {"params": variables["params"]["encoder"],
                "batch_stats": variables["batch_stats"]["encoder"]}
    name = f"{kind}_autoencoder_epoch_00000" + ("_full" if whole else "")
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save((tmp_path / "jax" / name).absolute(), tree)
    pt = tool.main(["jax-to-torch", "encoder", "--model", kind, "--path",
                    str(tmp_path / "jax" / name), "--out", str(tmp_path / f"{name}.pt")])
    state = torch.load(pt, weights_only=True)
    want = (interop.variables_from_flax(tree) if "params" in tree
            else interop.params_from_flax(tree))
    assert state.keys() == want.keys()
    assert all(torch.equal(state[k], want[k]) for k in want)
    if kind.startswith("perceptual"):
        assert any(k.endswith("running_var") for k in state)
    tool.main(["torch-to-jax", "encoder", "--model", kind, "--path", str(pt),
               "--out", str(tmp_path / "back" / name)])
    with ocp.StandardCheckpointer() as ckptr:
        back = ckptr.restore((tmp_path / "back" / name).absolute())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(_leaves(tree), _leaves(back)):
        assert np.array_equal(a, b)


def test_a_converted_conv_encoder_splices_through_the_train_cli(tmp_path):
    import orbax.checkpoint as ocp
    from mri_inr_tpu.data import synthetic as jsyn
    from mri_inr_tpu.data.preprocessing import process_files
    from mri_inr_tpu_torch.cli import train as cli_train

    params = _nudged(jax.device_get(_init("conv", latent=32))["params"])
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save((tmp_path / "conv_ae").absolute(), params)
    jsyn.write_synthetic_h5(tmp_path / "d", num_files=1, num_slices=1, height=64, width=64)
    meta = process_files(tmp_path / "d")
    argv = ["--device", "cpu", "--set", f"data.train.dataset={meta}",
            "--set", f"data.val.dataset={meta}", "--set", "training.epochs=0",
            "--set", "training.batch_size=16", "--set", f"training.output_dir={tmp_path}/o",
            *(a for s in SETS[:3] for a in ("--set", s))]
    with pytest.raises(NotImplementedError, match="jax-to-torch encoder"):
        cli_train.main(argv + ["--set", f"model.encoder_path={tmp_path / 'conv_ae'}"])
    pt = tool.main(["jax-to-torch", "encoder", "--model", "conv", "--path",
                    str(tmp_path / "conv_ae"), "--out", str(tmp_path / "conv_ae.pt")])
    t = cli_train.main(argv + ["--set", f"model.encoder_path={pt}"])
    want = interop.params_from_flax(params["encoder"])
    for name, p in t.model.encoder.encoder.state_dict().items():
        assert torch.equal(p, want[name]), name
