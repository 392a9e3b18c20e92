"""The JAX package's initial weights drawn by the port
(``mri_inr_tpu_torch/models/flax_init.py``) against Flax's ``model.init``.

For seeds 0 and 7, ``init_params(port_model, seed)`` equals
``flax_model.init(jax.random.key(seed), sample)["params"]`` leaf by leaf,
with the same names and shapes: the ``ModulatedSiren`` at
``configs/train.yaml``'s width (H = 256, latent 256, L = 5) with the custom,
VGG and residual encoders and the Morlet activation, and the three
autoencoders ``train_encoder.py`` pretrains. The uniform (SIREN), zero and
one leaves are equal bit for bit; the truncated-normal (lecun-normal)
leaves within 1e-6 of the leaf's standard deviation (measured 5.1e-7 at
most: an ulp or two of ``erfinv``, ``utils/jax_random.py``). ``seeded``
loads the tree through ``interop``, and the train and pretraining CLIs
build their models through it.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.models import encoder as jenc
from mri_inr_tpu.models import modulated_siren as jms
from mri_inr_tpu.models import perceptual as jperc
from mri_inr_tpu_torch import interop
from mri_inr_tpu_torch.cli import train_encoder as tte
from mri_inr_tpu_torch.models import encoder as tenc
from mri_inr_tpu_torch.models import flax_init
from mri_inr_tpu_torch.models import modulated_siren as tms
from mri_inr_tpu_torch.models import perceptual as tperc
from mri_inr_tpu_torch.utils import jax_random as jr

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs"

#: configs/train.yaml's model
WIDTHS = dict(dim_hidden=256, latent_dim=256, num_layers=5)
SIRENS = {"custom": dict(), "vgg": dict(encoder_type="vgg"), "residual": dict(residual=True),
          "morlet": dict(activation="morlet")}


def _case(name):
    """(Flax model, its init sample, the port's model)."""
    if name in SIRENS:
        return (jms.ModulatedSiren(**WIDTHS, **SIRENS[name]), jnp.zeros((2, 32, 32)),
                tms.ModulatedSiren(**WIDTHS, **SIRENS[name], device="cpu"))
    if name == "conv_ae":
        return jenc.ConvAutoencoder(latent_dim=256), jnp.zeros((2, 32, 32)), tenc.ConvAutoencoder(256)
    if name == "vgg_ae":
        return jenc.VGGAutoencoder(), jnp.zeros((2, 32, 32)), tenc.VGGAutoencoder()
    return (jperc.PerceptualAutoencoderV2(latent_dim=256), jnp.zeros((2, 24, 24)),
            tperc.PerceptualAutoencoderV2(latent_dim=256))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", [*SIRENS, "conv_ae", "vgg_ae", "perceptual_ae"])
def test_init_params_equal_flax_init(name, seed):
    jmodel, sample, tmodel = _case(name)
    want = dict(_leaves(jax.device_get(jmodel.init(jax.random.key(seed), sample)["params"])))
    got = dict(_leaves(flax_init.init_params(tmodel, seed)))
    assert got.keys() == want.keys()
    # each leaf's initializer, as the port's layer that owns it names it
    params = dict(tmodel.named_parameters())
    specs = {}
    for mname, module in tmodel.named_modules():
        for leaf, spec in getattr(module, "flax_init", {}).items():
            key = f"{mname}.{leaf}" if mname else leaf
            if key in params:
                specs[tuple(interop.flax_leaf(key, params[key].detach().numpy())[0])] = spec[0]
    assert specs.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.dtype == np.float32 and g.shape == w.shape, path
        if specs[path] == "lecun_normal":
            assert np.abs(g - w).max() <= 1e-6 * w.std(), path
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(path))
    assert set(specs.values()) >= {"lecun_normal", "zeros"}


def test_fold_in_static_is_flaxs():
    from flax.core.scope import _fold_in_static

    key = jax.random.key(11)
    for suffix in [(), ("net",), ("net", "layer_0", 1), ("encoder", "encoder", "conv1", 2),
                   ("dec_block_1", "deconv", 300), ("x", 0)]:
        want = np.asarray(jax.random.key_data(_fold_in_static(key, suffix)))
        np.testing.assert_array_equal(flax_init.fold_in_static(jr.key(11), *suffix), want)


def test_seeded_loads_the_tree_and_keeps_the_running_statistics():
    model = tperc.PerceptualAutoencoderV2(latent_dim=32)
    flax_init.seeded(model, 3)
    want = interop.params_from_flax(flax_init.init_params(model, 3))
    for name, tensor in model.state_dict().items():
        if name.endswith("running_mean"):
            assert torch.equal(tensor, torch.zeros_like(tensor))
        elif name.endswith("running_var"):
            assert torch.equal(tensor, torch.ones_like(tensor))
        else:
            assert torch.equal(tensor, want[name]), name


def test_the_clis_build_the_jax_packages_weights():
    """``train_encoder.build_autoencoder`` and ``train.build_model`` (through
    its loader) start from the JAX package's weights, whatever the
    installed torch draws."""
    model, patch = tte.build_autoencoder("conv", latent_dim=32, seed=5)
    assert patch == 32
    want = jax.device_get(jenc.ConvAutoencoder(latent_dim=32).init(
        jax.random.key(5), jnp.zeros((2, 32, 32)))["params"])
    assert _max_gap(interop.params_to_flax(model.state_dict()), want) <= 1e-6

    from mri_inr_tpu_torch.cli import train as cli_train
    from mri_inr_tpu_torch.configuration import config as tconfig

    cfg = tconfig.load_train_configuration(
        CONFIGS / "train.yaml", ["model.dim_hidden=32", "model.latent_dim=16",
                               "model.num_layers=2", "training.seed=9"])
    model = cli_train.build_model(cfg, torch.device("cpu"), log=lambda *_: None)
    want = jax.device_get(jms.ModulatedSiren(dim_hidden=32, latent_dim=16, num_layers=2).init(
        jax.random.key(9), jnp.zeros((2, 32, 32)))["params"])
    assert _max_gap(interop.params_to_flax(model.state_dict()), want) <= 1e-6


def _max_gap(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    return max(float(np.abs(got[k] - want[k]).max()) / max(float(want[k].std()), 1e-30)
               for k in want)


# ------------------------------------------------- chip_smoke.py's draws phase
def _module(path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_recorded_draws_are_the_jax_packages():
    """``tests/data/jax_draws.json``, which ``chip_smoke.py`` holds the
    card's draws against, is what the JAX package draws here: every leaf's
    size and exact float64 sums at seeds 0 and 1, each leaf's initializer as
    the port names it, and the masks."""
    import json

    rec = _module(REPO / "tests" / "jax_draws_constants.py")
    recorded = json.loads(rec.OUT.read_text())
    assert sorted(recorded["models"]) == sorted(rec.models())
    for name, (jmodel, sample, port) in rec.models().items():
        kinds = rec.initializers(port())
        for seed in rec.SEEDS:
            sums = rec.leaf_sums(jax.device_get(jmodel.init(jax.random.key(seed), sample)["params"]))
            assert recorded["models"][name][str(seed)] == {k: [*v, kinds[k]]
                                                           for k, v in sums.items()}
    from mri_inr_tpu.data import kspace as jk
    from mri_inr_tpu.data import preprocessing as jpre

    assert len(recorded["masks"]) == rec.MASK_STEMS * len(rec.MASK_PAIRS)
    for key, want in recorded["masks"].items():
        stem, cf, acc = key.split("|")
        mask = np.asarray(jk.random_mask(jax.random.key(jpre._stable_seed(stem, float(cf),
                                                                          int(acc))),
                                         recorded["mask_width"], float(cf), int(acc)))
        assert np.packbits(mask).tobytes().hex() == want


def test_the_smokes_draws_phase_passes_here():
    """``chip_smoke.draws_path`` on this CPU (torch 2.13; the card's machine
    runs torch 2.11): the entry points' draws equal the recorded JAX draws
    (uniform, zero and one leaves and masks bit for bit), and a leaf moved by
    one ulp fails the check."""
    from mri_inr_tpu_torch.cli import train as cli_train
    from mri_inr_tpu_torch.configuration import config
    from mri_inr_tpu_torch.data import kspace, preprocessing

    smoke = _module(REPO / "chip_smoke.py")
    pkg = dict(config=config, cli_train=cli_train, train_encoder=tte, interop=interop,
               jax_random=jr, kspace=kspace, preprocessing=preprocessing)
    out = smoke.draws_path(pkg, "cpu")
    assert out["leaves"] == 286 and out["masks"] == 6
    import json

    recorded = json.loads(smoke.DRAWS_FILE.read_text())["models"]["conv_autoencoder"]["0"]
    model, _ = tte.build_autoencoder("conv", latent_dim=256, seed=0)
    tree = interop.variables_to_flax(model.state_dict())["params"]
    assert smoke.draw_mismatches(recorded, smoke.leaf_sums(tree)) == []
    tree["decoder"]["fc"]["bias"][0] = np.nextafter(np.float32(0), np.float32(1))
    (bad,) = smoke.draw_mismatches(recorded, smoke.leaf_sums(tree))
    assert bad.startswith("decoder/fc/bias (zeros)")
