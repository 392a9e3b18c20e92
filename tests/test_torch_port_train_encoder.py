"""The port's autoencoder pretraining (``python -m
mri_inr_tpu_torch.cli.train_encoder``) and what its files feed, on the CPU.

- ``main --model conv`` on a 96x96 phantom corpus: the loss falls, the
  files are written every 10 epochs and at the last; ``--evaluate`` rows
  are within 1e-3 dB PSNR (SSIM, NRMSE 1e-5) of the same weights through the
  JAX package's model, tiling and metric functions;
- the files feed the train CLI: ``model.encoder_path`` (the SIREN's
  encoder equals the autoencoder's before the first step), a VGG file with
  ``encoder_type=vgg`` (the trunk spliced, the ``fc`` head as a fresh
  seeded model's; ``freeze_encoder`` trains the head only) and a perceptual
  file as ``training.perceptual_encoder_path``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.data import synthetic as jsyn
from mri_inr_tpu.data.dataset import MRISampler as JaxSampler
from mri_inr_tpu.data.preprocessing import process_files
from mri_inr_tpu.eval.metrics import image_metrics as jax_metrics
from mri_inr_tpu.models import encoder as jenc
from mri_inr_tpu.ops import tiling as jtiling
from mri_inr_tpu_torch import interop
from mri_inr_tpu_torch.cli import train as cli_train
from mri_inr_tpu_torch.cli import train_encoder
from mri_inr_tpu_torch.configuration import config as config_lib
from mri_inr_tpu_torch.models import encoder as tenc

torch.set_num_threads(1)

SIREN = ["model.dim_hidden=32", "model.num_layers=2"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("ae96")
    jsyn.write_synthetic_h5(d, num_files=2, num_slices=2, height=96, width=96)
    return process_files(d)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """One 64x64 slice (16 patches): the VGG and perceptual runs."""
    d = tmp_path_factory.mktemp("ae64")
    jsyn.write_synthetic_h5(d, num_files=1, num_slices=1, height=64, width=64)
    return process_files(d)


@pytest.fixture(scope="module")
def conv_run(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("conv_ae")
    result = train_encoder.main(["--dataset", str(corpus), "--output", str(out),
                                 "--model", "conv", "--latent-dim", "16", "--epochs", "12",
                                 "--batch-size", "32", "--device", "cpu"])
    return out, result


def test_train_encoder_loss_falls_and_files_are_written(conv_run):
    out, result = conv_run
    losses = result["losses"]
    assert len(losses) == 12 and losses[-1] < 0.7 * losses[0]
    names = sorted(p.name for p in out.iterdir())
    assert names == ["conv_autoencoder_epoch_00009.pt", "conv_autoencoder_epoch_00009_full.pt",
                     "conv_autoencoder_epoch_00011.pt", "conv_autoencoder_epoch_00011_full.pt"]
    state = torch.load(out / names[2], weights_only=True)
    model, _ = train_encoder.build_autoencoder("conv", 16)
    model.load_state_dict(state, strict=True)


def test_evaluate_matches_the_jax_functions(conv_run, corpus, tmp_path):
    out, _ = conv_run
    full = out / "conv_autoencoder_epoch_00011_full.pt"
    rows = train_encoder.main(["--dataset", str(corpus), "--output", str(tmp_path),
                               "--model", "conv", "--latent-dim", "16", "--evaluate", str(full),
                               "--num-samples", "3", "--device", "cpu"])
    assert len(rows) == 3
    assert (tmp_path / "ae_metrics.csv").read_text().count("\n") == 4
    jm = jenc.ConvAutoencoder(latent_dim=16)
    params = interop.params_to_flax(torch.load(full, weights_only=True))
    sampler = JaxSampler(corpus)
    for sid, m in rows:
        pair = sampler.next_sample()
        assert pair.slice_id == sid
        img = jnp.asarray(pair.fully_sampled)
        patches = jtiling.image_to_patches(img, 32, 16)
        recon = jtiling.patches_to_image(jm.apply({"params": params}, patches),
                                         jtiling.grid_shape(*img.shape, 16), 32, 16)
        want = jax_metrics(img, recon[: img.shape[0], : img.shape[1]])
        assert abs(m["psnr"] - float(want["psnr"])) <= 1e-3
        assert abs(m["ssim"] - float(want["ssim"])) <= 1e-5
        assert abs(m["nrmse"] - float(want["nrmse"])) <= 1e-5


def _train_argv(metadata, out, *extra):
    sets = [f"data.train.dataset={metadata}", f"data.val.dataset={metadata}",
            "data.val.max_slice_num=0", *SIREN, "training.batch_size=16",
            "training.save_interval=1000", f"training.output_dir={out}",
            "training.output_name=ae", *extra]
    return ["--device", "cpu"] + [x for s in sets for x in ("--set", s)]


def test_conv_file_is_the_sirens_encoder_before_the_first_step(conv_run, corpus, tmp_path):
    out, _ = conv_run
    path = out / "conv_autoencoder_epoch_00011.pt"
    t = cli_train.main(_train_argv(corpus, tmp_path, "model.latent_dim=16", "training.epochs=0",
                                   f"model.encoder_path={path}"))
    ae = torch.load(path, weights_only=True)
    for k, v in t.model.encoder.encoder.state_dict().items():
        assert torch.equal(v, ae[f"encoder.{k}"]), k
    t = cli_train.main(_train_argv(corpus, tmp_path, "model.latent_dim=16", "training.epochs=2",
                                   f"model.encoder_path={path}"))
    assert t._progress[-1]["train_loss"] < t.initial_losses[0]


def test_vgg_file_splices_the_trunk_and_freezing_trains_the_head(small, tmp_path):
    ae_dir = tmp_path / "vgg_ae"
    result = train_encoder.main(["--dataset", str(small), "--output", str(ae_dir), "--model",
                                 "vgg", "--epochs", "1", "--batch-size", "8",
                                 "--device", "cpu"])
    assert np.isfinite(result["losses"]).all()
    path = ae_dir / "vgg_autoencoder_epoch_00000.pt"
    ae = torch.load(path, weights_only=True)
    argv = _train_argv(small, tmp_path, "model.latent_dim=16", "model.encoder_type=vgg",
                       f"model.encoder_path={path}", "training.freeze_encoder=true")
    t = cli_train.main(argv + ["--set", "training.epochs=0"])
    enc = t.model.encoder.encoder
    assert isinstance(enc, tenc.VGGEncoder)
    for k, v in enc.trunk.state_dict().items():
        assert torch.equal(v, ae[f"trunk.{k}"]), k
    fresh = cli_train.build_model(config_lib.load_train_configuration(
        None, ["model.latent_dim=16", "model.encoder_type=vgg", *SIREN]), torch.device("cpu"))
    assert torch.equal(enc.fc.weight, fresh.encoder.encoder.fc.weight)
    trunk0 = {k: v.clone() for k, v in enc.trunk.state_dict().items()}
    fc0 = enc.fc.weight.detach().clone()
    t = cli_train.main(argv + ["--set", "training.epochs=1"])
    enc = t.model.encoder.encoder
    for k, v in enc.trunk.state_dict().items():
        assert torch.equal(v, trunk0[k]), k
    assert not torch.equal(enc.fc.weight, fc0)


def test_perceptual_file_drives_the_perceptual_loss(small, tmp_path):
    ae_dir = tmp_path / "perc_ae"
    train_encoder.main(["--dataset", str(small), "--output", str(ae_dir), "--model",
                        "perceptual", "--epochs", "1", "--batch-size", "8", "--device", "cpu"])
    path = ae_dir / "perceptual_autoencoder_epoch_00000.pt"
    enc_state = torch.load(path, weights_only=True)
    assert "block_0.bn_0.running_var" in enc_state and "dec_fc.fc.weight" not in enc_state
    full = torch.load(ae_dir / "perceptual_autoencoder_epoch_00000_full.pt", weights_only=True)
    for k, v in enc_state.items():
        assert torch.equal(v, full[f"encoder.{k}"])
    # the running statistics moved during the train-mode epoch
    assert not torch.equal(enc_state["block_0.bn_0.running_var"], torch.ones(64))
    t = cli_train.main(_train_argv(small, tmp_path, "training.criterion=perceptual",
                                   f"training.perceptual_encoder_path={path}",
                                   "training.epochs=2"))
    loss_fn = cli_train.build_loss_fn(config_lib.load_train_configuration(
        None, ["training.criterion=perceptual", f"training.perceptual_encoder_path={path}"]),
        torch.device("cpu"))
    for k, v in loss_fn.encoder.state_dict().items():
        assert torch.equal(v, enc_state[k])
    assert np.isfinite([r["train_loss"] for r in t._progress]).all()
    assert t._progress[-1]["train_loss"] < t.initial_losses[0]
    with pytest.raises(ValueError, match="perceptual_encoder_path"):
        cli_train.main(_train_argv(small, tmp_path, "training.criterion=perceptual",
                                   "training.epochs=0"))
