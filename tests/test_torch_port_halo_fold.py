"""The halo fold (``parallel/halo_fold.py``) and the halo mode of the
reconstructor and the test CLI on the CPU: 4 gloo ranks (two of them in
the middle, receiving from both sides) against the port's one-process
``patches_to_image_weighted_average`` (1e-6) for the JAX package's
``(nv, nh)`` cases (``tests/test_halo_fold.py``), and against the JAX
package's own sharded fold on the conftest's 8 virtual devices; an
indivisible grid raises; one rank is the plain fold; the test CLI's rows
over 2 ranks with ``data.halo_fold=true`` within 1e-6 of the one-process
rows.
"""

import csv

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from mri_inr_tpu.data import synthetic as jsyn
from mri_inr_tpu.data.preprocessing import process_files
from mri_inr_tpu.parallel import halo_fold as jhalo
from mri_inr_tpu.parallel import mesh as jmesh
from mri_inr_tpu_torch.cli import test as cli_test
from mri_inr_tpu_torch.cli import train as cli_train
from mri_inr_tpu_torch.eval.evaluate import SliceReconstructor
from mri_inr_tpu_torch.ops import siren_kernel as sk
from mri_inr_tpu_torch.ops import tiling
from mri_inr_tpu_torch.parallel import halo_fold

torch.set_num_threads(1)

SIREN, INNER = ranks.SIREN, ranks.INNER
WORLD = 4


@pytest.fixture(scope="module")
def halo(tmp_path_factory):
    return ranks.run_scenario("halo", WORLD, tmp_path_factory.mktemp("halo"))


def _plain(nv, nh):
    patches = torch.from_numpy(ranks.halo_patches(nv, nh))
    return tiling.patches_to_image_weighted_average(patches, (nv, nh), SIREN, INNER).numpy()


@pytest.mark.parametrize("nv,nh", ranks.HALO_CASES)
def test_bands_match_the_one_process_fold(halo, nv, nh):
    want = _plain(nv, nh)
    band = nv // WORLD * INNER
    for r in range(WORLD):
        got = halo[r][f"band_{nv}x{nh}"]
        assert got.shape == (band, nh * INNER)
        np.testing.assert_allclose(got, want[r * band : (r + 1) * band], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(halo[r][f"image_{nv}x{nh}"], halo[0][f"image_{nv}x{nh}"])
    np.testing.assert_allclose(halo[0][f"image_{nv}x{nh}"], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("nv,nh", ranks.HALO_CASES)
def test_bands_match_the_jax_sharded_fold(halo, nv, nh):
    m = jmesh.make_mesh()
    patches = jhalo.shard_patches_by_rows(m, jnp.asarray(ranks.halo_patches(nv, nh)))
    want = np.asarray(jhalo.sharded_patches_to_image_weighted_average(
        patches, (nv, nh), SIREN, INNER, m))
    np.testing.assert_allclose(halo[0][f"image_{nv}x{nh}"], want, rtol=0, atol=1e-6)


def test_an_indivisible_grid_raises(halo):
    assert all("divisible" in str(h["indivisible"]) for h in halo)
    with pytest.raises(ValueError, match="divisible"):
        halo_fold.local_patch_rows(torch.zeros(6, SIREN, SIREN), (3, 2), 0, 2)


def test_one_rank_is_the_plain_fold():
    for nv, nh in [(4, 4), *ranks.HALO_CASES]:
        patches = torch.from_numpy(ranks.halo_patches(nv, nh))
        got = halo_fold.sharded_patches_to_image_weighted_average(patches, (nv, nh), SIREN,
                                                                  INNER, None)
        np.testing.assert_allclose(got.numpy(), _plain(nv, nh), rtol=0, atol=1e-6)
        assert halo_fold.gather_bands(got, None) is got


def test_local_fold_padded_keeps_the_vertical_halo():
    """The band's canvas: the plain fold's rows plus ``pad`` rows of halo
    above and below, the horizontal halo cropped (the JAX function's
    layout)."""
    nv, nh = 8, 5
    patches = torch.from_numpy(ranks.halo_patches(nv, nh))
    got = halo_fold.local_fold_padded(patches, nv, nh, SIREN, INNER)
    want = np.asarray(jhalo._local_fold_padded(jnp.asarray(patches.numpy()), nv, nh, SIREN,
                                               INNER))
    assert got.shape == want.shape == (nv * INNER + SIREN - INNER, nh * INNER)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_halo_reconstructor_matches_one_process(halo):
    """Every rank runs the eval forward on its band of patch rows only (its
    own eval-kernel wrapper's work: the CPU runs the plain version) and
    returns the whole slice, within 1e-6 of the one-process reconstructor."""
    model = ranks.small_model(0.0, "cpu")
    rec = SliceReconstructor(sk.make_apply_fn(model, use_pallas=True, sin5=True, device="cpu"),
                             patch_bucket=16, device="cpu")
    fully, under = np.random.default_rng(7).uniform(size=(2, 128, 80)).astype(np.float32)
    recon, _, _, m = rec(fully, under)
    for h in halo:
        np.testing.assert_allclose(h["slice_recon"], recon.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(h["slice_metrics"],
                                   [float(m[k]) for k in ("psnr", "ssim", "nrmse")], rtol=0,
                                   atol=1e-6)
        # one exchange a case and one for the slice
        assert int(h["exchange_calls"]) == len(ranks.HALO_CASES) + 1


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    jsyn.write_synthetic_h5(d, num_files=2, num_slices=2, height=64, width=80)
    return process_files(d)


MODEL_SETS = ["--set", "model.dim_hidden=32", "--set", "model.latent_dim=32",
              "--set", "model.num_layers=2"]


def _rows(path):
    with open(path, newline="") as f:
        return {r["FILENAME"]: [float(r[k]) for k in ("PSNR", "SSIM", "NRMSE")]
                for r in csv.DictReader(f)}


@pytest.mark.parametrize("sweep", ["true", "false"], ids=["device_sweep", "per_slice"])
def test_test_cli_halo_fold_over_two_ranks(corpus, tmp_path, sweep):
    """``data.halo_fold=true`` over 2 ranks: every rank takes every slice
    and reconstructs half its patch rows (64 rows: 4 patch rows, 2 a rank),
    the visual sample's too (rank 0 alone writes its images); rank 0 writes
    rows within 1e-6 of the one-process run's."""
    run = cli_train.main(["--device", "cpu", "--set", f"data.train.dataset={corpus}",
                          "--set", f"data.val.dataset={corpus}", *MODEL_SETS,
                          "--set", "training.batch_size=32", "--set", "training.epochs=1",
                          "--set", f"training.output_dir={tmp_path / 'train'}"]).run_dir
    argv = ["--device", "cpu", "--set", f"data.dataset={corpus}",
            "--set", f"data.model_path={run}", "--set", "data.output_name=halo",
            "--set", "data.batch_patches=64", "--set", f"data.device_sweep={sweep}",
            "--set", "data.visual_samples=1", *MODEL_SETS]
    outs = ranks.launch(["-m", "mri_inr_tpu_torch.cli.test", *argv,
                         "--set", f"data.output_dir={tmp_path / 'ranks'}",
                         "--set", "data.halo_fold=true"], 2, tmp_path / "launch")
    assert all("metric pass: 4 slices" in o for o in outs), outs
    cli_test.main(argv + ["--set", f"data.output_dir={tmp_path / 'one'}"])
    got = _rows(tmp_path / "ranks" / "halo" / "metrics_error.csv")
    want = _rows(tmp_path / "one" / "halo" / "metrics_error.csv")
    assert list(got) == list(want) and len(got) == 4
    (visual,) = [d for d in (tmp_path / "ranks" / "halo").iterdir() if d.is_dir()]
    assert (visual / f"{visual.name}_error.txt").is_file()
    for sid in want:
        np.testing.assert_allclose(got[sid], want[sid], rtol=0, atol=1e-6, err_msg=sid)
