"""Training data, losses and the state carried across, against the JAX
package on the same numpy inputs: batch composition and tiles are identical,
losses agree to 1e-6, the Adam state maps both ways without loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu import native as jnative
from mri_inr_tpu.data import dataset as jds
from mri_inr_tpu.data import synthetic as jsyn
from mri_inr_tpu.data.preprocessing import process_files
from mri_inr_tpu.models.modulated_siren import ModulatedSiren as JaxModel
from mri_inr_tpu.train import losses as jlosses
from mri_inr_tpu.train import trainer as jtrainer
from mri_inr_tpu_torch import interop
from mri_inr_tpu_torch import native as tnative
from mri_inr_tpu_torch.data import dataset as tds
from mri_inr_tpu_torch.models.modulated_siren import ModulatedSiren
from mri_inr_tpu_torch.models.perceptual import PerceptualEncoderV2
from mri_inr_tpu_torch.train import losses as tlosses
from mri_inr_tpu_torch.train import trainer as ttrainer

# the test workers share the cores: one torch thread each, so no idle
# OpenMP pool spins against the other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def metadata(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    jsyn.write_synthetic_h5(d, num_files=2, num_slices=3, height=64, width=80)
    return process_files(d)


@pytest.mark.parametrize("n,batch,seed,shuffle", [
    (64, 32, 0, True), (70, 32, 4, True), (70, 32, 4, False), (5, 8, 1, True),
    (400, 400, 2, True), (0, 8, 0, True),
])
def test_epoch_index_batches_match_jax(n, batch, seed, shuffle):
    want = jds.epoch_index_batches(n, batch, seed, shuffle)
    got = tds.epoch_index_batches(n, batch, seed, shuffle)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if n:
        np.testing.assert_array_equal(ttrainer.make_epoch_perm(n, batch, seed, shuffle),
                                      jtrainer.make_epoch_perm(n, batch, seed, shuffle))
        assert ttrainer.make_epoch_perm(n, batch, seed, shuffle).dtype == np.int32


@pytest.mark.parametrize("shape,outer,inner", [((64, 80), 32, 16), ((50, 37), 32, 16),
                                               ((48, 48), 24, 8)])
def test_native_helpers_match_jax(shape, outer, inner):
    rng = np.random.default_rng(0)
    img = rng.uniform(size=shape).astype(np.float32)
    want, wgrid = jnative.tile_image(img, outer, inner)
    got, ggrid = tnative.tile_image(img, outer, inner)
    assert ggrid == wgrid
    np.testing.assert_array_equal(got, want)
    got2, _ = tds.tile_image_np(img, outer, inner)
    np.testing.assert_array_equal(got2, want)
    idx = rng.integers(0, len(want), size=7)
    for g, w in zip(tnative.gather_pairs(got, got[::-1].copy(), idx),
                    jnative.gather_pairs(want, want[::-1].copy(), idx)):
        np.testing.assert_array_equal(g, w)
    # the JAX package's C++ mean sums in another order than numpy's f64 mean
    np.testing.assert_allclose(tnative.patch_means(got), jnative.patch_means(want),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(max_slice_num=1), dict(num_samples=3),
                                dict(filter_black=True)],
                         ids=["all", "max_slice", "subset", "filter_black"])
def test_dataset_tiles_and_batch_order_match_jax(metadata, kw):
    want, got = jds.MRIDataset(metadata, **kw), tds.MRIDataset(metadata, **kw)
    assert len(got) == len(want) > 0
    assert [r["slice_id"] for r in got.rows] == [r["slice_id"] for r in want.rows]
    np.testing.assert_array_equal(got.fully_tiles, want.fully_tiles)
    np.testing.assert_array_equal(got.under_tiles, want.under_tiles)
    for prefetch in (0, 2):
        gb = list(got.batches(32, seed=4, shuffle=True, prefetch=prefetch))
        wb = list(want.batches(32, seed=4, shuffle=True))
        assert len(gb) == len(wb)
        for (gf, gu), (wf, wu) in zip(gb, wb):
            np.testing.assert_array_equal(gf, wf)
            np.testing.assert_array_equal(gu, wu)
    np.testing.assert_array_equal(got.get_slice(4).undersampled, want.get_slice(4).undersampled)
    assert got.get_slice(4).slice_id == want.get_slice(4).slice_id
    f, u = got[3]
    np.testing.assert_array_equal(f, want[3][0])
    np.testing.assert_array_equal(u, want[3][1])


def test_dataset_manifest_random_slice_and_empty_selection(metadata, tmp_path):
    ds = tds.MRIDataset(metadata)
    ds.write_manifest(tmp_path / "processed_files.txt")
    jds.MRIDataset(metadata).write_manifest(tmp_path / "jax.txt")
    assert (tmp_path / "processed_files.txt").read_text() == (tmp_path / "jax.txt").read_text()
    pair = ds.get_random_slice(np.random.default_rng(0))
    assert pair.slice_id in {r["slice_id"] for r in ds.rows}
    with pytest.raises(ValueError, match="No slices"):
        tds.MRIDataset(metadata, mri_type="T1")


def test_prefetch_iter_raises_the_producers_exception():
    def gen():
        yield 1
        raise KeyError("boom")

    it = tds.prefetch_iter(gen(), depth=1)
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)
    assert list(tds.prefetch_iter(iter(range(5)), depth=2)) == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("name", ["mse", "edge_loss"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(5, 24, 24)).astype(np.float32)
    target = rng.normal(size=(5, 24, 24)).astype(np.float32)
    want = float(getattr(jlosses, name)(jnp.asarray(pred), jnp.asarray(target)))
    got = float(getattr(tlosses, name)(torch.from_numpy(pred), torch.from_numpy(target)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_sobel_maps_are_a_zero_padded_correlation():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 9, 11)).astype(np.float32))
    gx, gy = tlosses._sobel_maps(x)
    kx = torch.tensor([[1.0, 0, -1], [2, 0, -2], [1, 0, -1]])
    ref = lambda k: torch.nn.functional.conv2d(x[:, None], k[None, None], padding=1)[:, 0]
    torch.testing.assert_close(gx, ref(kx), rtol=0, atol=1e-5)
    torch.testing.assert_close(gy, ref(kx.t()), rtol=0, atol=1e-5)
    jx, jy = jlosses._sobel_maps(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jy), rtol=0, atol=1e-6)


def test_make_loss_fn():
    assert tlosses.make_loss_fn("mse") is tlosses.mse
    assert tlosses.make_loss_fn("edge") is tlosses.edge_loss
    with pytest.raises(ValueError, match="perceptual_encoder_path"):
        tlosses.make_loss_fn("perceptual")
    state = PerceptualEncoderV2(generator=torch.Generator().manual_seed(0)).state_dict()
    loss = tlosses.make_loss_fn("perceptual", state)
    x = torch.rand(2, 24, 24, generator=torch.Generator().manual_seed(1))
    assert float(loss(x, x)) == 0.0 and float(loss(x, 1 - x)) > 0
    with pytest.raises(ValueError):
        tlosses.make_loss_fn("bogus")


def _flax_params():
    jm = JaxModel(dim_hidden=64, latent_dim=32, num_layers=3)
    tiles = np.random.default_rng(1).uniform(size=(2, 32, 32)).astype(np.float32)
    return jax.device_get(jm.init(jax.random.key(0), jnp.asarray(tiles))["params"])


def test_params_to_flax_inverts_params_from_flax():
    params = _flax_params()
    back = interop.params_to_flax(interop.params_from_flax(params))
    flat_w = jax.tree_util.tree_leaves_with_path(params)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(flat_g[path], np.asarray(leaf))


def test_adam_state_round_trip():
    """optax (count, mu, nu) -> torch Adam state_dict -> back, bit for bit;
    the loaded optimizer holds the moments in the port's layout."""
    import optax

    params = _flax_params()
    tx = optax.adam(1e-3)
    grads = jax.tree.map(lambda p: jnp.asarray(np.random.default_rng(p.size).normal(
        size=p.shape).astype(np.float32)), params)
    opt_state = tx.init(params)
    for _ in range(3):
        _, opt_state = tx.update(grads, opt_state, params)
    adam = jax.device_get(opt_state[0])

    tm = ModulatedSiren(dim_hidden=64, latent_dim=32, num_layers=3, device="cpu")
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    opt.load_state_dict(interop.adam_state_from_optax(tm, opt, int(adam.count), adam.mu,
                                                      adam.nu))
    names = [n for n, _ in tm.named_parameters()]
    want_mu = interop.params_from_flax(adam.mu)
    for i, (name, p) in enumerate(tm.named_parameters()):
        st = opt.state[p]
        assert int(st["step"]) == 3
        assert st["exp_avg"].shape == p.shape, name
        torch.testing.assert_close(st["exp_avg"], want_mu[names[i]], rtol=0, atol=0)
    count, mu, nu = interop.adam_state_to_optax(tm, opt)
    assert count == 3
    for got, want in ((mu, adam.mu), (nu, adam.nu)):
        flat = dict(jax.tree_util.tree_leaves_with_path(got))
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            np.testing.assert_array_equal(flat[path], np.asarray(leaf))
