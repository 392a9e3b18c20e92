"""The port's online k-space pipeline (``mri_inr_tpu_torch/data/online.py``)
on the CPU (``device="cpu"``: ``torch.fft`` where the card runs the DFT
kernel) against the JAX package's ``mri_inr_tpu/data/online.py`` and the
port's own offline pipeline, on three 3-slice 64 x 48 phantom ``.h5``
volumes.

- The port draws the JAX package's masks (``jax.random`` under the same
  keys, remask epochs 0-3 bit for bit), and its tiles equal JAX's
  ``materialize`` within 2e-5 (``torch.fft`` against ``jnp.fft``, the
  preprocessing bar; measured 3.6e-7), remask on and off, and on the hard
  corpus's complex, noisy, textured k-space with remasking. ``mask_fn``
  replaces the draw.
- Remask off, the online tiles and slices equal the port's offline pipeline
  (``process_files`` -> ``MRIDataset`` / ``MRISampler``) within 2e-6
  (measured 0: the same masks, reconstruction and normalisation), also
  where volumes have more slices than ``max_slice_num`` keeps.
- The counterparts of the seven cases of tests/test_online.py, the hi == lo
  guard, ``device_stacks`` consuming the sampler as ``next_sample`` does,
  ``from_volumes`` against the ``.h5`` route, the trainer and both CLIs.
"""

import jax
import numpy as np
import pytest
import torch

from mri_inr_tpu.data import kspace as jkspace
from mri_inr_tpu.data import synthetic as jsyn
from mri_inr_tpu.data.online import OnlineKspaceDataset as JaxOnline
from mri_inr_tpu.data.online import OnlineSampler as JaxOnlineSampler
from mri_inr_tpu_torch.cli import test as cli_test
from mri_inr_tpu_torch.cli import train as cli_train
from mri_inr_tpu_torch.data import preprocessing as tpre
from mri_inr_tpu_torch.data.dataset import MRIDataset, MRISampler
from mri_inr_tpu_torch.data.online import OnlineKspaceDataset, OnlineSampler
from mri_inr_tpu_torch.eval import evaluate as tev
from mri_inr_tpu_torch.models.modulated_siren import ModulatedSiren
from mri_inr_tpu_torch.ops.siren_kernel import make_apply_fn
from mri_inr_tpu_torch.train import checkpoint as ckpt_lib
from mri_inr_tpu_torch.train import losses as tlosses
from mri_inr_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)

WIDTHS = dict(dim_hidden=32, latent_dim=32, num_layers=2)
MODEL_SET = [f"model.{k}={v}" for k, v in WIDTHS.items()]
JAX_BAR = 2e-5
OFFLINE_BAR = 2e-6


@pytest.fixture(scope="module")
def h5_root(tmp_path_factory):
    d = tmp_path_factory.mktemp("online_data")
    jsyn.write_synthetic_h5(d, num_files=3, num_slices=3, height=64, width=48)
    tpre.process_files(d, device="cpu")
    return d


@pytest.fixture(scope="module")
def metadata(h5_root):
    return h5_root / "processed" / "metadata.csv"


def _online(root, **kw):
    return OnlineKspaceDataset(root, device="cpu", **kw)


def jax_masks(stems, width, remask, cf=0.05, acc=6):
    """``mask_fn`` giving the JAX package's masks: the stable key of the
    volume, folded with the epoch when remasking (``online.py:156-160``)."""
    def mask_fn(volume, epoch):
        key = jax.random.key(tpre._stable_seed(stems[volume], cf, acc))
        if remask:
            key = jax.random.fold_in(key, epoch)
        return np.asarray(jkspace.random_mask(key, width, cf, acc))
    return mask_fn


def _np(t):
    return np.asarray(t)


@pytest.fixture(scope="module")
def hard_h5_root(tmp_path_factory):
    """The volumes of ``h5_root`` in the hard mode of the hard-corpus table:
    complex phase maps, k-space noise at SNR 32 dB, texture 0.18."""
    d = tmp_path_factory.mktemp("online_hard")
    jsyn.write_synthetic_h5(d, num_files=3, num_slices=3, height=64, width=48, phase=True,
                            snr_db=32.0, texture=0.18)
    return d


# ------------------------------------------------------------------ tiles
@pytest.mark.parametrize("remask, corpus", [(True, "h5_root"), (False, "h5_root"),
                                            (True, "hard_h5_root")],
                         ids=["remask", "fixed", "hard"])
def test_tiles_match_jax_with_its_masks(request, remask, corpus):
    h5_root = request.getfixturevalue(corpus)
    jds = JaxOnline(h5_root, remask_each_epoch=remask)
    tds = _online(h5_root, remask_each_epoch=remask)
    assert tds.stems == jds.stems and tds.slice_ids == jds.slice_ids and len(tds) == len(jds)
    want = jax_masks(tds.stems, 48, remask)
    for epoch in range(4):
        for v in range(len(tds.stems)):
            np.testing.assert_array_equal(tds.masks(epoch)[v], want(v, epoch))
    for epoch in (0, 1, 2):
        jf, ju = jds.materialize(epoch)
        tf, tu = tds.materialize(epoch)
        np.testing.assert_allclose(tf.numpy(), _np(jf), rtol=0, atol=JAX_BAR)
        np.testing.assert_allclose(tu.numpy(), _np(ju), rtol=0, atol=JAX_BAR)
    jfi, jui = jds.device_image_stacks()
    tfi, tui = tds.device_image_stacks()
    np.testing.assert_allclose(tfi.numpy(), _np(jfi), rtol=0, atol=JAX_BAR)
    np.testing.assert_allclose(tui.numpy(), _np(jui), rtol=0, atol=JAX_BAR)


def test_offline_parity(h5_root, metadata):
    offline = MRIDataset(metadata)
    online = _online(h5_root, remask_each_epoch=False)
    assert len(online) == len(offline)
    fully, under = online.materialize(epoch=7)  # the epoch does not matter
    np.testing.assert_allclose(fully.numpy(), offline.fully_tiles, rtol=0, atol=OFFLINE_BAR)
    np.testing.assert_allclose(under.numpy(), offline.under_tiles, rtol=0, atol=OFFLINE_BAR)


def test_offline_parity_with_slice_truncation(tmp_path):
    """Volumes with more slices than max_slice_num keeps: the min-max window
    still spans the whole volume, as offline preprocessing normalises before
    the slice filter."""
    jsyn.write_synthetic_h5(tmp_path, num_files=2, num_slices=5, height=64, width=48)
    meta = tpre.process_files(tmp_path, device="cpu")
    offline = MRIDataset(meta, max_slice_num=2)
    online = _online(tmp_path, max_slice_num=2, remask_each_epoch=False)
    assert len(online) == len(offline) == 2 * 3 * 12
    fully, under = online.materialize(0)
    np.testing.assert_allclose(fully.numpy(), offline.fully_tiles, rtol=0, atol=OFFLINE_BAR)
    np.testing.assert_allclose(under.numpy(), offline.under_tiles, rtol=0, atol=OFFLINE_BAR)


def test_remask_changes_under_not_fully(h5_root):
    online = _online(h5_root, remask_each_epoch=True)
    f0, u0 = online.materialize(0)
    u0 = u0.clone()
    f1, u1 = online.materialize(1)
    assert f0 is f1  # made once
    assert bool((u0 != u1).any())  # fresh masks
    f2, u2 = online.materialize(2)
    assert u2 is u1  # one persistent buffer, rewritten per mask epoch
    _, again = online.materialize(0)
    assert torch.equal(again, u0)


def test_remask_epochs_are_deterministic_and_not_the_offline_masks(h5_root):
    a = _online(h5_root, remask_each_epoch=True)
    b = _online(h5_root, remask_each_epoch=True)
    assert torch.equal(a.materialize(3)[1], b.materialize(3)[1])
    fixed = _online(h5_root, remask_each_epoch=False)
    assert not np.array_equal(a.masks(0), fixed.masks(0))
    assert np.array_equal(fixed.masks(0), fixed.masks(5))


def test_masks_are_the_preprocessing_draws(h5_root):
    """Remask off: one mask per volume under ``key(_stable_seed(stem, cf,
    acc))``, the draw of process_kspace_volume; remask on: under
    ``fold_in(key, epoch)``; ``mask_fn`` replaces both."""
    from mri_inr_tpu_torch.data import kspace
    from mri_inr_tpu_torch.utils import jax_random as jr

    fixed = _online(h5_root, remask_each_epoch=False)
    remask = _online(h5_root, remask_each_epoch=True)
    for v, stem in enumerate(fixed.stems):
        key = jr.key(tpre._stable_seed(stem, 0.05, 6))
        want = kspace.random_mask(key, 48, 0.05, 6)
        assert np.array_equal(fixed.masks(4)[v], want)
        want = kspace.random_mask(jr.fold_in(key, 4), 48, 0.05, 6)
        assert np.array_equal(remask.masks(4)[v], want)
    full = _online(h5_root, remask_each_epoch=True, mask_fn=lambda v, e: np.ones(48, bool))
    assert full.masks(2).all()
    np.testing.assert_array_equal(full.materialize(2)[1].numpy(),
                                  full.materialize(2)[0].numpy())


def test_batches_and_get_slice(h5_root):
    online = _online(h5_root, remask_each_epoch=True)
    n, batch = len(online), 7
    got = 0
    fully, under = (t.numpy() for t in online.materialize(0))
    for f, u in online.batches(batch, seed=0):
        assert f.shape == (batch, 32, 32) and u.shape == (batch, 32, 32)
        got += batch
    assert got == -(-n // batch) * batch
    first = next(iter(online.batches(batch, seed=0, shuffle=False)))
    assert np.array_equal(first[0], fully[:batch]) and np.array_equal(first[1], under[:batch])
    pair = online.get_slice(0)
    assert pair.fully_sampled.shape == (64, 48)
    assert pair.slice_id.endswith("_0")
    pair.fully_sampled[:] = -1.0  # a fresh copy: the cache is untouched
    assert online.get_slice(0).fully_sampled.min() >= 0.0


def test_constant_volume_gives_zeros_not_nan():
    """hi == lo: a constant volume normalises to zeros."""
    rng = np.random.default_rng(0)
    live = (rng.normal(size=(2, 32, 32)) + 1j * rng.normal(size=(2, 32, 32))).astype(np.complex64)
    dead = np.zeros((2, 32, 32), np.complex64)
    ds = OnlineKspaceDataset.from_volumes(["live_flair", "dead_flair"], [live, dead],
                                          device="cpu", remask_each_epoch=False)
    fully, under = ds.materialize(0)
    assert bool(torch.isfinite(fully).all()) and bool(torch.isfinite(under).all())
    per = ds.patches_per_slice * 2
    assert float(fully[per:].abs().max()) == 0.0 and float(under[per:].abs().max()) == 0.0
    assert float(fully[:per].max()) > 0.5


def test_from_volumes_equals_the_h5_route(h5_root):
    via_h5 = _online(h5_root, remask_each_epoch=True)
    paths = sorted(h5_root.glob("*.h5"))
    direct = OnlineKspaceDataset.from_volumes([p.stem for p in paths],
                                              [tpre.load_h5(p) for p in paths],
                                              remask_each_epoch=True, device="cpu")
    assert direct.stems == via_h5.stems and direct.slice_ids == via_h5.slice_ids
    for e in (0, 1):
        for a, b in zip(direct.materialize(e), via_h5.materialize(e)):
            assert torch.equal(a, b)


def test_construction_refusals(h5_root, tmp_path):
    with pytest.raises(FileNotFoundError):
        _online(h5_root, mri_type="T1")
    a = np.zeros((2, 32, 32), np.complex64)
    b = np.zeros((2, 32, 48), np.complex64)
    with pytest.raises(ValueError, match="one .S, H, W. shape"):
        OnlineKspaceDataset.from_volumes(["a", "b"], [a, b], device="cpu")


def test_slice_selection_follows_select_rows(h5_root, metadata):
    """The slice_num filter, then the seeded choice: the offline dataset's
    rows and the online slice ids name the same slices."""
    offline = MRIDataset(metadata, max_slice_num=1, num_samples=4, seed=3)
    online = _online(h5_root, max_slice_num=1, num_samples=4, seed=3,
                     remask_each_epoch=False)
    assert [online.slice_id(i) for i in range(4)] == [r["slice_id"] for r in offline.rows]
    fully, under = online.materialize(0)
    np.testing.assert_allclose(under.numpy(), offline.under_tiles, rtol=0, atol=OFFLINE_BAR)


# --------------------------------------------------------------- samplers
def test_online_sampler_matches_offline_sampler(h5_root, metadata):
    offline = MRISampler(metadata)
    online = OnlineSampler(_online(h5_root, remask_each_epoch=False))
    assert len(online) == len(offline)
    for _ in range(len(offline)):
        a, b = offline.next_sample(), online.next_sample()
        assert a.slice_id == b.slice_id
        np.testing.assert_allclose(b.fully_sampled, a.fully_sampled, rtol=0, atol=OFFLINE_BAR)
        np.testing.assert_allclose(b.undersampled, a.undersampled, rtol=0, atol=OFFLINE_BAR)
    s0, s1 = online.shard(0, 2), online.shard(1, 2)
    o0, o1 = offline.shard(0, 2), offline.shard(1, 2)
    assert len(s0) + len(s1) == len(offline)
    assert [s0.next_sample().slice_id for _ in range(len(s0))] == [
        o0.next_sample().slice_id for _ in range(len(o0))]
    assert s1.next_sample().slice_id == o1.next_sample().slice_id


@pytest.mark.parametrize("num_samples", [None, 5])
def test_online_sampler_order_is_jaxs(h5_root, num_samples):
    jax_sampler = JaxOnlineSampler(JaxOnline(h5_root, remask_each_epoch=False),
                                   num_samples=num_samples, host_prefetch=False)
    sampler = OnlineSampler(_online(h5_root, remask_each_epoch=False),
                            num_samples=num_samples, host_prefetch=False)
    assert len(sampler) == len(jax_sampler)
    jids, _, _ = jax_sampler.device_stacks()
    ids, _, _ = sampler.device_stacks()
    assert ids == jids


def test_device_stacks_consume_the_sampler_as_next_sample_does(h5_root):
    ds = _online(h5_root, remask_each_epoch=False)
    ref = OnlineSampler(ds, host_prefetch=False)
    sampler = OnlineSampler(ds, host_prefetch=False)
    sampler.next_sample()
    sampler.next_sample()  # a visual pass took two slices
    ids, fully, under = sampler.device_stacks(8)  # 9 slices: wraps after 7
    ref.next_sample()
    ref.next_sample()
    want = [ref.next_sample() for _ in range(8)]
    assert ids == [p.slice_id for p in want]
    assert np.array_equal(fully.numpy(), np.stack([p.fully_sampled for p in want]))
    assert np.array_equal(under.numpy(), np.stack([p.undersampled for p in want]))
    assert sampler.next_sample().slice_id == ref.next_sample().slice_id
    assert ds._imgs_np is None  # no bulk copy to the host was asked for


def test_host_prefetch_copies_the_stacks_once(h5_root):
    ds = _online(h5_root, remask_each_epoch=False)
    OnlineSampler(ds, host_prefetch=True)
    assert ds._imgs_np is not None and ds._imgs_np[0].shape == (9, 64, 48)
    assert OnlineSampler(_online(h5_root), host_prefetch=None).dataset._imgs_np is None  # < 64


def test_device_sweep_rows_equal_the_offline_sweep(h5_root, metadata):
    model = ModulatedSiren(**WIDTHS, device="cpu", generator=torch.Generator().manual_seed(0))
    recon = tev.SliceReconstructor(make_apply_fn(model, device="cpu", sin5=True),
                                   patch_bucket=64, device="cpu")
    got, timings = tev.evaluate_files_device(
        recon, OnlineSampler(_online(h5_root, remask_each_epoch=False), host_prefetch=False),
        log=lambda *_: None)
    want = tev.evaluate_files(recon, MRISampler(metadata), progress_every=0)
    assert [r.slice_id for r in got] == [r.slice_id for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([g.psnr, g.ssim, g.nrmse], [w.psnr, w.ssim, w.nrmse],
                                   rtol=0, atol=1e-6)
    assert set(timings) == {"stage_seconds", "dispatch_seconds", "execute_fetch_seconds"}


# ---------------------------------------------------------------- trainer
def _model(seed=0, **kw):
    return ModulatedSiren(**{**WIDTHS, **kw}, device="cpu",
                          generator=torch.Generator().manual_seed(seed))


def test_trainer_scan_epoch_with_online(h5_root, tmp_path):
    """The device-resident epoch consumes the online set (its materialised
    tiles, never the one-time upload) and the loss falls."""
    online = _online(h5_root, remask_each_epoch=True)
    model = _model(dropout=0.0)
    trainer = ttrainer.Trainer(model, ttrainer.create_train_state(model, "adam", 1e-3),
                               tlosses.mse, online, online, tmp_path / "run", batch_size=32,
                               device_data=True, snapshot_slices=0, save_interval=1000,
                               device="cpu", log=lambda *_: None)
    l0 = trainer._epoch_loss(online, train=False, epoch=0)
    for e in range(3):
        trainer._epoch_loss(online, train=True, epoch=e)
    l1 = trainer._epoch_loss(online, train=False, epoch=3)
    assert trainer.scan_epoch is not None and not trainer._dev_tiles
    assert trainer.state.step == 3 * -(-len(online) // 32)
    assert l1 < l0


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "module"])
def test_online_scan_epochs_equal_the_host_loop(h5_root, tmp_path, use_pallas, monkeypatch):
    """Remask training with ``device_data`` (the materialised tiles, the
    epoch's plain loop) and without (host batches of the same tiles): the
    same losses and parameters, bit for bit. The fused host step draws the
    JAX mesh step's seeds (the axis index folded in), the epoch the scan
    epoch's, as the JAX package's two routes do; here the host step draws
    the epoch's, so the rest of the two routes is compared."""
    scan_seeds = ttrainer.epoch_seeds
    monkeypatch.setattr(ttrainer, "epoch_seeds",
                        lambda base, step0, n, rank=None: scan_seeds(base, step0, n))

    def run(device_data):
        train = _online(h5_root, remask_each_epoch=True)
        val = _online(h5_root, remask_each_epoch=False, num_samples=2)
        model = _model(dropout=0.1)
        t = ttrainer.Trainer(model, ttrainer.create_train_state(model, "adam", 1e-3),
                             tlosses.mse, train, val, tmp_path / f"run{device_data}",
                             batch_size=32, device_data=device_data, save_interval=1000,
                             use_pallas=use_pallas, sin5=True, device="cpu",
                             log=lambda *_: None)
        t.initial_errors()
        t.train(2)
        curve = list(t.initial_losses) + [r[k] for r in t._progress
                                          for k in ("train_loss", "val_loss")]
        return curve, torch.cat([p.detach().reshape(-1) for p in model.parameters()])

    (la, pa), (lb, pb) = run(True), run(False)
    assert la == lb and torch.equal(pa, pb)


# -------------------------------------------------------------------- CLIs
def _sets(*items):
    return [x for item in items for x in ("--set", item)]


def test_train_cli_online_yaml_two_epochs_then_a_resumed_third(h5_root, tmp_path, capsys):
    """configs/train_online.yaml on an .h5 directory: the train split online
    with remasking, the val split online with its masks fixed (asked for by
    the config, and also when it names no dataset), then a resumed third
    epoch."""
    out = tmp_path / "out"
    argv = ["--config", "configs/train_online.yaml", "--device", "cpu"] + _sets(
        f"data.train.dataset={h5_root}", f"data.val.dataset={h5_root}", *MODEL_SET,
        "training.batch_size=32", f"training.output_dir={out}")
    first = cli_train.main(argv + _sets("training.epochs=2"))
    assert isinstance(first.train_dataset, OnlineKspaceDataset) and first.train_dataset.remask
    assert isinstance(first.val_dataset, OnlineKspaceDataset) and not first.val_dataset.remask
    assert len(first.val_dataset) == 5 * 12  # the config's num_samples 5
    assert first.scan_epoch is not None  # device_data: true in the config
    steps = -(-len(first.train_dataset) // 32)
    assert first.state.step == 2 * steps
    again = cli_train.main(argv + _sets("training.epochs=3", "training.continue_training=true"))
    assert again.run_dir == first.run_dir and again.state.step == 3 * steps
    assert [r["epoch"] for r in again._progress] == [2]
    text = capsys.readouterr().out
    assert "continuing at epoch 2" in text
    assert (first.run_dir / "processed_files.txt").read_text().count("(online k-space)") == 9
    losses = [r["train_loss"] for r in first._progress + again._progress]
    assert np.isfinite(losses).all()

    # no val dataset named: the train split's .h5 directory, online, fixed masks
    bare = cli_train.main(["--config", "configs/train_online.yaml", "--device", "cpu"] + _sets(
        f"data.train.dataset={h5_root}", "data.val.dataset=", "data.val.online=false",
        *MODEL_SET, "training.batch_size=32", "training.epochs=1",
        f"training.output_dir={tmp_path / 'bare'}"))
    assert isinstance(bare.val_dataset, OnlineKspaceDataset) and not bare.val_dataset.remask


def test_train_cli_online_yaml_as_shipped(h5_root, tmp_path):
    """The config at its own width (H=256, L=5, batch 400) with only the
    paths and the epochs overridden: the initial errors of both online
    splits and the final checkpoint (no epoch: a train step at this width
    takes minutes on one CPU thread; the card runs its epochs)."""
    t = cli_train.main(["--config", "configs/train_online.yaml", "--device", "cpu"] + _sets(
        f"data.train.dataset={h5_root}", f"data.val.dataset={h5_root}", "training.epochs=0",
        f"training.output_dir={tmp_path}"))
    assert t.model.net.layers[0].weight.shape[0] == 256 and t.batch_size == 400
    assert t.train_dataset.remask and not t.val_dataset.remask
    assert np.isfinite(t.initial_losses).all()
    assert (t.run_dir / "checkpoints" / "step_00000000").is_dir()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("online_run")
    model = _model(seed=4)
    ckpt_lib.save_state(d, 5, ttrainer.create_train_state(model, "adam", 1e-4))
    return d


def _test_argv(dataset, run, out, name, *extra):
    return ["--config", "configs/test.yaml", "--device", "cpu"] + _sets(
        f"data.dataset={dataset}", f"data.model_path={run}", f"data.output_dir={out}",
        f"data.output_name={name}", "data.batch_patches=64", "data.visual_samples=0",
        *MODEL_SET, *extra)


@pytest.mark.parametrize("device_sweep", [True, False], ids=["device-sweep", "chunked"])
def test_test_cli_online_rows_equal_the_offline_rows(h5_root, metadata, run_dir, tmp_path,
                                                     device_sweep):
    sweep = f"data.device_sweep={str(device_sweep).lower()}"
    offline = cli_test.main(_test_argv(metadata, run_dir, tmp_path, "offline", sweep))
    online = cli_test.main(_test_argv(h5_root, run_dir, tmp_path, "online", sweep,
                                      "data.online=true"))
    assert len(online) == len(offline) == 9
    assert [r.slice_id for r in online] == [r.slice_id for r in offline]
    for a, b in zip(online, offline):
        np.testing.assert_allclose([a.psnr, a.ssim, a.nrmse], [b.psnr, b.ssim, b.nrmse],
                                   rtol=0, atol=1e-6)
    assert (tmp_path / "online" / "metrics_error.csv").is_file()


def test_test_cli_online_refuses_test_files(h5_root, run_dir, tmp_path):
    with pytest.raises(ValueError, match="test_files"):
        cli_test.main(_test_argv(h5_root, run_dir, tmp_path, "x", "data.online=true",
                                 "data.test_files=[file_brain_AXFLAIR_000000]"))
