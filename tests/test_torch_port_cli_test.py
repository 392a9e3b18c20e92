"""The port's chunked sweep, shard merge and test CLI
(``python -m mri_inr_tpu_torch.cli.test``) on a tiny corpus the port itself
preprocessed (96x96 phantom slices, H=64, L=3, a 64-patch bucket).

- ``evaluate_files_chunked`` and ``evaluate_files_device`` give the rows of
  ``evaluate_files``, in its order (1e-6: the same per-slice computation,
  batched differently).
- ``--shard 0:2`` + ``--shard 1:2`` + ``--merge-shards`` on a checkpoint the
  train CLI wrote gives the rows of an unsharded run (equal: the CSV keeps
  full precision).
- ``data.quantized=true`` runs through the CLI; per slice its PSNR is within
  0.15 dB of the bf16 run's with ``data.sin5=false`` (measured: 0.077 dB on every sweep). The int8
  chain always evaluates degree-9 sines, so it is held to the bf16 chain with
  its more exact sine: against the degree-5 default the gap on this network
  (H=64, two epochs of training, PSNR near 16 dB) is 0.19 dB, and it is the
  degree-5 sine's, not the quantisation's.
- On weights transplanted from the JAX package the CLI's rows agree with the
  JAX package's ``evaluate_files`` (Pallas kernel in interpret mode) by
  ``slice_id`` within the bars of tests/test_torch_port_eval.py: PSNR 1e-3
  dB, SSIM and NRMSE 1e-5; with ``encoder_type=vgg`` too, on two slices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.data.dataset import MRISampler as JaxSampler
from mri_inr_tpu.eval import evaluate as jev
from mri_inr_tpu.models.modulated_siren import ModulatedSiren as JaxModel
from mri_inr_tpu.ops.siren_kernel import make_apply_fn as jax_make_apply_fn
from mri_inr_tpu_torch.cli import test as cli_test
from mri_inr_tpu_torch.cli import train as cli_train
from mri_inr_tpu_torch.data import preprocessing, synthetic
from mri_inr_tpu_torch.data.dataset import MRISampler
from mri_inr_tpu_torch.eval import evaluate as tev
from mri_inr_tpu_torch.interop import load_flax_params
from mri_inr_tpu_torch.models.modulated_siren import ModulatedSiren
from mri_inr_tpu_torch.ops.siren_kernel import make_apply_fn
from mri_inr_tpu_torch.train import checkpoint as ckpt_lib
from mri_inr_tpu_torch.train.trainer import create_train_state

torch.set_num_threads(1)

WIDTHS = dict(dim_hidden=64, latent_dim=32, num_layers=3)
MODEL_SET = [f"model.{k}={v}" for k, v in WIDTHS.items()]


def _sets(*items):
    return [x for item in items for x in ("--set", item)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three 3-slice volumes (one 80 wide: a second shape group) through the
    port's own preprocessing on the CPU."""
    d = tmp_path_factory.mktemp("port_cli")
    rows = []
    for v, width in enumerate((96, 96, 80)):
        k = synthetic.synthetic_kspace(v, 3, 96, width, texture=0.2)
        rows += preprocessing.process_kspace_volume(
            k, synthetic.synthetic_stem(v), d / "processed", device="cpu")
    return preprocessing.write_metadata(rows, d / "processed")


@pytest.fixture(scope="module")
def run_dir(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("port_cli_train")
    trainer = cli_train.main(
        ["--config", "configs/train.yaml", "--device", "cpu"] + _sets(
            f"data.train.dataset={corpus}", f"data.val.dataset={corpus}", *MODEL_SET,
            "training.epochs=2", "training.batch_size=32", "training.save_interval=100",
            f"training.output_dir={out}", "training.output_name=tiny"))
    return trainer.run_dir


def _argv(corpus, model_path, out, name, *extra):
    return ["--config", "configs/test.yaml", "--device", "cpu"] + _sets(
        f"data.dataset={corpus}", f"data.model_path={model_path}",
        f"data.output_dir={out}", f"data.output_name={name}", "data.batch_patches=64",
        "data.visual_samples=0", *MODEL_SET, *extra)


def _by_id(results):
    return {r.slice_id: (r.psnr, r.ssim, r.nrmse) for r in results}


@pytest.fixture(scope="module")
def reconstructor():
    model = ModulatedSiren(**WIDTHS, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    return tev.SliceReconstructor(make_apply_fn(model, device="cpu", sin5=True),
                                  patch_bucket=64, device="cpu")


@pytest.mark.parametrize("chunk,inflight,num", [(4, 4, None), (2, 1, None), (16, 2, 5)])
def test_chunked_sweep_matches_per_slice(corpus, reconstructor, chunk, inflight, num):
    want = tev.evaluate_files(reconstructor, MRISampler(corpus), num_samples=num,
                              progress_every=0)
    logs = []
    got = tev.evaluate_files_chunked(reconstructor, MRISampler(corpus), num_samples=num,
                                     chunk=chunk, inflight=inflight, progress_every=4,
                                     log=logs.append)
    assert [r.slice_id for r in got] == [r.slice_id for r in want]
    assert len(got) == (num or 9)
    for g, w in zip(got, want):
        np.testing.assert_allclose([g.psnr, g.ssim, g.nrmse], [w.psnr, w.ssim, w.nrmse],
                                   rtol=0, atol=1e-6)
    assert logs and logs[0].startswith("evaluated")


def test_device_sweep_rows_come_in_sampler_order(corpus, reconstructor):
    """The corpus's sampler interleaves its two image shapes; the device
    sweep stages and scores them per shape group, yet returns the rows of
    ``evaluate_files`` position by position."""
    sampler = MRISampler(corpus)
    widths = [sampler.next_sample().fully_sampled.shape[1] for _ in range(len(sampler))]
    groups = [w for i, w in enumerate(widths) if i == 0 or w != widths[i - 1]]
    assert len(groups) > len(set(widths)), f"shapes not interleaved: {widths}"
    want = tev.evaluate_files(reconstructor, MRISampler(corpus), progress_every=0)
    got, _ = tev.evaluate_files_device(reconstructor, MRISampler(corpus), log=lambda *_: None)
    assert [r.slice_id for r in got] == [r.slice_id for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([g.psnr, g.ssim, g.nrmse], [w.psnr, w.ssim, w.nrmse],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("piece", [None, 77], ids=["one-piece", "77-patch-pieces"])
def test_device_sweep_in_pieces_keeps_the_rows_and_their_order(corpus, monkeypatch,
                                                               quantized, piece):
    """Two shape groups (six 96 x 96 slices of 36 patches; three 96 x 80 of
    30), each scored batched, whole or in pieces of at most 77 patches (two
    slices of either shape: the three-slice group ends in a piece of one):
    the rows of the per-slice ``evaluate_files`` within 1e-6, in the
    sampler's order, with one forward a piece."""
    model = ModulatedSiren(**WIDTHS, device="cpu", generator=torch.Generator().manual_seed(0))
    rec = tev.SliceReconstructor(make_apply_fn(model, device="cpu", sin5=True,
                                               quantized=quantized),
                                 patch_bucket=64, device="cpu")
    want = tev.evaluate_files(rec, MRISampler(corpus), progress_every=0)
    if piece is not None:
        monkeypatch.setattr(tev, "PIECE_PATCHES", piece)
    calls = []
    apply_fn = rec.apply_fn
    rec.apply_fn = lambda tiles: calls.append(tiles.shape[0]) or apply_fn(tiles)
    got, _ = tev.evaluate_files_device(rec, MRISampler(corpus), log=lambda *_: None)
    assert [r.slice_id for r in got] == [r.slice_id for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([g.psnr, g.ssim, g.nrmse], [w.psnr, w.ssim, w.nrmse],
                                   rtol=0, atol=1e-6)
    sizes = sorted(calls)
    assert sizes == ([30 * 3, 36 * 6] if piece is None else [30, 30 * 2] + [36 * 2] * 3)


def test_metrics_chunk_matches_stack(corpus, reconstructor):
    pairs = [MRISampler(corpus, test_files=[synthetic.synthetic_stem(0)]).next_sample()
             for _ in range(2)]
    fully = np.stack([p.fully_sampled for p in pairs])
    under = np.stack([p.undersampled for p in pairs])
    psnr, ssim, nrmse = reconstructor.metrics_chunk(fully, under)
    want = reconstructor.metrics_stack(torch.from_numpy(fully), torch.from_numpy(under))
    np.testing.assert_array_equal(np.stack([psnr, ssim, nrmse]), want.numpy())


def test_gather_and_merge_of_shard_results(tmp_path):
    rows = [tev.SliceResult(f"s{i}", 20.0 + i, 0.5, 0.1 * i) for i in range(5)]
    assert tev.gather_shard_results(rows) == rows  # one process: identity
    tev.write_metrics_artifacts(rows[0::2], tmp_path / "metrics_shard0_2")
    tev.write_metrics_artifacts(rows[1::2], tmp_path / "metrics_shard1_2")
    merged = tev.merge_shard_csvs(tmp_path)
    assert merged == rows[0::2] + rows[1::2]
    with pytest.raises(FileNotFoundError):
        tev.merge_shard_csvs(tmp_path / "metrics_shard0_2")


def test_cli_sharded_and_merged_equals_unsharded(corpus, run_dir, tmp_path, capsys):
    whole = cli_test.main(_argv(corpus, run_dir, tmp_path, "whole"))
    assert "restored" in capsys.readouterr().out
    assert len(whole) == 9
    assert tev.read_metrics_csv(tmp_path / "whole" / "metrics_error.csv") == whole
    for name in ("metrics_summary.txt", "psnr_boxplot.png", "ssim_density.png"):
        assert (tmp_path / "whole" / name).is_file(), name
    parts = [cli_test.main(_argv(corpus, run_dir, tmp_path, "parts") + ["--shard", f"{i}:2"])
             for i in range(2)]
    assert [len(p) for p in parts] == [5, 4]
    assert (tmp_path / "parts" / "metrics_shard1_2" / "metrics_error.csv").is_file()
    assert not (tmp_path / "parts" / "metrics_error.csv").exists()
    merged = cli_test.main(_argv(corpus, run_dir, tmp_path, "parts") + ["--merge-shards"])
    assert _by_id(merged) == _by_id(whole)
    assert tev.read_metrics_csv(tmp_path / "parts" / "metrics_error.csv") == merged
    # a step directory restores like its run directory
    step_dir = ckpt_lib.checkpoint_path(run_dir, ckpt_lib.find_latest_step(run_dir))
    assert cli_test.main(_argv(corpus, step_dir, tmp_path, "step")) == whole


@pytest.mark.parametrize("sweep", ["data.device_sweep=true",
                                   "data.device_sweep=false", "data.eval_chunk=1"])
def test_cli_quantized_run_stays_near_the_bf16_run(corpus, run_dir, tmp_path, sweep):
    """Every sweep of the CLI (device, chunked, per slice) with the int8
    chain against the device sweep with the bf16 chain."""
    extra = [sweep] + (["data.device_sweep=false"] if "chunk" in sweep else [])
    bf16 = _by_id(cli_test.main(_argv(corpus, run_dir, tmp_path, "bf16", "data.sin5=false")))
    int8 = _by_id(cli_test.main(_argv(corpus, run_dir, tmp_path, "int8",
                                      "data.quantized=true", *extra)))
    assert set(int8) == set(bf16) and len(int8) == 9
    gaps = [abs(int8[k][0] - bf16[k][0]) for k in bf16]
    assert 0 < max(gaps) < 0.15
    assert all(np.isfinite(v).all() for v in int8.values())


def test_cli_visual_pass_writes_the_six_artifacts(corpus, run_dir, tmp_path):
    stem = synthetic.synthetic_stem(2)
    rows = cli_test.main(_argv(corpus, run_dir, tmp_path, "vis", "data.visual_samples=1",
                               f"data.test_files=[{stem}]", "data.metric_samples=2"))
    assert len(rows) == 2
    dirs = [p for p in (tmp_path / "vis").iterdir() if p.is_dir()]
    assert len(dirs) == 1 and dirs[0].name.startswith(stem)
    sid = dirs[0].name
    assert sorted(p.name for p in dirs[0].iterdir()) == sorted(
        [f"{sid}_{n}.png" for n in ("reconstructed", "undersampled", "fully_sampled",
                                    "difference", "comparison")] + [f"{sid}_error.txt"])
    assert (dirs[0] / f"{sid}_error.txt").read_text().startswith("psnr: ")


def test_cli_matches_jax_on_transplanted_weights(corpus, tmp_path):
    jm = JaxModel(dropout=0.0, **WIDTHS)
    params = jax.device_get(jax.jit(jm.init)(jax.random.key(3), jnp.zeros((2, 32, 32)))["params"])
    tm = ModulatedSiren(**WIDTHS, device="cpu")
    load_flax_params(tm, params)
    ckpt_lib.save_state(tmp_path / "run", 7, create_train_state(tm, "adam", 1e-4))
    got = cli_test.main(_argv(corpus, tmp_path / "run", tmp_path, "jax"))
    jrec = jev.SliceReconstructor(jax_make_apply_fn(jm, interpret=True, sin5=True),
                                  patch_bucket=64)
    want = jev.evaluate_files(jrec, params, JaxSampler(corpus), progress_every=0)
    got, want = _by_id(got), _by_id(want)
    assert set(got) == set(want) and len(got) == 9
    for sid, (p, s, n) in want.items():
        gp, gs, gn = got[sid]
        assert abs(gp - p) <= 1e-3, sid
        assert abs(gs - s) <= 1e-5, sid
        assert abs(gn - n) <= 1e-5, sid


def test_cli_refuses_what_is_not_ported(corpus, run_dir, tmp_path):
    """Item 17's options, once refused, run: ``data.halo_fold`` in one
    process folds whole slices (the rows equal the plain run's), and
    ``--devices`` other than the ranks started raises, naming the launch
    command. An Orbax directory (item 18) raises, naming the interop tool."""
    plain = cli_test.main(_argv(corpus, run_dir, tmp_path, "plain"))
    halo = cli_test.main(_argv(corpus, run_dir, tmp_path, "halo", "data.halo_fold=true"))
    assert halo == plain and len(plain) == 9
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        cli_test.main(_argv(corpus, run_dir, tmp_path, "no") + ["--devices", "4"])
    (tmp_path / "orbax_like").mkdir()
    with pytest.raises(NotImplementedError, match="torch_checkpoint_interop.py jax-to-torch"):
        cli_test.main(_argv(corpus, tmp_path / "orbax_like", tmp_path, "no"))


def test_cli_vgg_encoder_matches_jax_on_transplanted_weights(corpus, tmp_path):
    jm = JaxModel(dropout=0.0, encoder_type="vgg", **WIDTHS)
    params = jax.device_get(jax.jit(jm.init)(jax.random.key(4), jnp.zeros((2, 32, 32)))["params"])
    tm = ModulatedSiren(**WIDTHS, encoder_type="vgg", device="cpu")
    load_flax_params(tm, params)
    ckpt_lib.save_state(tmp_path / "run", 3, create_train_state(tm, "adam", 1e-4))
    got = cli_test.main(_argv(corpus, tmp_path / "run", tmp_path, "vgg", "model.encoder_type=vgg",
                              "data.metric_samples=2"))
    jrec = jev.SliceReconstructor(jax_make_apply_fn(jm, interpret=True, sin5=True),
                                  patch_bucket=64)
    want = jev.evaluate_files(jrec, params, JaxSampler(corpus, num_samples=2), progress_every=0)
    got, want = _by_id(got), _by_id(want)
    assert set(got) == set(want) and len(got) == 2
    for sid, (p, s, n) in want.items():
        gp, gs, gn = got[sid]
        assert abs(gp - p) <= 1e-3, sid
        assert abs(gs - s) <= 1e-5, sid
        assert abs(gn - n) <= 1e-5, sid
