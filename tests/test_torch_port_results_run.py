"""The port's results runner (``python -m mri_inr_tpu_torch.cli.results_run``)
on the CPU at a tiny size: H=32, latent 16, L=2, 64x64 phantom slices, 2 / 1
/ 1 volumes x 2 slices, one epoch a row and one autoencoder epoch.

- Every row runs and lands in ``rows.json`` (and its own
  ``run_info.json``) with finite means: a VGG trunk spliced, trained, or
  frozen (the trunk after training equals the autoencoder's, or the seeded
  init for the random control; the frozen rows also on the module path),
  the perceptual autoencoder's file as the criterion's encoder, the
  acceleration rows on splits with four mask columns, the online row on the
  in-memory k-space with its masks redrawn.
- A second call skips every row and leaves ``rows.json`` as it was.
- An unknown row and a row that raises make the process exit nonzero,
  naming both; the other rows still run and are kept.
- ``--render`` writes ``TABLE.md`` against the committed JAX rows: each bar
  passes or fails on a fixture ``rows.json`` as its deltas say, and the
  orderings of ``RESULTS.md:41-48`` are read.
- Held against the offline route, which the parity tests hold against JAX:
  the online train split with remasking off gives the offline split's tiles
  (2e-6, the JAX package's online/offline bar) and the same first-epoch train
  loss within 1e-6.
"""

import argparse
import json
import pathlib

import numpy as np
import pytest
import torch
import yaml

from mri_inr_tpu_torch.cli import quality_run as qr
from mri_inr_tpu_torch.cli import results_run as rr
from mri_inr_tpu_torch.cli import train as cli_train
from mri_inr_tpu_torch.configuration import config as config_lib
from mri_inr_tpu_torch.data import dataset as tds
from mri_inr_tpu_torch.train import checkpoint as ckpt_lib

torch.set_num_threads(1)

TINY = ["--epochs", "1", "--ae-epochs", "1", "--train-files", "2", "--val-files", "1",
        "--eval-files", "1", "--slices", "2", "--size", "64", "--device", "cpu",
        "--set", "model.dim_hidden=32", "--set", "model.latent_dim=16",
        "--set", "model.num_layers=2", "--set", "training.batch_size=32"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("results") / "rows"
    rr.main(["--root", str(root), *TINY])
    return root


def _rows(root):
    return {r["row"]: r for r in json.loads((root / "rows.json").read_text())}


def _final_model(run_dir):
    run_dir = pathlib.Path(run_dir)
    step = ckpt_lib.find_latest_step(run_dir)
    return torch.load(ckpt_lib.checkpoint_path(run_dir, step) / ckpt_lib.STATE_FILE,
                      weights_only=True)["model"]


def _trunk(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def _losses(record):
    """The train and validation losses of a row's run, epoch by epoch (its
    ``progress_log.csv`` without the timing columns)."""
    lines = (pathlib.Path(record["run_dir"]) / "progress_log.csv").read_text().splitlines()
    head = lines[0].split(",")
    cols = [head.index("train_loss"), head.index("val_loss")]
    return [[float(ln.split(",")[c]) for c in cols] for ln in lines[1:]]


def test_every_row_lands_in_rows_json(root):
    rows = _rows(root)
    assert list(rows) == list(rr.ROWS)
    for name, r in rows.items():
        assert r["slices"] == 2 and r["device"] == "cpu", name
        for m in ("PSNR", "SSIM", "NRMSE"):
            assert all(np.isfinite(r[m][k]) for k in ("mean", "std", "min", "max")), name
        assert set(r["stage_seconds"]) == {"data", "autoencoder", "train", "eval"}, name
        assert json.loads((root / name / "run_info.json").read_text()) == r
        assert (root / name / "eval" / "metrics_summary.txt").read_text().startswith("PSNR")
        assert r["jax_row"] == rr.ROWS[name].jax
    assert rows["baseline"]["jax_row"] == "train_sin5"
    assert rows["train_sin5"]["jax_row"] == "baseline"
    assert "training.sin5=false" in rows["train_sin5"]["train_overrides"]
    assert (root / "encoder" / "ae_metrics.csv").is_file()


def test_vgg_rows_splice_train_and_freeze_the_trunk(root):
    rows = _rows(root)
    ae = _trunk(torch.load(root / "encoder_vgg" / "vgg_autoencoder_epoch_00000.pt",
                           weights_only=True), "trunk.")
    prefix = "encoder.encoder.trunk."
    frozen = _trunk(_final_model(rows["vgg_frozen_corpus"]["run_dir"]), prefix)
    trained = _trunk(_final_model(rows["vgg"]["run_dir"]), prefix)
    assert frozen.keys() == ae.keys() == trained.keys()
    assert all(torch.equal(frozen[k], ae[k]) for k in ae)
    assert not all(torch.equal(trained[k], ae[k]) for k in ae)
    # the random control: frozen at the seeded init, with no autoencoder file
    assert "autoencoder" not in rows["vgg_frozen_rand"]
    cfg = config_lib.load_train_configuration(None, [
        "model.encoder_type=vgg", "model.dim_hidden=32", "model.latent_dim=16",
        "model.num_layers=2"])
    init = _trunk(cli_train.build_model(cfg, torch.device("cpu"), log=lambda *_: None)
                  .state_dict(), prefix)
    rand = _trunk(_final_model(rows["vgg_frozen_rand"]["run_dir"]), prefix)
    assert all(torch.equal(rand[k], init[k]) for k in init)
    for name in ("vgg", "vgg_frozen_corpus", "vgg_frozen_rand"):
        feats = rows[name]["trunk_features"]
        assert feats["tiles"] == 64 and np.isfinite(feats["mean"]), name
    assert rows["vgg"]["autoencoder"].endswith("encoder_vgg/vgg_autoencoder_epoch_00000.pt")


def test_frozen_vgg_module_row_trains_on_the_module_path(root):
    """``vgg_frozen_rand_module``: the JAX row's recorded route (the plain
    modules, ``training.use_pallas=false``), the trunk frozen at the seeded
    init as in ``vgg_frozen_rand``, paired with the JAX ``vgg_frozen_rand``;
    the same seed and init as the fused control, other losses."""
    rows = _rows(root)
    r, fused = rows["vgg_frozen_rand_module"], rows["vgg_frozen_rand"]
    assert r["jax_row"] == "vgg_frozen_rand" and "autoencoder" not in r
    assert rr.route(r["train_overrides"]) == "module"
    assert rr.route(fused["train_overrides"]) == "fused"
    cfg = yaml.safe_load((pathlib.Path(r["run_dir"]) / "config.yaml").read_text())
    assert cfg["training"]["use_pallas"] is False and cfg["training"]["freeze_encoder"]
    prefix = "encoder.encoder.trunk."
    module, control = (_trunk(_final_model(x["run_dir"]), prefix) for x in (r, fused))
    assert module.keys() == control.keys()
    assert all(torch.equal(module[k], control[k]) for k in module)
    assert r["trunk_features"] == fused["trunk_features"]
    assert _losses(r) != _losses(fused)


def test_frozen_vgg_corpus_module_row_trains_on_the_module_path(root):
    """``vgg_frozen_corpus_module``: the corpus-pretrained trunk (the same
    VGG autoencoder file as ``vgg_frozen_corpus``) frozen, trained on the
    module path (``training.use_pallas=false``, the JAX row's recorded
    route), paired with the JAX ``vgg_frozen_corpus``; no train kernel
    launched; the same trunk and features as the fused row, other losses."""
    rows = _rows(root)
    r, fused = rows["vgg_frozen_corpus_module"], rows["vgg_frozen_corpus"]
    assert r["jax_row"] == "vgg_frozen_corpus" and r["autoencoder"] == fused["autoencoder"]
    assert rr.route(r["train_overrides"]) == "module"
    assert rr.route(fused["train_overrides"]) == "fused"
    assert r["launches"]["siren_train_fwd"] == r["launches"]["siren_train_bwd"] == 0
    cfg = yaml.safe_load((pathlib.Path(r["run_dir"]) / "config.yaml").read_text())
    assert cfg["training"]["use_pallas"] is False and cfg["training"]["freeze_encoder"]
    assert cfg["model"]["encoder_path"].endswith(r["autoencoder"])
    prefix = "encoder.encoder.trunk."
    ae = _trunk(torch.load(root / "encoder_vgg" / "vgg_autoencoder_epoch_00000.pt",
                           weights_only=True), "trunk.")
    module = _trunk(_final_model(r["run_dir"]), prefix)
    assert module.keys() == ae.keys() and all(torch.equal(module[k], ae[k]) for k in ae)
    assert r["trunk_features"] == fused["trunk_features"]
    assert _losses(r) != _losses(fused)


def test_perceptual_and_acceleration_rows(root):
    rows = _rows(root)
    perc = rows["perceptual"]
    assert perc["perceptual_autoencoder"].endswith(
        "encoder_perceptual/perceptual_autoencoder_epoch_00000.pt")
    cfg = yaml.safe_load((pathlib.Path(perc["run_dir"]) / "config.yaml").read_text())
    assert cfg["training"]["criterion"] == "perceptual"
    assert cfg["training"]["perceptual_encoder_path"].endswith(perc["perceptual_autoencoder"])
    for split in ("train", "val", "eval"):
        acc = tds.read_metadata(root / "data" / split / "processed_acc" / "metadata.csv")
        assert {tds.undersample_column(cf, a) for cf, a in rr.ACC_MASKS} <= set(acc[0])
        default = tds.read_metadata(root / "data" / split / "processed" / "metadata.csv")
        assert tds.undersample_column(0.2, 4) not in default[0]
    assert rows["acc_02_4"]["splits"] == rows["acc_005_8"]["splits"] == "processed_acc"
    assert rows["acc_01_6"]["splits"] == "processed"
    assert rows["acc_02_4"]["eval_overrides"][:2] == ["data.acceleration=4",
                                                      "data.center_fraction=0.2"]


def test_online_row_trains_on_in_memory_kspace(root):
    r = _rows(root)["online_remask"]
    run_dir = pathlib.Path(r["run_dir"])
    manifest = (run_dir / "processed_files.txt").read_text().splitlines()
    assert len(manifest) == 4 and all(m.endswith("(online k-space)") for m in manifest)
    cfg = yaml.safe_load((run_dir / "config.yaml").read_text())
    assert cfg["data"]["train"]["online"] and cfg["data"]["train"]["remask_each_epoch"]


def test_second_call_skips_every_row(root, capsys):
    before = (root / "rows.json").read_bytes()
    dirs = sorted(p.name for p in root.glob("*/*_20*"))
    capsys.readouterr()
    rr.main(["--root", str(root), *TINY])
    out = capsys.readouterr().out
    assert out.count("skipped") == len(rr.ROWS)
    assert "epoch" not in out
    assert (root / "rows.json").read_bytes() == before
    assert sorted(p.name for p in root.glob("*/*_20*")) == dirs


def test_unknown_or_failing_row_exits_nonzero_and_keeps_the_others(tmp_path, monkeypatch,
                                                                   capsys):
    monkeypatch.setitem(rr.ROWS, "broken", rr.Row("edge", ("training.criterion=bogus",)))
    with pytest.raises(SystemExit) as exc:
        rr.main(["--root", str(tmp_path), "--rows", "nosuch,broken,edge", *TINY])
    assert exc.value.code == "results_run: rows failed: nosuch, broken"
    out, err = capsys.readouterr()
    assert "row nosuch: unknown" in out and "row broken FAILED" in out
    assert "bogus" in err  # the traceback is printed, not swallowed
    assert list(_rows(tmp_path)) == ["edge"]


def _fixture_row(name, jax_row, psnr, ssim, nrmse):
    stats = lambda v: {"mean": v, "std": 0.0, "min": v, "max": v}
    return {"row": name, "jax_row": jax_row, "slices": 48, "device": "fixture card",
            "stage_seconds": {"data": 0.0, "autoencoder": 0.0, "train": 1.0, "eval": 0.0},
            "PSNR": stats(psnr), "SSIM": stats(ssim), "NRMSE": stats(nrmse)}


def test_render_reads_each_bar_and_ordering(tmp_path):
    rows = [
        _fixture_row("baseline", "train_sin5", 28.404 + 0.29, 0.8712 - 0.009, 0.1243 + 0.009),
        _fixture_row("edge", "edge", 28.5326 - 0.31, 0.8681, 0.1224),
        _fixture_row("residual", "residual", 28.5242, 0.8700 + 0.011, 0.1232),
        _fixture_row("perceptual", "perceptual", 28.2469, 0.8374, 0.1327 - 0.011),
        _fixture_row("acc_005_8", "acc_005_8", 28.0296, 0.8643, 0.1301),
        _fixture_row("acc_01_6", "acc_01_6", 31.8464, 0.9256, 0.0826),
        _fixture_row("acc_02_4", "acc_02_4", 33.6282, 0.9469, 0.0674),
        _fixture_row("online_remask", "online_remask", 28.6, 0.877, 0.121),
    ]
    (tmp_path / "rows.json").write_text(json.dumps(rows))
    rr.main(["--root", str(tmp_path), "--rows", ",".join(r["row"] for r in rows),
             "--render"])
    table = (tmp_path / "TABLE.md").read_text().splitlines()
    line = {ln.split("|")[1].strip(): ln for ln in table if ln.startswith("| ")}
    assert "| PSNR yes, SSIM yes, NRMSE yes |" in line["baseline"]
    assert "28.4040 | +0.2900 |" in line["baseline"]
    assert "| PSNR NO, SSIM yes, NRMSE yes |" in line["edge"]
    assert "| PSNR yes, SSIM NO, NRMSE yes |" in line["residual"]
    assert "| PSNR yes, SSIM yes, NRMSE NO |" in line["perceptual"]
    start = table.index("## Orderings (`RESULTS.md:41-48`)")
    holds = {ln.split("|")[1].strip(): ln.split("|")[3].strip() for ln in table[start + 4:]
             if ln.startswith("| ")}
    assert holds["edge >= baseline (PSNR)"] == "no"  # 28.2226 against 28.694
    assert holds["residual ~= baseline (PSNR within 0.3 dB)"] == "yes"  # -0.1698 dB
    assert holds["perceptual has the worst SSIM of the ablations"] == "yes"
    assert ("baseline 0.8622, edge 0.8681, residual 0.8810, perceptual 0.8374"
            in "\n".join(table[start:]))
    assert holds["acc8/.05 < acc6/.05 < acc6/.10 < acc4/.20 (PSNR)"] == "yes"
    assert holds["online remask >= baseline (PSNR)"] == "no"  # -0.094 dB
    assert "fixture card" in table[2]


def test_online_route_without_remask_matches_the_offline_split(tmp_path):
    args = argparse.Namespace(
        overrides=TINY[-8:][1::2], train_files=2, slices=2, size=64, phase=False, snr_db=None,
        texture=0.0, val_files=1, eval_files=1, ae_epochs=1)
    proto = rr.Protocol(args, tmp_path, torch.device("cpu"))
    meta = proto.splits("processed")
    sets = qr.train_sets(meta, tmp_path / "out", "x", 1, *args.overrides)
    cfg = config_lib.load_train_configuration(None, sets)
    online = proto.online_train_set(cfg, remask=False)
    offline = cli_train._dataset(cfg.data.train, cfg.data, cfg.model)
    fully, under = online.materialize(0)
    np.testing.assert_allclose(fully.numpy(), offline.fully_tiles, rtol=0, atol=2e-6)
    np.testing.assert_allclose(under.numpy(), offline.under_tiles, rtol=0, atol=2e-6)
    dev = ["--device", "cpu"]
    val = cli_train._dataset(cfg.data.val, cfg.data, cfg.model)
    on = qr.train_stage(meta, tmp_path / "on", "on", 1, dev, *args.overrides,
                        datasets=(online, val))
    off = qr.train_stage(meta, tmp_path / "off", "off", 1, dev, *args.overrides)
    assert on.initial_losses[0] == pytest.approx(off.initial_losses[0], abs=1e-6)
    assert on._progress[0]["train_loss"] == pytest.approx(off._progress[0]["train_loss"],
                                                          abs=1e-6)


# ------------------------------------------------------------------ seeds
def test_seed_zero_leaves_row_names_and_overrides(root):
    """``--seed 0``, the default, is the rows as they were: each keeps its
    name, its JAX row and its overrides, with no seed of its own."""
    for name, r in _rows(root).items():
        assert rr.row_key(name, 0) == name and rr.jax_pair(name, 0) == rr.ROWS[name].jax
        assert "seed" not in r and "base_row" not in r, name
        assert not any(o.startswith("training.seed") for o in r["train_overrides"]), name


def test_seed_rows_are_named_paired_and_seeded(root):
    """``--seed 1``: rows ``<row>@seed1`` beside the seed-0 rows, which stay
    as they were; ``training.seed=1`` reaches the run, the VGG autoencoder is
    pretrained from seed 1 into its own directory, the conv one is shared;
    the baseline and online rows pair with the JAX seed-1 runs."""
    before = _rows(root)
    rr.main(["--root", str(root), "--seed", "1", "--rows",
             "baseline,online_remask,vgg_frozen_corpus", *TINY])
    rows = _rows(root)
    assert {k: rows[k] for k in before} == before
    assert set(rows) - set(before) == {"baseline@seed1", "online_remask@seed1",
                                       "vgg_frozen_corpus@seed1"}
    pairs = {"baseline": "seed1_offline", "online_remask": "seed1_online",
             "vgg_frozen_corpus": "vgg_frozen_corpus"}
    for name, jax_row in pairs.items():
        r = rows[f"{name}@seed1"]
        assert (r["base_row"], r["seed"], r["jax_row"]) == (name, 1, jax_row)
        assert "training.seed=1" in r["train_overrides"]
        run_dir = pathlib.Path(r["run_dir"])
        assert run_dir.parent == root / f"{name}@seed1"
        assert yaml.safe_load((run_dir / "config.yaml").read_text())["training"]["seed"] == 1
        assert json.loads((root / f"{name}@seed1" / "run_info.json").read_text()) == r
    assert rows["baseline@seed1"]["autoencoder"] == before["baseline"]["autoencoder"]
    seeded = rows["vgg_frozen_corpus@seed1"]["autoencoder"]
    assert seeded.endswith("encoder_vgg_seed1/vgg_autoencoder_epoch_00000.pt")
    trunk = lambda p: _trunk(torch.load(p, weights_only=True), "trunk.")
    a, b = trunk(seeded), trunk(before["vgg_frozen_corpus"]["autoencoder"])
    assert a.keys() == b.keys() and not all(torch.equal(a[k], b[k]) for k in a)
    # the seed reached the init: the first losses differ from seed 0's
    assert _losses(rows["baseline@seed1"]) != _losses(before["baseline"])


def test_jax_rows_hold_the_seed_repeats():
    jax = rr.jax_rows(rr.JAX_ROWS, rr.JAX_BASELINE)
    assert jax["seed1_offline"]["PSNR"]["mean"] == 28.3921
    assert jax["seed1_online"]["SSIM"]["mean"] == 0.8766
    assert set(rr.JAX_SEED_RUNS.values()) <= set(jax)


def test_render_reads_the_seed_section(tmp_path):
    """The seed section: each row's value per seed, mean and range beside
    every JAX run it pairs with, and the reading of ROADMAP's rule (the JAX
    PSNR inside the port's range; seeds inside the bar on all three)."""
    rows = [_fixture_row("residual", "residual", 23.78, 0.28, 0.25),
            _fixture_row("residual@seed1", "residual", 28.40, 0.869, 0.124),
            _fixture_row("residual@seed2", "residual", 27.00, 0.80, 0.15),
            _fixture_row("residual@seed3", "residual", float("nan"), float("nan"),
                         float("nan")),
            _fixture_row("baseline", "train_sin5", 28.32, 0.8686, 0.1252),
            _fixture_row("baseline@seed1", "seed1_offline", 28.50, 0.8700, 0.1230),
            _fixture_row("edge", "edge", 28.44, 0.868, 0.1232)]
    for r, (base, seed) in zip(rows, [("residual", 0), ("residual", 1), ("residual", 2),
                                      ("residual", 3), ("baseline", 0), ("baseline", 1),
                                      ("edge", 0)]):
        if seed:
            r.update(base_row=base, seed=seed)
    (tmp_path / "rows.json").write_text(json.dumps(rows))
    rr.main(["--root", str(tmp_path), "--rows", "residual,baseline,edge", "--render"])
    table = (tmp_path / "TABLE.md").read_text()
    section = table[table.index("## Seeds"):table.index("## Notes") if "## Notes" in table
                    else None]
    # a diverged seed (NaN) stays in the row, apart from the range
    assert ("| residual | PSNR | 0: 23.7800, 1: 28.4000, 2: 27.0000, 3: nan | nan | "
            "23.7800 - 28.4000 (1 not finite) | residual 28.5242 |") in section
    assert "| baseline | PSNR | 0: 28.3200, 1: 28.5000 | 28.4100 | 28.3200 - 28.5000 | " \
           "train_sin5 28.4040; seed1_offline 28.3921 |" in section
    assert "| edge |" not in section  # one seed: no seed line
    assert ("- `residual` against `residual`: its PSNR 28.5242 does not lie inside the "
            "port's range; seeds inside the bar on all three means: 1") in section
    assert ("- `baseline` against `train_sin5`: its PSNR 28.4040 lies inside the port's "
            "range; seeds inside the bar on all three means: 0, 1") in section
