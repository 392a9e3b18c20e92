"""The port's quality run (``python -m mri_inr_tpu_torch.cli.quality_run``)
at a tiny size on the CPU: phantom splits built without ``h5py``, a conv
autoencoder for 2 epochs, its encoder spliced into a SIREN trained for 2
epochs, the sweep over the eval split; ``run_info.json`` and the metric
summary written; a split reused only while every slice it lists exists."""

import argparse
import json
import pathlib

import numpy as np
import torch

from mri_inr_tpu_torch.cli import quality_run
from mri_inr_tpu_torch.data import dataset as tds

torch.set_num_threads(1)


def test_quality_run_at_a_tiny_size(tmp_path, capsys):
    root = tmp_path / "quality"
    info = quality_run.main([
        "--root", str(root), "--epochs", "2", "--ae-epochs", "2",
        "--train-files", "2", "--val-files", "1", "--eval-files", "1", "--slices", "2",
        "--size", "64", "--device", "cpu",
        "--set", "model.dim_hidden=32", "--set", "model.latent_dim=16",
        "--set", "model.num_layers=2", "--set", "training.batch_size=32"])
    assert json.loads((root / "run_info.json").read_text()) == json.loads(json.dumps(info))
    assert info["slices"] == 2 and info["epochs"] == 2 and info["device"] == "cpu"
    assert set(info["stage_seconds"]) == {"data", "autoencoder", "train", "eval"}
    assert np.isfinite(info["metrics"]["PSNR"]["mean"])
    summary = (root / "eval" / "quality" / "metrics_summary.txt").read_text()
    assert summary.startswith("PSNR: mean=")
    assert (root / "encoder" / "conv_autoencoder_epoch_00001.pt").is_file()
    # three samples: the sampler wraps around the two eval slices
    assert (root / "encoder" / "ae_metrics.csv").read_text().count("\n") == 4
    run_dir = root.parent.joinpath(info["run_dir"])  # absolute outside the working directory
    assert (run_dir / "progress_log.csv").read_text().count("\n") == 3
    rows = tds.read_metadata(root / "data" / "eval" / "processed" / "metadata.csv")
    assert [r["stem"] for r in rows] == ["file_brain_AXFLAIR_002000"] * 2
    out = capsys.readouterr().out
    assert "loaded pretrained custom encoder" in out
    # a second call reuses the splits and the autoencoder
    again = quality_run.main([
        "--root", str(root), "--epochs", "1", "--ae-epochs", "2", "--train-files", "2",
        "--val-files", "1", "--eval-files", "1", "--slices", "2", "--size", "64",
        "--device", "cpu", "--set", "model.dim_hidden=32", "--set", "model.latent_dim=16",
        "--set", "model.num_layers=2", "--set", "training.batch_size=32"])
    assert "dataset:" not in capsys.readouterr().out  # no autoencoder training this time
    assert again["slices"] == 2


def test_a_split_is_reused_only_with_every_slice_it_lists(tmp_path):
    """A ``metadata.csv`` copied without its slices (a results directory
    brought back from another machine) makes the split be built again."""
    args = argparse.Namespace(slices=2, size=64, phase=False, snr_db=None, texture=0.0)
    meta = quality_run.make_split(tmp_path, 1, 0, args, torch.device("cpu"))
    stamp = meta.stat().st_mtime_ns
    assert quality_run.make_split(tmp_path, 1, 0, args, torch.device("cpu")) == meta
    assert meta.stat().st_mtime_ns == stamp
    rows = tds.read_metadata(meta)
    pathlib.Path(rows[1]["path_undersampled_0.1_6"]).unlink()
    quality_run.make_split(tmp_path, 1, 0, args, torch.device("cpu"))
    assert meta.stat().st_mtime_ns != stamp
    assert all(pathlib.Path(r[c]).is_file() for r in tds.read_metadata(meta)
               for c in r if c.startswith("path_"))
