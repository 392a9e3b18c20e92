"""The port's shard merge (``eval/evaluate.py:merge_shard_csvs``) reads the
``metrics_shardI_N`` directories in shard order I = 0 .. N-1, whatever N.

- Twelve ``--shard I:12`` runs of the test CLI on a tiny corpus (24 slices of
  64x64, H=32, L=2) merge into the rows of one unsharded run, in its order
  (equal: the CSV keeps full precision). Name order would put shard 10 and
  11 after shard 1.
- Stale ``metrics_shard*_2`` directories beside the ``_12`` ones, a missing
  shard, a shard index beyond N and a directory not named by ``--shard``
  raise ``ValueError`` naming the directories.
- For N up to 10 (where name order and shard order agree) the merged rows
  equal what the JAX package's ``merge_shard_csvs`` reads from the same
  directories.
"""

import numpy as np
import pytest
import torch

from mri_inr_tpu.eval import evaluate as jev
from mri_inr_tpu_torch.cli import test as cli_test
from mri_inr_tpu_torch.cli import train as cli_train
from mri_inr_tpu_torch.data import preprocessing, synthetic
from mri_inr_tpu_torch.eval import evaluate as tev

torch.set_num_threads(1)

MODEL_SET = ["model.dim_hidden=32", "model.latent_dim=16", "model.num_layers=2"]
SHARDS = 12


def _sets(*items):
    return [x for item in items for x in ("--set", item)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four 6-slice 64x64 phantom volumes through the port's preprocessing."""
    d = tmp_path_factory.mktemp("shard_corpus")
    rows = []
    for v in range(4):
        k = synthetic.synthetic_kspace(v, 6, 64, 64, texture=0.2)
        rows += preprocessing.process_kspace_volume(k, synthetic.synthetic_stem(v),
                                                    d / "processed", device="cpu")
    return preprocessing.write_metadata(rows, d / "processed")


@pytest.fixture(scope="module")
def run_dir(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("shard_train")
    return cli_train.main(["--config", "configs/train.yaml", "--device", "cpu"] + _sets(
        f"data.train.dataset={corpus}", f"data.val.dataset={corpus}", *MODEL_SET,
        "training.epochs=1", "training.batch_size=64", "training.save_interval=100",
        f"training.output_dir={out}", "training.output_name=tiny")).run_dir


def _argv(corpus, run_dir, out, name, *extra):
    return ["--config", "configs/test.yaml", "--device", "cpu", *extra] + _sets(
        f"data.dataset={corpus}", f"data.model_path={run_dir}", f"data.output_dir={out}",
        f"data.output_name={name}", "data.visual_samples=0", "data.batch_patches=64",
        *MODEL_SET)


def _rows(n):
    return [tev.SliceResult(f"slice_{i:03d}", 20.0 + i / 3, 0.5 + i / 97, 0.1 / (i + 1))
            for i in range(n)]


def _write_shards(rows, directory, n, indices=None):
    for i in range(n) if indices is None else indices:
        tev.write_metrics_artifacts(rows[i::n], directory / f"metrics_shard{i}_{n}")


def test_twelve_cli_shards_merge_in_shard_order(corpus, run_dir, tmp_path):
    whole = cli_test.main(_argv(corpus, run_dir, tmp_path, "whole"))
    assert len(whole) == 24
    parts = [cli_test.main(_argv(corpus, run_dir, tmp_path, "parts", "--shard", f"{i}:{SHARDS}"))
             for i in range(SHARDS)]
    assert [len(p) for p in parts] == [2] * SHARDS
    merged = cli_test.main(_argv(corpus, run_dir, tmp_path, "parts", "--merge-shards"))
    assert merged == [r for p in parts for r in p]
    # the sampler's shard i:N holds its slices i, i + N, ...: shard order
    # interleaves back into the one-process order
    assert sorted(merged, key=lambda r: [r.slice_id for r in whole].index(r.slice_id)) == whole
    assert tev.read_metrics_csv(tmp_path / "parts" / "metrics_error.csv") == merged
    # name order would read 0, 1, 10, 11, 2, ...: the merge does not
    assert [r.slice_id for r in merged[4:6]] == [r.slice_id for r in parts[2]]


def test_merge_orders_by_shard_index_not_name(tmp_path):
    rows = _rows(30)
    _write_shards(rows, tmp_path, SHARDS)
    merged = tev.merge_shard_csvs(tmp_path)
    assert merged == [r for i in range(SHARDS) for r in rows[i::SHARDS]]


def test_stale_shards_of_another_count_raise(tmp_path):
    rows = _rows(24)
    _write_shards(rows, tmp_path, SHARDS)
    _write_shards(rows, tmp_path, 2)
    with pytest.raises(ValueError, match=r"\[2, 12\] shards.*metrics_shard0_2"):
        tev.merge_shard_csvs(tmp_path)


@pytest.mark.parametrize("indices, match", [
    ([i for i in range(SHARDS) if i != 7], r"missing \[7\]"),
    ([*range(SHARDS), 12], r"out of range \[12\]"),
])
def test_missing_or_extra_shard_raises(tmp_path, indices, match):
    rows = _rows(26)
    for i in indices:
        tev.write_metrics_artifacts(rows[i::13], tmp_path / f"metrics_shard{i}_{SHARDS}")
    with pytest.raises(ValueError, match=match + r".*metrics_shard"):
        tev.merge_shard_csvs(tmp_path)


def test_unnamed_shard_directory_raises(tmp_path):
    tev.write_metrics_artifacts(_rows(3), tmp_path / "metrics_shard_old")
    with pytest.raises(ValueError, match="metrics_shard_old"):
        tev.merge_shard_csvs(tmp_path)
    with pytest.raises(FileNotFoundError):
        tev.merge_shard_csvs(tmp_path / "empty")


@pytest.mark.parametrize("n", [1, 2, 7, 10])
def test_merge_matches_jax_for_ten_shards_or_fewer(tmp_path, n):
    rows = _rows(23)
    _write_shards(rows, tmp_path, n)
    got = tev.merge_shard_csvs(tmp_path)
    want = jev.merge_shard_csvs(tmp_path)
    assert [r.slice_id for r in got] == [r.slice_id for r in want]
    np.testing.assert_array_equal([[r.psnr, r.ssim, r.nrmse] for r in got],
                                  [[r.psnr, r.ssim, r.nrmse] for r in want])
