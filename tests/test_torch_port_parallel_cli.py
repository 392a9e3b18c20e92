"""Both CLIs over ranks on the CPU: 2 gloo ranks started as processes
(``tests/torch_port_ranks.py``: a rendezvous on a free local port, a hard
timeout a launch; and ``torchrun``) against the port's
one-process runs. The train CLI's per-epoch losses within 1e-5 relative of
one process stepping on the ranks' halves of every batch (fp32; dropout
off) and within WHOLE_BATCH_BAR of one process on the whole batch, a bar
that a planted fault (every rank on rank 0's rows) exceeds; one run
directory written by rank 0 alone, the checkpoint restored on both ranks,
TensorBoard scalars of every epoch; the
test CLI's gathered rows exactly equal to the ``--shard`` /
``--merge-shards`` file and to the one-process rows.
"""

import csv
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_ranks as ranks
from mri_inr_tpu.data import synthetic as jsyn
from mri_inr_tpu.data.preprocessing import process_files
from mri_inr_tpu_torch.cli import test as cli_test
from mri_inr_tpu_torch.cli import train as cli_train
from mri_inr_tpu_torch.parallel import distributed
from mri_inr_tpu_torch.train import trainer as ttrainer
from mri_inr_tpu_torch.utils import tensorboard

# the test workers share the cores: one torch thread each (the ranks get
# OMP_NUM_THREADS=1: the plain chain's bf16 roundings move with the
# CPU's blocking, so equal rows need equal thread counts)
torch.set_num_threads(1)

MODEL_SETS = ["--set", "model.dim_hidden=32", "--set", "model.latent_dim=32",
              "--set", "model.num_layers=2"]
# the ranks' arithmetic (their two halves of every batch, summed in rank
# order) against one process on the whole batch, per-epoch losses relative
# over three epochs of Adam in fp32: measured 1.221e-5 at most for both
# values of training.device_data, and 5.2e-3 to 4.8e-2 an epoch where every
# rank steps on rank 0's rows (test_the_whole_batch_bar_sees_half_a_batch)
WHOLE_BATCH_BAR = 5e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    jsyn.write_synthetic_h5(d, num_files=2, num_slices=3, height=64, width=64)
    return process_files(d)


def _train_argv(corpus, out, *sets):
    argv = ["--device", "cpu", "--set", f"data.train.dataset={corpus}",
            "--set", f"data.val.dataset={corpus}", *MODEL_SETS,
            "--set", "training.batch_size=32", "--set", "training.save_interval=1",
            "--set", f"training.output_dir={out}", "--set", "training.output_name=dp"]
    for s in sets:
        argv += ["--set", s]
    return argv


def _progress(run_dir):
    with open(run_dir / "progress_log.csv", newline="") as f:
        return [(int(r["epoch"]), float(r["train_loss"]), float(r["val_loss"]))
                for r in csv.DictReader(f)]


@pytest.mark.parametrize("device_data", ["false", "true"])
def test_train_cli_over_two_ranks_matches_one_process(corpus, tmp_path, device_data,
                                                      monkeypatch):
    """Two ranks of the train CLI (dropout off, data_axis_size 2): one run
    directory, written by rank 0 alone (rank 1 is pointed at a directory it
    must never create); two epochs and a resumed third whose losses equal a
    one-process run's that steps on the ranks' two halves of every batch
    (``torch_port_ranks.halves_step_body``: the ranks' arithmetic, 1e-5
    relative; measured 0 for the train losses, 8.4e-8 at most for the
    validation losses) and lie within WHOLE_BATCH_BAR relative of a
    one-process run on the whole batch (the summation order alone,
    amplified by Adam over three epochs); the checkpoint restored on both
    ranks; TensorBoard scalars of every epoch. In fp32: under bf16 compute
    the encoder's and the
    modulator's weight gradients are rounded to bf16 on each rank before the
    all-reduce, so a sum of two halves' rounded gradients parts from the
    rounded gradient of the whole batch (2e-5 to 8e-5 of the loss after
    three epochs here)."""
    sets = ("model.dropout=0.0", "training.precision=fp32",
            f"training.device_data={device_data}", "training.data_axis_size=2",
            "training.logging=true")
    args = ["-m", "mri_inr_tpu_torch.cli.train"]
    elsewhere = tmp_path / "rank1_never_writes"
    rank1 = {1: ["--set", f"training.output_dir={elsewhere}"]}
    ranks.launch(args + _train_argv(corpus, tmp_path / "dp", "training.epochs=2", *sets),
                 2, tmp_path / "first", rank_args=rank1)
    outs = ranks.launch(args + _train_argv(corpus, tmp_path / "dp", "training.epochs=3",
                                           "training.continue_training=true", *sets),
                        2, tmp_path / "resumed", rank_args=rank1)
    assert not elsewhere.exists()
    (run_dir,) = (tmp_path / "dp").iterdir()
    assert all("restored step" in o and "continuing at epoch 2" in o for o in outs), outs
    assert "data-parallel over 2 ranks" in outs[0]
    one = ("model.dropout=0.0", "training.precision=fp32", f"training.device_data={device_data}")
    single = cli_train.main(_train_argv(corpus, tmp_path / "single", "training.epochs=3", *one))
    monkeypatch.setattr(ttrainer, "_make_step_body", ranks.halves_step_body(2))
    halves = cli_train.main(_train_argv(corpus, tmp_path / "halves", "training.epochs=3", *one))
    got = _progress(run_dir)
    assert [g[0] for g in got] == [2]  # the resumed run's log
    scalars = tensorboard.read_scalars(run_dir / "tensorboard")
    assert [s for s, _ in scalars["training_loss"]] == [0, 1, 2]
    for ref, bar in ((halves, 1e-5), (single, WHOLE_BATCH_BAR)):
        want = [(r["epoch"], r["train_loss"], r["val_loss"]) for r in ref._progress]
        np.testing.assert_allclose([g[1:] for g in got], [w[1:] for w in want[2:]], rtol=bar)
        np.testing.assert_allclose([v for _, v in scalars["validation_loss"]],
                                   [w[2] for w in want], rtol=bar)
    assert (run_dir / "checkpoints" / f"step_{single.state.step:08d}" / "state.pt").is_file()


@pytest.mark.parametrize("device_data", ["false", "true"])
def test_the_whole_batch_bar_sees_half_a_batch(corpus, tmp_path, device_data, monkeypatch):
    """The planted fault that the ranks could share with their witness
    (``halves_step_body``, whose rows both come from ``mesh.local_rows``):
    every rank stepping on rank 0's rows, so half of every batch is left out
    (as where each rank steps on its own gradients, unreduced). Against one
    process on the whole batch it lies outside WHOLE_BATCH_BAR at every
    epoch, the ranks' true halves inside it."""
    one = ("model.dropout=0.0", "training.precision=fp32", f"training.device_data={device_data}",
           "training.epochs=3")
    single = cli_train.main(_train_argv(corpus, tmp_path / "single", *one))
    runs = {}
    for name, rows_of in (("halves", None), ("fault", lambda r: 0)):
        monkeypatch.setattr(ttrainer, "_make_step_body", ranks.halves_step_body(2, rows_of))
        runs[name] = cli_train.main(_train_argv(corpus, tmp_path / name, *one))
    gap = {name: [max(abs(a[k] - b[k]) / abs(b[k]) for k in ("train_loss", "val_loss"))
                  for a, b in zip(run._progress, single._progress)]
           for name, run in runs.items()}
    assert len(gap["fault"]) == 3 and min(gap["fault"]) > WHOLE_BATCH_BAR, gap
    assert max(gap["halves"]) <= WHOLE_BATCH_BAR, gap


def test_torchrun_starts_the_ranks(corpus, tmp_path):
    """The other route: ``torchrun`` (its own rendezvous on a free local
    port) sets RANK, WORLD_SIZE and LOCAL_RANK; one run directory."""
    env = {k: v for k, v in os.environ.items() if k not in distributed.TRIPLE}
    env.update(OMP_NUM_THREADS="1", MRI_INR_DIST_TIMEOUT=ranks.DIST_TIMEOUT)
    torchrun = pathlib.Path(sys.executable).parent / "torchrun"
    proc = subprocess.run(
        [str(torchrun), "--standalone", "--nproc-per-node", "2", "-m",
         "mri_inr_tpu_torch.cli.train", *_train_argv(corpus, tmp_path / "out", "training.epochs=1",
                                                      "training.data_axis_size=2")],
        cwd=ranks.ROOT, env=env, capture_output=True, text=True, timeout=ranks.RANK_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "distributed: 2 ranks, collectives over gloo" in proc.stdout
    assert proc.stdout.count("done; final step 3") == 2
    (run_dir,) = (tmp_path / "out").iterdir()
    assert [r[0] for r in _progress(run_dir)] == [0]


def test_train_cli_refuses_a_data_axis_other_than_the_ranks(corpus, tmp_path):
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        cli_train.main(_train_argv(corpus, tmp_path, "training.data_axis_size=2"))
    with pytest.raises(AssertionError, match="not divisible by the 2 ranks"):
        ranks.launch(["-m", "mri_inr_tpu_torch.cli.train"]
                     + _train_argv(corpus, tmp_path, "training.batch_size=33"), 2, tmp_path)


@pytest.fixture(scope="module")
def model_run(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("run")
    return cli_train.main(_train_argv(corpus, out, "training.epochs=1")).run_dir


def _test_argv(corpus, run_dir, out, *extra):
    argv = ["--device", "cpu", "--set", f"data.dataset={corpus}",
            "--set", f"data.model_path={run_dir}", "--set", f"data.output_dir={out}",
            "--set", "data.output_name=dp", "--set", "data.batch_patches=64", *MODEL_SETS]
    for s in extra:
        argv += ["--set", s]
    return argv


def _rows(path):
    with open(path, newline="") as f:
        return [tuple(r.values()) for r in csv.DictReader(f)]


def test_test_cli_over_two_ranks_equals_the_merged_shards(corpus, model_run, tmp_path):
    """``--devices 2`` over two ranks: the rows are gathered and rank 0
    writes the file a ``--shard 0:2`` + ``--shard 1:2`` + ``--merge-shards``
    run writes, row for row and exactly, and the one-process file's rows;
    rank 1 writes nothing."""
    elsewhere = tmp_path / "rank1_never_writes"
    ranks.launch(["-m", "mri_inr_tpu_torch.cli.test", "--devices", "2"]
                 + _test_argv(corpus, model_run, tmp_path / "ranks"), 2, tmp_path / "launch",
                 rank_args={1: ["--set", f"data.output_dir={elsewhere}"]})
    assert not elsewhere.exists()
    for i in (0, 1):
        cli_test.main(_test_argv(corpus, model_run, tmp_path / "shards") + ["--shard", f"{i}:2"])
    cli_test.main(_test_argv(corpus, model_run, tmp_path / "shards") + ["--merge-shards"])
    cli_test.main(_test_argv(corpus, model_run, tmp_path / "one"))
    got = _rows(tmp_path / "ranks" / "dp" / "metrics_error.csv")
    assert len(got) == 6
    assert got == _rows(tmp_path / "shards" / "dp" / "metrics_error.csv")
    assert sorted(got) == sorted(_rows(tmp_path / "one" / "dp" / "metrics_error.csv"))
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        cli_test.main(_test_argv(corpus, model_run, tmp_path / "one") + ["--devices", "4"])
