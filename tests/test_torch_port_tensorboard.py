"""The port's TensorBoard scalars (``utils/tensorboard.py``, a package's
``SummaryWriter``) read back by TensorBoard's own reader
(``tensorboard.backend.event_processing``): tags, steps and values exactly
(a value is a float32); a missing writer raises; the trainer's
``tensorboard=True`` writes ``training_loss`` and ``validation_loss`` per
epoch as the JAX trainer does."""

import sys

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

import torch_port_ranks as ranks
from mri_inr_tpu_torch.data.dataset import MRIDataset
from mri_inr_tpu_torch.train import losses, trainer
from mri_inr_tpu_torch.utils import tensorboard

torch.set_num_threads(1)

POINTS = {"training_loss": [(s, 1 / 3 + 0.1 * s) for s in range(5)],
          "validation_loss": [(s, 2.0 ** -s) for s in (0, 2, 7)],
          "a/nested_tag": [(123456789, -1e-30), (123456790, 3.4e38)]}


def test_tensorboard_reads_back_tags_steps_and_values(tmp_path):
    """Two writers into one directory (a run and its resumption): every
    point comes back, through TensorBoard's reader and the port's."""
    first, second = tensorboard.summary_writer(tmp_path), None
    for tag, points in POINTS.items():
        for i, (step, value) in enumerate(points):
            if tag == "validation_loss" and i == 1:
                first.close()
                second = tensorboard.summary_writer(tmp_path)
            (second or first).add_scalar(tag, value, step)
    second.close()
    want = {tag: [(s, float(np.float32(v))) for s, v in points]
            for tag, points in POINTS.items()}
    acc = EventAccumulator(str(tmp_path))
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == sorted(POINTS)
    for tag in POINTS:
        assert [(e.step, e.value) for e in acc.Scalars(tag)] == want[tag]
    assert tensorboard.read_scalars(tmp_path) == want


def test_missing_writer_raises(monkeypatch, tmp_path):
    """With neither tensorboardX nor torch.utils.tensorboard importable, a
    run that asked for scalars raises instead of going on without them."""
    for name in ("tensorboardX", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="training.logging"):
        tensorboard.summary_writer(tmp_path)
    assert not list(tmp_path.iterdir())


def test_trainer_writes_the_two_losses_per_epoch(tmp_path):
    rng = np.random.default_rng(0)
    ds = MRIDataset.__new__(MRIDataset)
    ds.fully_tiles, ds.under_tiles = (rng.uniform(size=(64, 32, 32)).astype(np.float32)
                                      for _ in range(2))
    model = ranks.small_model(0.0, "cpu")
    t = trainer.Trainer(model, trainer.create_train_state(model, "adam", 1e-3), losses.mse,
                        ds, ds, tmp_path, batch_size=32, save_interval=100, tensorboard=True,
                        use_pallas=True, device="cpu", log=lambda *_: None)
    t.train(3)
    acc = EventAccumulator(str(tmp_path / "tensorboard"))
    acc.Reload()
    for tag, key in (("training_loss", "train_loss"), ("validation_loss", "val_loss")):
        got = [(e.step, e.value) for e in acc.Scalars(tag)]
        assert got == [(r["epoch"], float(np.float32(r[key]))) for r in t._progress]
