"""The port's ``MRIDatasetLowMemory`` against the JAX package's on one
corpus, with and without ``filter_black``: ``len``, the batches of two
seeds (shuffled and in order, ragged last batch included) and ``get_slice``
equal bit for bit; and the train CLI's ``data.low_memory`` run."""

import numpy as np
import pytest
import torch

from mri_inr_tpu.data import dataset as jds
from mri_inr_tpu.data import synthetic as jsyn
from mri_inr_tpu.data.preprocessing import process_files
from mri_inr_tpu_torch.cli import train as cli_train
from mri_inr_tpu_torch.data import dataset as tds

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def metadata(tmp_path_factory):
    d = tmp_path_factory.mktemp("lowmem")
    jsyn.write_synthetic_h5(d, num_files=3, num_slices=2, height=80, width=96)
    meta = process_files(d)
    # black corners in two fully sampled slices, so filter_black drops patches
    for row in tds.read_metadata(meta)[:4:3]:
        img = np.load(row["path_fullysampled"])
        img[:40, :56] = 0.0
        np.save(row["path_fullysampled"], img)
    return meta


def _pair(metadata, **kw):
    return (jds.MRIDatasetLowMemory(metadata, cache_slices=2, **kw),
            tds.MRIDatasetLowMemory(metadata, cache_slices=2, **kw))


@pytest.mark.parametrize("filter_black", [False, True], ids=["all", "filter_black"])
def test_low_memory_dataset_matches_jax(metadata, filter_black):
    jd, td = _pair(metadata, filter_black=filter_black)
    assert len(td) == len(jd)
    if filter_black:
        assert len(td) < len(tds.MRIDatasetLowMemory(metadata))  # black patches went
    for seed in (0, 7):
        for shuffle in (True, False):
            want = list(jd.batches(64, seed=seed, shuffle=shuffle))
            got = list(td.batches(64, seed=seed, shuffle=shuffle, prefetch=2))
            assert len(got) == len(want) == -(-len(jd) // 64)
            for (gf, gu), (wf, wu) in zip(got, want):
                assert np.array_equal(gf, wf) and np.array_equal(gu, wu)
    for i in (0, 3, 7):
        a, b = jd.get_slice(i), td.get_slice(i)
        assert a.slice_id == b.slice_id
        assert np.array_equal(a.fully_sampled, b.fully_sampled)
        assert np.array_equal(a.undersampled, b.undersampled)
    for idx in (0, len(td) // 2, len(td) - 1):
        for x, y in zip(jd[idx], td[idx]):
            assert np.array_equal(x, y)


def test_in_order_epochs_equal_the_eager_dataset(metadata):
    lazy, eager = tds.MRIDatasetLowMemory(metadata), tds.MRIDataset(metadata)
    assert len(lazy) == len(eager) and not hasattr(lazy, "fully_tiles")
    for (lf, lu), (ef, eu) in zip(lazy.batches(50, seed=0, shuffle=False),
                                  eager.batches(50, seed=0, shuffle=False)):
        assert np.array_equal(lf, ef) and np.array_equal(lu, eu)


def test_lru_keeps_the_most_recent_slices(metadata):
    td = tds.MRIDatasetLowMemory(metadata, cache_slices=2)
    for i in (0, 1, 0, 2):
        td._tiles_for(i)
    assert list(td._cache) == [0, 2]


def test_train_cli_low_memory_runs_step_by_step(metadata, tmp_path, capsys):
    sets = [f"data.train.dataset={metadata}", f"data.val.dataset={metadata}",
            "data.val.max_slice_num=0", "data.low_memory=true", "model.dim_hidden=32",
            "model.latent_dim=16", "model.num_layers=2", "training.batch_size=64",
            "training.epochs=1", "training.device_data=true", "training.save_interval=1000",
            f"training.output_dir={tmp_path}", "training.output_name=lowmem"]
    t = cli_train.main(["--device", "cpu"] + [x for s in sets for x in ("--set", s)])
    assert isinstance(t.train_dataset, tds.MRIDatasetLowMemory)
    assert t.state.step == -(-len(t.train_dataset) // 64)
    assert "holds no tiles to keep on the device" in capsys.readouterr().out
    assert np.isfinite(t._progress[0]["train_loss"])
    assert (t.run_dir / "processed_files.txt").read_text().count(".npy") == 6
