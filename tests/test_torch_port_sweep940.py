"""The port's 940-file sweep (``python -m mri_inr_tpu_torch.cli.sweep940``) on
the CPU at a tiny size: 6 volumes x 2 slices at 64x64, H=32, latent 16,
L=3, the headline model trained 2 epochs and resumed to 3.

- The evaluation volumes are the JAX package's: ``synthetic_kspace(5000 +
  i)`` equals what ``write_synthetic_h5(seed=5000)`` writes for file i, read
  back with ``h5py`` (bit for bit).
- The online leg (the k-space in memory, through the test CLI's sampler
  seam) gives the offline leg's rows, and the seam keeps ``--shard``.
- ``--shard 0:2`` + ``--shard 1:2`` + ``--merge-shards`` give the
  unsharded rows exactly; a slice's rows do not see its piece here.
- On weights transplanted from the JAX package, the sweep's rows agree with
  the JAX package's ``evaluate_files`` (Pallas kernel in interpret mode)
  within PSNR 1e-3 dB and SSIM / NRMSE 1e-5 (the eval bars of
  tests/test_torch_port_eval.py).
- The resumed run's mask epochs continue where the first run stopped.
- ``sweep940.json`` holds every field the record promises.
"""

import json

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_inr_tpu.data import synthetic as jsyn
from mri_inr_tpu.data.dataset import MRISampler as JaxSampler
from mri_inr_tpu.eval import evaluate as jev
from mri_inr_tpu.models.modulated_siren import ModulatedSiren as JaxModel
from mri_inr_tpu.ops.siren_kernel import make_apply_fn as jax_make_apply_fn
from mri_inr_tpu_torch.cli import sweep940
from mri_inr_tpu_torch.cli import test as cli_test
from mri_inr_tpu_torch.data import synthetic
from mri_inr_tpu_torch.data.online import OnlineKspaceDataset, OnlineSampler
from mri_inr_tpu_torch.eval import evaluate as tev
from mri_inr_tpu_torch.interop import load_flax_params
from mri_inr_tpu_torch.models.modulated_siren import ModulatedSiren
from mri_inr_tpu_torch.train import checkpoint as ckpt_lib
from mri_inr_tpu_torch.train.trainer import create_train_state

torch.set_num_threads(1)

WIDTHS = dict(dim_hidden=32, latent_dim=16, num_layers=3)
MODEL_SETS = [x for k, v in WIDTHS.items() for x in ("--set", f"model.{k}={v}")]
TINY = ["--device", "cpu", "--files", "6", "--slices", "2", "--size", "64",
        "--train-files", "2", "--val-files", "1", "--encoder", "none", *MODEL_SETS]


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep940")
    out = sweep940.main(["--root", str(root), "--epochs", "2", "--resume-epochs", "3",
                         "--set", "training.batch_size=32", *TINY])
    return root, out


def _csv(path):
    return sorted((r.slice_id, r.psnr, r.ssim, r.nrmse) for r in tev.read_metrics_csv(path))


@pytest.mark.parametrize("i", range(6))
def test_eval_volumes_are_the_jax_writers_files(tmp_path_factory, i):
    d = tmp_path_factory.getbasetemp() / "jax_h5"
    if not d.exists():
        jsyn.write_synthetic_h5(d, num_files=6, num_slices=2, height=64, width=64, seed=5000)
    with h5py.File(d / f"{synthetic.synthetic_stem(5000 + i)}.h5") as f:
        want = f["kspace"][()]
    got = synthetic.synthetic_kspace(5000 + i, 2, 64, 64)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_online_leg_gives_the_offline_rows(sweep):
    root, out = sweep
    full = _csv(root / "eval" / "full" / "metrics_error.csv")
    assert len(full) == 12
    assert _csv(root / "eval" / "online_full" / "metrics_error.csv") == full
    assert out["checks"]["online"] == {"max_stat_gap": 0.0, "bar": 1e-4, "max_row_gap": 0.0,
                                       "held": True}


def test_sampler_seam_takes_the_shard(sweep, tmp_path):
    """``cli/test.main(sampler=...)``: an in-memory online sampler replaces
    the one ``data.*`` names, and ``--shard`` takes its share."""
    root, out = sweep
    stems = [synthetic.synthetic_stem(5000 + i) for i in range(6)]
    volumes = [synthetic.synthetic_kspace(5000 + i, 2, 64, 64) for i in range(6)]
    ds = OnlineKspaceDataset.from_volumes(stems, volumes, max_slice_num=100,
                                          remask_each_epoch=False, device="cpu")
    argv = ["--device", "cpu", "--shard", "1:2"] + [x for s in (
        f"data.dataset={root / 'data' / 'processed' / 'metadata.csv'}",
        f"data.model_path={root / out['model_dir']}", "data.max_slice_num=100",
        "data.batch_patches=512", "data.visual_samples=0", f"data.output_dir={tmp_path}",
        "data.output_name=seam", *MODEL_SETS[1::2]) for x in ("--set", s)]
    timings = {}
    got = cli_test.main(argv, sampler=OnlineSampler(ds, host_prefetch=False),
                        timings=timings)
    want = tev.read_metrics_csv(root / "eval" / "sharded" / "metrics_shard1_2" /
                                "metrics_error.csv")
    assert got == want and len(got) == 6
    assert timings["slices"] == 6 and set(timings) >= {
        "metric_seconds", "stage_seconds", "dispatch_seconds", "execute_fetch_seconds"}


def test_two_shards_merged_equal_the_unsharded_rows(sweep):
    root, out = sweep
    merged = _csv(root / "eval" / "sharded" / "metrics_error.csv")
    assert merged == _csv(root / "eval" / "full" / "metrics_error.csv")
    shards = [_csv(root / "eval" / "sharded" / f"metrics_shard{i}_2" / "metrics_error.csv")
              for i in range(2)]
    assert [len(s) for s in shards] == [6, 6] and sorted(shards[0] + shards[1]) == merged
    checks = out["checks"]["shards"]
    assert checks["exact"] and checks["held"] and checks["max_row_gap"] == 0.0
    assert checks["row_bar"] == 0.0  # the CPU holds the merge exactly
    piece = checks["piece_invariance"]
    assert piece["patches"] == 16
    assert piece["encoder"] == piece["forward"] == piece["metrics"] == 0.0


def test_resumed_run_continues_the_mask_epochs(sweep):
    root, out = sweep
    first, resumed = out["headline"]["runs"]
    assert first["epochs"] == [0, 2] and resumed["epochs"] == [2, 3]
    # the first run: epoch 0 (initial losses and its first epoch), then 1;
    # the resumed run: epoch 0 for its initial losses, then 2, not 0 again
    assert first["mask_epochs"] == {"ends": [0, 1], "count": 2}
    assert resumed["mask_epochs"] == {"ends": [0, 2], "count": 2}
    steps_per_epoch = 2 * 2 * 16 // 32  # 2 volumes x 2 slices x 16 patches, batch 32
    assert (first["steps"], resumed["steps"]) == (2 * steps_per_epoch, 3 * steps_per_epoch)
    run_dir = root / out["headline"]["run_dir"]
    logs = [(run_dir / f"progress_log_to_{e}.csv").read_text().splitlines()
            for e in (2, 3)]
    assert [ln.split(",")[0] for ln in logs[0][1:]] == ["0", "1"]
    assert [ln.split(",")[0] for ln in logs[1][1:]] == ["2"]
    assert json.loads((root / "run_info.json").read_text()) == out["headline"]


def test_sweep940_json_holds_every_field(sweep):
    root, out = sweep
    assert json.loads((root / "sweep940.json").read_text()) == out
    assert (out["slices"], out["image_size"], out["eval_seeds"]) == (12, 64, [5000, 5005])
    assert out["device"] == "cpu" and out["torch"] == torch.__version__
    assert set(out["legs"]) == {"offline", "online", "shard0", "shard1", "merge"}
    for name in ("offline", "online", "shard0", "shard1"):
        leg = out["legs"][name]
        assert set(leg) == {"wall_seconds", "metric_pass_seconds", "stage_seconds",
                            "dispatch_seconds", "execute_fetch_seconds",
                            "steady_slices_per_sec", "peak_device_mib", "slices"}, name
        assert leg["slices"] == (12 if name in ("offline", "online") else 6)
        assert leg["steady_slices_per_sec"] > 0 and leg["peak_device_mib"] is None
    assert set(out["launches"]) == {"data", "train_to_2", "train_to_3", "offline", "online",
                                    "shard0", "shard1"}
    assert set(out["launches"]["offline"]) == {"dft2c", "siren_train_fwd", "siren_train_bwd",
                                               "siren_forward", "threefry_dropout"}
    for key in ("summary", "online_summary", "sharded_summary"):
        assert set(out[key]) == {"PSNR", "SSIM", "NRMSE"}
    summary = (root / "eval" / "full" / "metrics_summary.txt").read_text()
    assert f"mean={out['summary']['PSNR']['mean']:.4f}" in summary
    jax_ref = out["checks"]["jax"]
    assert jax_ref["summary"]["PSNR"]["mean"] == 31.2677
    assert jax_ref["deltas"]["PSNR"] == pytest.approx(out["summary"]["PSNR"]["mean"] - 31.2677)
    head = out["headline"]
    assert head["train_seeds"] == [7000, 7001] and head["val_seeds"] == [7002, 7002]
    assert all(np.isfinite([r["train_loss"], r["val_loss"]]).all() for r in head["runs"])


# last: it scores another model into the fixture's directory
def test_sweep_rows_match_jax_on_transplanted_weights(sweep, tmp_path):
    root, _ = sweep
    jm = JaxModel(dropout=0.0, **WIDTHS)
    params = jax.device_get(jax.jit(jm.init)(jax.random.key(3),
                                             jnp.zeros((2, 32, 32)))["params"])
    tm = ModulatedSiren(**WIDTHS, device="cpu")
    load_flax_params(tm, params)
    ckpt_lib.save_state(tmp_path / "run", 5, create_train_state(tm, "adam", 1e-4))
    # the same evaluation split: its data directory is reused, not rebuilt
    meta = root / "data" / "processed" / "metadata.csv"
    written = meta.stat().st_mtime_ns
    out = sweep940.main(["--root", str(root), "--model-dir", str(tmp_path / "run"), *TINY])
    assert out["headline"] is None and meta.stat().st_mtime_ns == written
    jrec = jev.SliceReconstructor(jax_make_apply_fn(jm, interpret=True, sin5=True),
                                  patch_bucket=512)
    want = jev.evaluate_files(jrec, params, JaxSampler(str(meta), max_slice_num=100),
                              progress_every=0)
    got = {r[0]: r[1:] for r in _csv(root / "eval" / "full" / "metrics_error.csv")}
    assert len(got) == len(want) == 12
    for r in want:
        p, s, n = got[r.slice_id]
        assert abs(p - r.psnr) <= 1e-3, r.slice_id
        assert abs(s - r.ssim) <= 1e-5, r.slice_id
        assert abs(n - r.nrmse) <= 1e-5, r.slice_id
