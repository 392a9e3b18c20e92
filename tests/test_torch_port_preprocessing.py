"""The port's preprocessing path (synthetic k-space -> ``.h5`` ->
``process_files`` -> ``.npy`` slices + ``metadata.csv``), its CLI and its
native tile helpers against the JAX package's.

- synthetic: numpy only on both sides, the same seeds: equal arrays.
- preprocessing: the same ``.h5`` files through both ``process_files``; the
  port on the CPU (``torch.fft``), each package drawing its own masks (the
  same ``jax.random`` draws): the same header and rows, every ``.npy``
  within 2e-5 (two float32 FFT libraries, then a min-max to [0, 1]).
- the port's run repeats itself bit for bit and its masks keep the centre
  band.
- native: the C++ functions exact-equal to the numpy ones.
"""

import csv
import pathlib

import h5py
import numpy as np
import pytest
import torch

from mri_inr_tpu.data import preprocessing as jpre
from mri_inr_tpu.data import synthetic as jsyn
from mri_inr_tpu_torch import native
from mri_inr_tpu_torch.cli import preprocess as cli_preprocess
from mri_inr_tpu_torch.data import kspace as tk
from mri_inr_tpu_torch.data import preprocessing as tpre
from mri_inr_tpu_torch.data import synthetic as tsyn
from mri_inr_tpu_torch.utils import jax_random as jr

torch.set_num_threads(1)

MASKS = [(0.05, 6), (0.1, 4)]
HARD = dict(phase=True, snr_db=25.0, texture=0.18)


# ---------------------------------------------------------------- synthetic
def test_phase_map_and_kspace_match():
    np.testing.assert_array_equal(
        tsyn.random_phase_map(np.random.default_rng(4), 48, 40),
        jsyn.random_phase_map(np.random.default_rng(4), 48, 40))
    vol = tsyn.phantom_volume(2, 3, 48, 40, texture=0.2)
    phase = np.stack([tsyn.random_phase_map(np.random.default_rng(s), 48, 40)
                      for s in range(3)])
    for kw in (dict(), dict(phase=phase), dict(phase=phase, snr_db=20.0)):
        rngs = [np.random.default_rng(9) for _ in range(2)]
        got = tsyn.volume_to_kspace(vol, noise_rng=rngs[0], **kw)
        want = jsyn.volume_to_kspace(vol, noise_rng=rngs[1], **kw)
        assert got.dtype == np.complex64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(), HARD], ids=["plain", "hard"])
def test_write_synthetic_h5_matches(tmp_path, kw):
    common = dict(num_files=2, num_slices=3, height=48, width=40, seed=5, **kw)
    got = tsyn.write_synthetic_h5(tmp_path / "port", **common)
    want = jsyn.write_synthetic_h5(tmp_path / "jax", **common)
    assert [p.name for p in got] == [p.name for p in want]
    for g, w in zip(got, want):
        a, b = tpre.load_h5(g), jpre.load_h5(w)
        assert a.dtype == np.complex64 and a.shape == (3, 48, 40)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tsyn.synthetic_kspace(6, 3, 48, 40, **kw), tpre.load_h5(got[1]))
    assert got[1].stem == tsyn.synthetic_stem(6)


# ------------------------------------------------------------ preprocessing
def test_filename_metadata_and_seed_match():
    for stem in ("file_brain_AXFLAIR_000001", "file_brain_AXT1POST_2", "file_knee_T2_x",
                 "other"):
        assert tpre.get_mri_type(stem) == jpre.get_mri_type(stem)
        assert tpre.get_mri_area(stem) == jpre.get_mri_area(stem)
    assert tpre._stable_seed("a", 0.05, 6) == jpre._stable_seed("a", 0.05, 6)
    assert tpre.undersample_column(0.1, 4) == jpre.undersample_column(0.1, 4)


@pytest.fixture(scope="module")
def h5_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_pre")
    tsyn.write_synthetic_h5(d, num_files=2, num_slices=3, height=64, width=48, **HARD)
    return d


def _rows(meta):
    with open(meta, newline="") as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_process_files_matches_jax(h5_dir, tmp_path):
    """Each package draws its own masks (no mask injected): the same
    ``jax.random`` draws, so the files agree to the FFTs' bar."""
    want_meta = jpre.process_files(h5_dir, tmp_path / "jax", MASKS)
    got_meta = tpre.process_files(h5_dir, tmp_path / "port", MASKS, device="cpu")
    assert got_meta == tmp_path / "port" / "metadata.csv"
    (got_head, got_rows), (want_head, want_rows) = _rows(got_meta), _rows(want_meta)
    assert got_head == want_head
    assert len(got_rows) == len(want_rows) == 6
    paths = [c for c in got_head if c.startswith("path_")]
    assert len(paths) == 3
    for g, w in zip(got_rows, want_rows):
        for col in got_head:
            if col in paths:
                gp, wp = pathlib.Path(g[col]), pathlib.Path(w[col])
                assert gp.relative_to(tmp_path / "port") == wp.relative_to(tmp_path / "jax")
                a, b = np.load(gp), np.load(wp)
                assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (64, 48)
                np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
            else:
                assert g[col] == w[col], col


def test_process_files_repeats_itself_and_keeps_the_centre(h5_dir, tmp_path):
    a = tpre.process_files(h5_dir, tmp_path / "a", MASKS, device="cpu")
    b = tpre.process_files(h5_dir, tmp_path / "b", MASKS, device="cpu")
    assert (a.read_text().replace(str(tmp_path / "a"), "")
            == b.read_text().replace(str(tmp_path / "b"), ""))
    for p in sorted((tmp_path / "a").glob("*.npy")):
        np.testing.assert_array_equal(np.load(p), np.load(tmp_path / "b" / p.name))
    # an undersampled slice is the reconstruction under the seeded mask
    stem = sorted(h5_dir.glob("*.h5"))[0].stem
    k = torch.from_numpy(tk.to_ri(tpre.load_h5(h5_dir / f"{stem}.h5")))
    for cf, acc in MASKS:
        mask = tk.random_mask(jr.key(tpre._stable_seed(stem, cf, acc)), 48, cf, acc)
        low = tk.num_low_frequencies(48, cf)
        start = (48 - low + 1) // 2
        assert mask[start : start + low].all() and not mask.all()
        want = tk.normalize_scan(tk.reconstruct_magnitude_ri(tk.apply_mask_ri(k, mask)))
        got = np.load(tmp_path / "a" / f"{stem}_1_undersampled_{cf}_{acc}.npy")
        np.testing.assert_array_equal(got, want[1].numpy())
    full = np.load(tmp_path / "a" / f"{stem}_0_fullysampled.npy")
    assert 0.0 <= full.min() and full.max() <= 1.0


def test_process_kspace_volume_needs_no_h5(tmp_path):
    """The split that lets the path run where ``h5py`` is missing: a complex
    array in, the rows of ``process_volume`` out."""
    k = tsyn.synthetic_kspace(3, 2, 32, 32, texture=0.2)
    rows = tpre.process_kspace_volume(k, "file_brain_AXT2_x", tmp_path, [(0.1, 4)],
                                      device="cpu")
    assert [r["slice_id"] for r in rows] == ["file_brain_AXT2_x_0", "file_brain_AXT2_x_1"]
    assert rows[0]["mri_type"] == "T2" and rows[0]["mri_area"] == "Brain"
    assert list(rows[0]) == ["path_fullysampled", "stem", "slice_id", "slice_num", "width",
                             "height", "mri_type", "mri_area", "path_undersampled_0.1_4"]
    vol = tsyn.phantom_volume(3, 2, 32, 32, texture=0.2)
    full = np.stack([np.load(r["path_fullysampled"]) for r in rows])
    np.testing.assert_allclose(full, vol, rtol=0, atol=1e-4)
    with pytest.raises(FileNotFoundError):
        tpre.process_files(tmp_path / "empty")


def test_preprocess_cli_writes_what_process_files_writes(tmp_path, capsys):
    meta = cli_preprocess.main(["--path", str(tmp_path / "cli"), "--synthetic", "2",
                                "--texture", "0.2", "--masks", "0.05:6", "--device", "cpu",
                                "--output", str(tmp_path / "cli_out")])
    assert "wrote 2 synthetic volumes" in capsys.readouterr().out
    assert meta == tmp_path / "cli_out" / "metadata.csv"
    assert cli_preprocess.parse_mask("0.1:4") == (0.1, 4)
    tsyn.write_synthetic_h5(tmp_path / "lib", num_files=2, texture=0.2)
    want = tpre.process_files(tmp_path / "lib", tmp_path / "lib_out", [(0.05, 6)],
                              device="cpu")
    head, rows = _rows(meta)
    assert head == _rows(want)[0] and len(rows) == 24
    for p in sorted((tmp_path / "lib_out").glob("*.npy")):
        np.testing.assert_array_equal(np.load(tmp_path / "cli_out" / p.name), np.load(p))
    with h5py.File(tmp_path / "cli" / "file_brain_AXFLAIR_000001.h5") as f:
        assert f["kspace"].shape == (12, 320, 320)


# ------------------------------------------------------------------ native
def test_native_builds():
    assert native.have_native()


@pytest.mark.parametrize("shape", [(96, 96), (100, 90), (320, 320), (17, 33)])
def test_native_tile_matches_numpy(shape):
    img = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    got, grid_got = native.tile_image(img, 32, 16)
    want, grid_want = native._tile_np(img, 32, 16)
    assert grid_got == grid_want
    np.testing.assert_array_equal(got, want)


def test_native_gather_and_means_match_numpy():
    rng = np.random.default_rng(7)
    fully = rng.uniform(size=(64, 32, 32)).astype(np.float32)
    under = rng.uniform(size=(64, 32, 32)).astype(np.float32)
    idx = rng.integers(0, 64, size=40)
    got_f, got_u = native.gather_pairs(fully, under, idx)
    np.testing.assert_array_equal(got_f, fully[idx])
    np.testing.assert_array_equal(got_u, under[idx])
    assert got_f.flags.c_contiguous and got_f.base is None
    np.testing.assert_array_equal(native.patch_means(fully), native._patch_means_np(fully))
    black = np.zeros((3, 32, 32), np.float32)
    np.testing.assert_array_equal(native.patch_means(black), np.zeros(3, np.float32))


def test_native_can_be_switched_off(monkeypatch):
    monkeypatch.setenv("MRI_INR_TPU_TORCH_NO_NATIVE", "1")
    native._load.cache_clear()
    try:
        assert not native.have_native()
        img = np.random.default_rng(1).uniform(size=(40, 50)).astype(np.float32)
        np.testing.assert_array_equal(native.tile_image(img, 32, 16)[0],
                                      native._tile_np(img, 32, 16)[0])
    finally:
        monkeypatch.delenv("MRI_INR_TPU_TORCH_NO_NATIVE")
        native._load.cache_clear()
    assert native.have_native()
