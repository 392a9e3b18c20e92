"""Offline preprocessing: ``.h5`` k-space volumes -> normalised image-space
``.npy`` slices + ``metadata.csv`` (counterpart of
``mri_inr_tpu/data/preprocessing.py``).

Per volume: a fully sampled reconstruction and one undersampled variant per
(center_fraction, acceleration) pair, each min-max normalised over the whole
volume, and a metadata index with the columns ``path_fullysampled, stem,
slice_id, slice_num, width, height, mri_type, mri_area,
path_undersampled_{cf}_{acc}...``.

On the card the whole volume goes up once as float32 real/imag pairs, every
reconstruction is one launch of the DFT kernel
(:func:`mri_inr_tpu_torch.ops.fft_kernel.reconstruct_magnitude_ri_dft`), the
min-max runs on the device and each variant comes back in one copy. With
``device="cpu"`` the reconstruction is the ``torch.fft`` pipeline of
:mod:`mri_inr_tpu_torch.data.kspace` (the kernel where the accelerator is,
the library FFT elsewhere, as in the JAX package).

Masks are drawn under the ``jax.random`` key ``key(_stable_seed(stem, cf,
acc))``: one mask per volume and variant, reproducible across processes and
equal to the JAX package's (:func:`mri_inr_tpu_torch.data.kspace.
random_mask`).

``h5py`` is imported by :func:`load_h5` only, so
:func:`process_kspace_volume` runs where it is not installed.
"""

from __future__ import annotations

import csv
import pathlib
import zlib

import numpy as np
import torch

from mri_inr_tpu_torch.data import kspace
from mri_inr_tpu_torch.data.dataset import undersample_column
from mri_inr_tpu_torch.ops import fft_kernel
from mri_inr_tpu_torch.utils import jax_random
from mri_inr_tpu_torch.utils.device import resolve_device

DEFAULT_MASKS = ((0.05, 6), (0.1, 6))


def load_h5(path: str | pathlib.Path) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        return f["kspace"][()]


def get_mri_type(stem: str) -> str | None:
    s = stem.lower()
    if "flair" in s:
        return "Flair"
    if "t1" in s:
        return "T1"
    if "t2" in s:
        return "T2"
    return None


def get_mri_area(stem: str) -> str | None:
    s = stem.lower()
    if "brain" in s:
        return "Brain"
    if "knee" in s:
        return "Knee"
    return None


def _stable_seed(*parts) -> int:
    """Deterministic 32-bit seed from string / number parts (a crc, stable
    across processes, unlike ``hash``)."""
    text = "|".join(str(p) for p in parts)
    return zlib.crc32(text.encode())


@torch.no_grad()
def process_kspace_volume(
    kspace_volume: np.ndarray, stem: str, output_dir: str | pathlib.Path,
    undersample_params=DEFAULT_MASKS, *, device: str | torch.device | None = None,
    masks: dict | None = None,
) -> list[dict]:
    """Process one complex (S, H, W) k-space volume named ``stem``; returns one
    metadata row per slice. ``masks`` optionally maps ``(cf, acc)`` to a
    boolean (W,) array that replaces the seeded draw."""
    dev = resolve_device(device)
    output_dir = pathlib.Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    k = torch.from_numpy(kspace.to_ri(kspace_volume)).to(dev)
    recon = (fft_kernel.reconstruct_magnitude_ri_dft if dev.type == "cuda"
             else kspace.reconstruct_magnitude_ri)

    full = kspace.normalize_scan(recon(k))
    variants = {}
    for cf, acc in undersample_params:
        if masks is not None and (cf, acc) in masks:
            mask = np.array(masks[(cf, acc)], bool)
        else:
            key = jax_random.key(_stable_seed(stem, cf, acc))
            mask = kspace.random_mask(key, k.shape[-2], cf, acc)
        variants[(cf, acc)] = kspace.normalize_scan(recon(kspace.apply_mask_ri(k, mask)))

    full_np = full.cpu().numpy()
    variants_np = {p: v.cpu().numpy() for p, v in variants.items()}
    rows = []
    for s in range(full_np.shape[0]):
        slice_id = f"{stem}_{s}"
        full_path = output_dir / f"{slice_id}_fullysampled.npy"
        np.save(full_path, full_np[s])
        row = {
            "path_fullysampled": str(full_path),
            "stem": stem,
            "slice_id": slice_id,
            "slice_num": s,
            "width": full_np.shape[2],
            "height": full_np.shape[1],
            "mri_type": get_mri_type(stem),
            "mri_area": get_mri_area(stem),
        }
        for (cf, acc), vol in variants_np.items():
            upath = output_dir / f"{slice_id}_undersampled_{cf}_{acc}.npy"
            np.save(upath, vol[s])
            row[undersample_column(cf, acc)] = str(upath)
        rows.append(row)
    return rows


def process_volume(path: str | pathlib.Path, output_dir: str | pathlib.Path,
                   undersample_params=DEFAULT_MASKS, *,
                   device: str | torch.device | None = None,
                   masks: dict | None = None) -> list[dict]:
    """Process one ``.h5`` volume; returns one metadata row per slice."""
    path = pathlib.Path(path)
    return process_kspace_volume(load_h5(path), path.stem, output_dir,
                                 undersample_params, device=device, masks=masks)


def write_metadata(rows: list[dict], output_dir: str | pathlib.Path) -> pathlib.Path:
    """Write ``metadata.csv`` (columns in the rows' own order)."""
    metadata_path = pathlib.Path(output_dir) / "metadata.csv"
    with open(metadata_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    return metadata_path


def process_files(data_root: str | pathlib.Path,
                  output_dir: str | pathlib.Path | None = None,
                  undersample_params=DEFAULT_MASKS, *,
                  device: str | torch.device | None = None,
                  masks: dict | None = None) -> pathlib.Path:
    """Walk ``*.h5`` under ``data_root``, write slices + ``metadata.csv`` into
    ``output_dir`` (default: ``data_root/processed``). Returns the metadata
    path. ``masks`` optionally maps a file stem to that volume's
    ``{(cf, acc): mask}``."""
    data_root = pathlib.Path(data_root)
    output_dir = pathlib.Path(output_dir or data_root / "processed")
    output_dir.mkdir(parents=True, exist_ok=True)

    rows = []
    for path in sorted(data_root.glob("*.h5")):
        rows.extend(process_volume(path, output_dir, list(undersample_params),
                                   device=device, masks=(masks or {}).get(path.stem)))
    if not rows:
        raise FileNotFoundError(f"No .h5 files found under {data_root}")
    return write_metadata(rows, output_dir)
