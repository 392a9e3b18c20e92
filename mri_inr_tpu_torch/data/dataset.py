"""Evaluation data (the eval subset of ``mri_inr_tpu/data/dataset.py``).

``MRISampler`` reads ``metadata.csv``, keeps the selected rows (MRI type,
``slice_num <= max_slice_num``), shuffles them once with
``default_rng(42).permutation`` and serves whole slices in that order, as the
JAX sampler does. Slices are numpy arrays; the evaluation moves them to the
device.
"""

from __future__ import annotations

import copy
import csv
import pathlib
from dataclasses import dataclass

import numpy as np


def undersample_column(cf: float, acc: int) -> str:
    """Metadata column of the slices undersampled with centre fraction
    ``cf`` and acceleration ``acc`` (``preprocessing.py:67-68``)."""
    return f"path_undersampled_{cf}_{acc}"


def sampler_order(n: int, seed: int, num_samples: int | None) -> list[int]:
    """Serving order: one seeded permutation, then truncation."""
    order = np.random.default_rng(seed).permutation(n)
    if num_samples is not None:
        order = order[:num_samples]
    return [int(i) for i in order]


def read_metadata(metadata_path: str | pathlib.Path) -> list[dict]:
    with open(metadata_path, newline="") as f:
        return list(csv.DictReader(f))


def _select_rows(rows: list[dict], mri_type: str | None, max_slice_num: int | None,
                 num_samples: int | None, seed: int) -> list[dict]:
    if mri_type:
        rows = [r for r in rows if r["mri_type"] == mri_type]
    if max_slice_num is not None:
        rows = [r for r in rows if int(r["slice_num"]) <= max_slice_num]
    if num_samples is not None and num_samples < len(rows):
        idx = np.random.default_rng(seed).choice(len(rows), size=num_samples,
                                                 replace=False)
        rows = [rows[i] for i in sorted(idx)]
    return rows


@dataclass
class SlicePair:
    slice_id: str
    fully_sampled: np.ndarray
    undersampled: np.ndarray


class MRISampler:
    """Shuffle the selected slices once (seed 42) and serve them in order.
    ``test_files`` keeps only slices whose ``stem`` or ``slice_id`` is
    listed."""

    def __init__(self, metadata_path: str | pathlib.Path,
                 center_fraction: float = 0.05, acceleration: int = 6,
                 mri_type: str | None = "Flair", max_slice_num: int | None = 10,
                 num_samples: int | None = None, seed: int = 42,
                 test_files: list[str] | None = None):
        self.undersampled_col = undersample_column(center_fraction, acceleration)
        rows = _select_rows(read_metadata(metadata_path), mri_type,
                            max_slice_num, None, seed)
        if test_files:
            wanted = set(test_files)
            rows = [r for r in rows
                    if r.get("stem") in wanted or r.get("slice_id") in wanted]
        if not rows:
            raise ValueError(f"No slices selected from {metadata_path}")
        self.rows = [rows[i] for i in sampler_order(len(rows), seed, num_samples)]
        self._counter = 0

    def __len__(self) -> int:
        return len(self.rows)

    def next_sample(self) -> SlicePair:
        row = self.rows[self._counter % len(self.rows)]
        self._counter += 1
        return SlicePair(
            slice_id=row["slice_id"],
            fully_sampled=np.load(row["path_fullysampled"]).astype(np.float32),
            undersampled=np.load(row[self.undersampled_col]).astype(np.float32),
        )

    def shard(self, index: int, count: int) -> "MRISampler":
        """Every ``count``-th slice from ``index``, counter reset."""
        other = copy.copy(self)
        other.rows = self.rows[index::count]
        other._counter = 0
        return other
