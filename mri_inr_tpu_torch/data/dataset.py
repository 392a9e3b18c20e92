"""Host-side datasets over preprocessed slices (counterpart of
``mri_inr_tpu/data/dataset.py``).

``MRIDataset`` reads ``metadata.csv``, keeps the selected rows (MRI type,
``slice_num <= max_slice_num``, optional seeded file subset), tiles every
slice into overlapping outer patches once and serves (fully-sampled,
undersampled) patch batches in the JAX package's order:
:func:`epoch_index_batches` is the one definition of an epoch's batch
composition. ``MRISampler`` shuffles the selected rows once with
``default_rng(42).permutation`` and serves whole slices in that order.
``MRIDatasetLowMemory`` (``data.low_memory``) holds per-slice patch counts
only and tiles slices per batch, through a small LRU. Everything here is
numpy; the trainer and the evaluation move data to the device.
"""

from __future__ import annotations

import copy
import csv
import pathlib
import queue
import threading
from dataclasses import dataclass

import numpy as np

from mri_inr_tpu_torch import native

BLACK_PATCH_THRESHOLD = 1e-10


def undersample_column(cf: float, acc: int) -> str:
    """Metadata column of the slices undersampled with centre fraction
    ``cf`` and acceleration ``acc`` (``preprocessing.py:67-68``)."""
    return f"path_undersampled_{cf}_{acc}"


def tile_image_np(image: np.ndarray, outer_patch_size: int,
                  inner_patch_size: int) -> tuple[np.ndarray, tuple[int, int]]:
    """Host-side twin of :func:`mri_inr_tpu_torch.ops.tiling.image_to_patches`.
    Returns (patches (nv*nh, P, P), (nv, nh))."""
    return native.tile_image(image, outer_patch_size, inner_patch_size)


def prefetch_iter(iterable, depth: int = 2):
    """Run an iterator in a background thread with a bounded queue, so batch
    assembly overlaps device compute. An exception in the producer is raised
    in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()

    def producer():
        try:
            for item in iterable:
                q.put(item)
            q.put(sentinel)
        except BaseException as exc:  # handed to the consumer, which raises it
            q.put(exc)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def epoch_index_batches(n: int, batch_size: int, seed: int,
                        shuffle: bool = True) -> list[np.ndarray]:
    """The one definition of an epoch's batch composition, shared by
    ``MRIDataset.batches`` and the trainer's device-resident epoch: shuffled
    order (``default_rng(seed).shuffle``), ceil(n / batch) batches, the
    trailing partial batch wrapped with indices from the epoch's start so
    every batch has exactly ``batch_size`` rows. ``n == 0`` gives no
    batches."""
    if n <= 0:
        return []
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    num_batches = max(1, -(-n // batch_size))
    batches = []
    for b in range(num_batches):
        idx = order[b * batch_size : (b + 1) * batch_size]
        if len(idx) < batch_size:
            idx = np.concatenate([idx, np.resize(order, batch_size - len(idx))])
        batches.append(idx)
    return batches


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


def _load_pair(row: dict, undersampled_col: str) -> SlicePair:
    return SlicePair(
        slice_id=row["slice_id"],
        fully_sampled=np.load(row["path_fullysampled"]).astype(np.float32),
        undersampled=np.load(row[undersampled_col]).astype(np.float32),
    )


class MRIDataset:
    """Eagerly tiled training dataset of (fully-sampled, undersampled)
    outer-patch pairs."""

    def __init__(self, metadata_path: str | pathlib.Path,
                 center_fraction: float = 0.05, acceleration: int = 6,
                 mri_type: str | None = "Flair", max_slice_num: int | None = 10,
                 num_samples: int | None = None, seed: int = 31415,
                 outer_patch_size: int = 32, inner_patch_size: int = 16,
                 filter_black: bool = False):
        self.outer_patch_size = outer_patch_size
        self.inner_patch_size = inner_patch_size
        self.undersampled_col = undersample_column(center_fraction, acceleration)
        rows = _select_rows(read_metadata(metadata_path), mri_type, max_slice_num,
                            num_samples, seed)
        if not rows:
            raise ValueError(f"No slices selected from {metadata_path}")
        self.rows = rows

        fully, under = [], []
        for row in rows:
            pair = _load_pair(row, self.undersampled_col)
            fully.append(tile_image_np(pair.fully_sampled, outer_patch_size,
                                       inner_patch_size)[0])
            under.append(tile_image_np(pair.undersampled, outer_patch_size,
                                       inner_patch_size)[0])
        self.fully_tiles = np.concatenate(fully)
        self.under_tiles = np.concatenate(under)

        if filter_black:
            keep = native.patch_means(self.fully_tiles) >= BLACK_PATCH_THRESHOLD
            self.fully_tiles = self.fully_tiles[keep]
            self.under_tiles = self.under_tiles[keep]

    def __len__(self) -> int:
        return self.fully_tiles.shape[0]

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        return self.fully_tiles[idx], self.under_tiles[idx]

    def batches(self, batch_size: int, seed: int, shuffle: bool = True,
                prefetch: int = 0):
        """Yield (fully, under) batches of exactly ``batch_size`` rows (the
        trailing remainder is wrapped around). ``prefetch > 0`` assembles
        batches in a background thread, ``prefetch`` deep."""

        def generate():
            for idx in epoch_index_batches(len(self), batch_size, seed, shuffle):
                yield native.gather_pairs(self.fully_tiles, self.under_tiles, idx)

        if prefetch > 0:
            return prefetch_iter(generate(), depth=prefetch)
        return generate()

    def get_slice(self, index: int) -> SlicePair:
        return _load_pair(self.rows[index % len(self.rows)], self.undersampled_col)

    def get_random_slice(self, rng: np.random.Generator | None = None) -> SlicePair:
        rng = rng or np.random.default_rng()
        return self.get_slice(int(rng.integers(len(self.rows))))

    def write_manifest(self, path: str | pathlib.Path) -> None:
        """Write the manifest of the files used (``processed_files.txt``)."""
        lines = [r["path_fullysampled"] for r in self.rows]
        pathlib.Path(path).write_text("\n".join(lines) + "\n")


class MRIDatasetLowMemory:
    """The low-memory dataset: row metadata and per-slice patch counts only;
    slices are loaded, tiled and gathered per batch, with an LRU of the last
    ``cache_slices`` tiled slices. The same interface as
    :class:`MRIDataset` except ``fully_tiles`` / ``under_tiles``, which it
    does not hold (so the trainer runs its epochs step by step).

    Without ``filter_black`` the counts come from the metadata's height and
    width (no file read); with it each fully sampled slice is tiled once at
    start-up and its kept-patch indices are stored."""

    def __init__(self, metadata_path: str | pathlib.Path,
                 center_fraction: float = 0.05, acceleration: int = 6,
                 mri_type: str | None = "Flair", max_slice_num: int | None = 10,
                 num_samples: int | None = None, seed: int = 31415,
                 outer_patch_size: int = 32, inner_patch_size: int = 16,
                 cache_slices: int = 16, filter_black: bool = False):
        self.outer_patch_size = outer_patch_size
        self.inner_patch_size = inner_patch_size
        self.undersampled_col = undersample_column(center_fraction, acceleration)
        rows = _select_rows(read_metadata(metadata_path), mri_type, max_slice_num,
                            num_samples, seed)
        if not rows:
            raise ValueError(f"No slices selected from {metadata_path}")
        self.rows = rows
        self.cache_slices = cache_slices
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self.filter_black = filter_black
        self._keep: list[np.ndarray | None] = [None] * len(rows)
        counts = []
        for i, row in enumerate(rows):
            if filter_black:
                img = np.load(row["path_fullysampled"]).astype(np.float32)
                tiles, _ = tile_image_np(img, outer_patch_size, inner_patch_size)
                keep = np.flatnonzero(native.patch_means(tiles) >= BLACK_PATCH_THRESHOLD)
                self._keep[i] = keep
                counts.append(len(keep))
            else:
                nv = -(-int(row["height"]) // inner_patch_size)
                nh = -(-int(row["width"]) // inner_patch_size)
                counts.append(nv * nh)
        self._offsets = np.concatenate([[0], np.cumsum(counts)])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def _tiles_for(self, slice_idx: int) -> tuple[np.ndarray, np.ndarray]:
        hit = self._cache.pop(slice_idx, None)
        if hit is None:
            pair = _load_pair(self.rows[slice_idx], self.undersampled_col)
            hit = tuple(tile_image_np(img, self.outer_patch_size, self.inner_patch_size)[0]
                        for img in (pair.fully_sampled, pair.undersampled))
        self._cache[slice_idx] = hit  # (re)inserted as the most recent
        while len(self._cache) > self.cache_slices:
            self._cache.pop(next(iter(self._cache)))
        return hit

    def _kept_tiles_for(self, slice_idx: int) -> tuple[np.ndarray, np.ndarray]:
        f, u = self._tiles_for(slice_idx)
        keep = self._keep[slice_idx]
        if keep is not None:
            f, u = f[keep], u[keep]
        return f, u

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        slice_idx = int(np.searchsorted(self._offsets, idx, "right") - 1)
        f, u = self._kept_tiles_for(slice_idx)
        local = idx - int(self._offsets[slice_idx])
        return f[local], u[local]

    def batches(self, batch_size: int, seed: int, shuffle: bool = True,
                prefetch: int = 0):
        """Batches of exactly ``batch_size`` rows, ceil(n / batch) of them,
        the last wrapped with patches from the epoch's start. Shuffling is
        slice-major (``default_rng(seed).shuffle`` of the slices, a slice's
        patches kept together), so a batch touches few files; with
        ``shuffle=False`` the epoch is :class:`MRIDataset`'s."""

        def generate():
            if len(self) == 0:
                return
            order = np.arange(len(self.rows))
            if shuffle:
                np.random.default_rng(seed).shuffle(order)
            num_batches = max(1, -(-len(self) // batch_size))
            emitted, have = 0, 0
            buf_f, buf_u = [], []
            while emitted < num_batches:
                for slice_idx in order:
                    if have >= batch_size or emitted >= num_batches:
                        break
                    f, u = self._kept_tiles_for(int(slice_idx))
                    buf_f.append(f)
                    buf_u.append(u)
                    have += f.shape[0]
                    while have >= batch_size and emitted < num_batches:
                        cat_f, cat_u = np.concatenate(buf_f), np.concatenate(buf_u)
                        yield cat_f[:batch_size], cat_u[:batch_size]
                        emitted += 1
                        buf_f, buf_u = [cat_f[batch_size:]], [cat_u[batch_size:]]
                        have = buf_f[0].shape[0]

        if prefetch > 0:
            return prefetch_iter(generate(), depth=prefetch)
        return generate()

    get_slice = MRIDataset.get_slice
    get_random_slice = MRIDataset.get_random_slice
    write_manifest = MRIDataset.write_manifest


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
        return _load_pair(row, self.undersampled_col)

    def shard(self, index: int, count: int) -> "MRISampler":
        """Every ``count``-th slice from ``index``, counter reset."""
        other = copy.copy(self)
        other.rows = self.rows[index::count]
        other._counter = 0
        return other
