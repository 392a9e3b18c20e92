"""Online k-space pipeline (counterpart of ``mri_inr_tpu/data/online.py``):
mask -> centred inverse DFT -> magnitude -> volume min-max -> tiles, on the
device, once per epoch, with no ``.npy`` files in between.

The raw k-space volumes go to the device once, as one ``(V, S, H, W, 2)``
float32 tensor of real/imag pairs (read by 8 threads, packed into one
preallocated host buffer, pinned when the device is the card, and uploaded
in one copy). Each materialisation draws one ``(W,)`` column mask per volume
on the host, uploads the ``(V, W)`` masks, multiplies them in, and
reconstructs every slice of every volume in one call: the DFT kernel
(:func:`mri_inr_tpu_torch.ops.fft_kernel.reconstruct_magnitude_ri_dft`) on
the card, ``torch.fft`` (:func:`mri_inr_tpu_torch.data.kspace.
reconstruct_magnitude_ri`) on the CPU, as the offline preprocessing does.
Then each volume is min-max normalised over all its slices (a constant
volume gives zeros, not NaN), the selected slices are taken and tiled.

- **offline parity**: with ``remask_each_epoch=False`` each volume's mask
  is drawn under the key ``key(_stable_seed(stem, cf, acc))``, the draw of
  :func:`~mri_inr_tpu_torch.data.preprocessing.process_kspace_volume`, so
  the tiles equal those of :class:`~mri_inr_tpu_torch.data.dataset.
  MRIDataset` over the offline pipeline's slices, and on the card both come
  from the same kernel;
- **remasking** (``remask_each_epoch=True``): epoch ``e`` draws under
  ``fold_in(key, e)``, epoch 0 included, so epoch 0 is not the offline
  mask. Both draws are the JAX package's, bit for bit
  (:mod:`mri_inr_tpu_torch.utils.jax_random`); ``mask_fn(volume, epoch) ->
  (W,) bool`` replaces the draw.

The fully sampled tiles are made once. The undersampled tiles of each mask
epoch are written into one persistent device buffer, so every epoch hands
the trainer the same tensors (a CUDA graph of the epoch reads them by
address). Eval consumers read a separate stash of epoch-0 images
(:meth:`OnlineKspaceDataset.device_image_stacks`), which remask training
never overwrites.

Spans (``utils/profiling.span``): ``mri.data.materialize`` around
:meth:`OnlineKspaceDataset.materialize`, with ``mri.data.images`` (mask,
DFT, normalise), ``mri.data.masks`` (the host draw) inside it and
``mri.data.tiles``.

``h5py`` is imported by the ``.h5`` constructor only;
:meth:`OnlineKspaceDataset.from_volumes` takes in-memory complex volumes.
"""

from __future__ import annotations

import copy
import pathlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mri_inr_tpu_torch.data import kspace
from mri_inr_tpu_torch.data.dataset import (SlicePair, epoch_index_batches, prefetch_iter,
                                            sampler_order)
from mri_inr_tpu_torch.data.preprocessing import _stable_seed, get_mri_type, load_h5
from mri_inr_tpu_torch.ops import fft_kernel, tiling
from mri_inr_tpu_torch.utils import jax_random
from mri_inr_tpu_torch.utils.device import resolve_device
from mri_inr_tpu_torch.utils.profiling import span

READ_THREADS = 8


class OnlineKspaceDataset:
    """Device-resident k-space -> (fully, under) tile pairs, materialised
    once per mask epoch. Drop-in for :class:`~mri_inr_tpu_torch.data.
    dataset.MRIDataset` in the trainer (``len``, ``materialize``,
    ``batches``, ``get_slice``, ``write_manifest``)."""

    def __init__(self, data_root: str | pathlib.Path, center_fraction: float = 0.05,
                 acceleration: int = 6, mri_type: str | None = "Flair",
                 max_slice_num: int | None = 10, num_samples: int | None = None,
                 seed: int = 31415, outer_patch_size: int = 32, inner_patch_size: int = 16,
                 remask_each_epoch: bool = True, *, device: str | torch.device | None = None,
                 mask_fn=None):
        data_root = pathlib.Path(data_root)
        paths = sorted(data_root.glob("*.h5"))
        if mri_type:
            paths = [p for p in paths if get_mri_type(p.stem) == mri_type]
        if not paths:
            raise FileNotFoundError(f"No matching .h5 volumes under {data_root}")
        # h5py releases the GIL while it reads
        with ThreadPoolExecutor(READ_THREADS) as pool:
            volumes = list(pool.map(load_h5, paths))
        self._setup([p.stem for p in paths], volumes, center_fraction, acceleration,
                    max_slice_num, num_samples, seed, outer_patch_size, inner_patch_size,
                    remask_each_epoch, device, mask_fn)

    @classmethod
    def from_volumes(cls, stems: list[str], volumes: list[np.ndarray],
                     center_fraction: float = 0.05, acceleration: int = 6,
                     max_slice_num: int | None = 10, num_samples: int | None = None,
                     seed: int = 31415, outer_patch_size: int = 32,
                     inner_patch_size: int = 16, remask_each_epoch: bool = True, *,
                     device: str | torch.device | None = None,
                     mask_fn=None) -> "OnlineKspaceDataset":
        """The dataset of complex ``(S, H, W)`` k-space ``volumes`` named
        ``stems`` (no file read, no ``mri_type`` filter: the caller passes
        the volumes it wants)."""
        self = cls.__new__(cls)
        self._setup(list(stems), list(volumes), center_fraction, acceleration, max_slice_num,
                    num_samples, seed, outer_patch_size, inner_patch_size, remask_each_epoch,
                    device, mask_fn)
        return self

    def _setup(self, stems, volumes, center_fraction, acceleration, max_slice_num,
               num_samples, seed, outer, inner, remask, device, mask_fn) -> None:
        self.device = resolve_device(device)
        self.cf = float(center_fraction)
        self.acc = int(acceleration)
        self.outer = outer
        self.inner = inner
        self.remask = remask
        self.mask_fn = mask_fn
        self.stems = stems
        if len(stems) != len(volumes) or not volumes:
            raise ValueError(f"{len(stems)} stems for {len(volumes)} volumes")
        shapes = {np.shape(v) for v in volumes}
        if len(shapes) != 1 or len(next(iter(shapes))) != 3:
            raise ValueError(
                "the online pipeline needs volumes of one (S, H, W) shape (one "
                f"materialisation over all of them); got {sorted(shapes)}: bucket them or "
                "preprocess offline instead")
        self._k = self._upload(volumes)  # (V, S, H, W, 2)
        nvol, nsl, h, w, _ = self._k.shape

        # The full volumes stay resident: the min-max window spans every
        # slice of a volume, as the offline pipeline normalises before
        # _select_rows filters. Then MRIDataset._select_rows' semantics:
        # the slice_num filter, then the seeded choice.
        slice_ids = [(vi, si) for vi in range(nvol) for si in range(nsl)
                     if max_slice_num is None or si <= max_slice_num]
        if num_samples is not None and num_samples < len(slice_ids):
            idx = np.random.default_rng(seed).choice(len(slice_ids), size=num_samples,
                                                     replace=False)
            slice_ids = [slice_ids[i] for i in sorted(idx)]
        self.slice_ids = slice_ids
        self._flat_idx = torch.tensor([vi * nsl + si for vi, si in slice_ids],
                                      dtype=torch.int64).to(self.device)
        self.grid = tiling.grid_shape(h, w, inner)
        self.patches_per_slice = self.grid[0] * self.grid[1]

        self._fully = self._fully_imgs = None  # mask-independent, made once
        self._under = None  # the persistent buffer of the undersampled tiles
        self._under_epoch: int | None = None
        #: the mask epochs materialised, in order (a resumed run's continue
        #: from its first epoch)
        self.mask_epochs: list[int] = []
        self._fully_imgs0 = self._under_imgs0 = None  # the epoch-0 stash for eval
        self._imgs_np = None
        self._slice_cache: dict = {}

    def _upload(self, volumes) -> torch.Tensor:
        """Pack the complex volumes as real/imag pairs into one host buffer
        (pinned for the card) and copy it to the device once."""
        shape = (len(volumes), *np.shape(volumes[0]), 2)
        pin = self.device.type == "cuda"
        host = torch.empty(shape, dtype=torch.float32, pin_memory=pin)
        buf = host.numpy()

        def pack(i):
            v = np.asarray(volumes[i])
            buf[i, ..., 0] = v.real
            buf[i, ..., 1] = v.imag

        with ThreadPoolExecutor(READ_THREADS) as pool:
            list(pool.map(pack, range(len(volumes))))
        # a synchronous copy: the host buffer is freed on return
        return host if self.device.type == "cpu" else host.to(self.device)

    # ------------------------------------------------------------------
    def masks(self, epoch: int) -> np.ndarray:
        """(V, W) bool column masks of mask epoch ``epoch`` (0 whenever
        remasking is off)."""
        e = int(epoch) if self.remask else 0
        w = self._k.shape[3]
        rows = []
        with span("mri.data.masks"):
            for vi, stem in enumerate(self.stems):
                if self.mask_fn is not None:
                    rows.append(np.asarray(self.mask_fn(vi, e), bool))
                    continue
                key = jax_random.key(_stable_seed(stem, self.cf, self.acc))
                if self.remask:
                    key = jax_random.fold_in(key, e)
                rows.append(kspace.random_mask(key, w, self.cf, self.acc))
            return np.stack(rows)

    @torch.no_grad()
    def _images(self, epoch: int | None) -> torch.Tensor:
        """(N, H, W) normalised images of the selected slices: fully
        sampled (``epoch`` None) or under mask epoch ``epoch``. One
        reconstruction call over all V*S slices."""
        with span("mri.data.images"):
            k = self._k
            nvol, nsl, h, w, _ = k.shape
            if epoch is not None:
                m = torch.as_tensor(self.masks(epoch), device=self.device)
                k = k * m[:, None, None, :, None].to(k.dtype)
            recon = (fft_kernel.reconstruct_magnitude_ri_dft if self.device.type == "cuda"
                     else kspace.reconstruct_magnitude_ri)
            imgs = recon(k)  # (V, S, H, W)
            del k
            lo = imgs.amin(dim=(1, 2, 3), keepdim=True)
            hi = imgs.amax(dim=(1, 2, 3), keepdim=True)
            # a constant (zero-padded, corrupt) volume has hi == lo: zeros, not NaN
            imgs = torch.where(hi > lo, (imgs - lo) / (hi - lo), 0.0)
            return imgs.reshape(nvol * nsl, h, w).index_select(0, self._flat_idx)

    def _tiles(self, imgs: torch.Tensor) -> torch.Tensor:
        return tiling.image_to_patches(imgs, self.outer, self.inner).reshape(
            -1, self.outer, self.outer)

    def __len__(self) -> int:
        return len(self.slice_ids) * self.patches_per_slice

    @torch.no_grad()
    def materialize(self, epoch: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(fully, under) tiles ``(N*P, outer, outer)`` on the device for
        epoch ``epoch``'s masks (fresh per epoch with remasking, fixed
        otherwise). Both are the same tensors every call: ``under`` is
        rewritten in place, on the current stream, when the mask epoch
        changes."""
        with span("mri.data.materialize"):
            if self._fully is None:
                self._fully_imgs = self._images(None)
                with span("mri.data.tiles"):
                    self._fully = self._tiles(self._fully_imgs)
            e = int(epoch) if self.remask else 0
            if self._under_epoch != e:
                # the epoch-e images are dropped: eval consumers read the
                # epoch-0 stash, never a remask epoch's
                imgs = self._images(e)
                with span("mri.data.tiles"):
                    tiles = self._tiles(imgs)
                    del imgs
                    if self._under is None:
                        self._under = tiles.contiguous()
                    else:
                        self._under.copy_(tiles)
                self._under_epoch = e
                self.mask_epochs.append(e)
            return self._fully, self._under

    def batches(self, batch_size: int, seed: int, shuffle: bool = True, prefetch: int = 0):
        """Host batches with :class:`MRIDataset`'s epoch semantics
        (:func:`epoch_index_batches`) over the tiles of mask epoch ``seed``
        (the trainer passes the epoch there)."""
        fully, under = (t.cpu().numpy() for t in self.materialize(seed))

        def generate():
            for idx in epoch_index_batches(fully.shape[0], batch_size, seed, shuffle):
                yield fully[idx], under[idx]

        if prefetch > 0:
            return prefetch_iter(generate(), depth=prefetch)
        return generate()

    @torch.no_grad()
    def materialize_images(self) -> None:
        """Fill the epoch-0 (fully, under) image stacks without the tile
        stacks (eval consumers). Kept apart from :meth:`materialize`'s
        per-epoch state, so remask training never leaks an epoch-e mask into
        them."""
        if self._fully_imgs0 is None:
            self._fully_imgs0 = (self._fully_imgs if self._fully_imgs is not None
                                 else self._images(None))
        if self._under_imgs0 is None:
            self._under_imgs0 = self._images(0)

    def device_image_stacks(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The (N, H, W) fully / under image stacks of epoch 0's masks, on
        the device: the device sweep's input, with no host transfer."""
        self.materialize_images()
        return self._fully_imgs0, self._under_imgs0

    def prefetch_host_images(self) -> None:
        """Copy the whole epoch-0 image stacks to the host in one transfer
        each (for a consumer that serves many slices from the host)."""
        if self._imgs_np is None:
            self.materialize_images()
            self._imgs_np = (self._fully_imgs0.cpu().numpy(), self._under_imgs0.cpu().numpy())

    def slice_id(self, index: int) -> str:
        vi, si = self.slice_ids[index]
        return f"{self.stems[vi]}_{si}"

    def get_slice(self, index: int) -> SlicePair:
        """The full (fully, under) images of slice ``index`` (epoch-0
        masks), as fresh arrays a caller may change."""
        i = index % len(self.slice_ids)
        if self._imgs_np is not None:
            fully, under = self._imgs_np[0][i], self._imgs_np[1][i]
        else:
            if i not in self._slice_cache:
                self.materialize_images()
                self._slice_cache[i] = (self._fully_imgs0[i].cpu().numpy(),
                                        self._under_imgs0[i].cpu().numpy())
            fully, under = self._slice_cache[i]
        return SlicePair(self.slice_id(i), fully.copy(), under.copy())

    def write_manifest(self, path: str | pathlib.Path) -> None:
        lines = [f"{self.slice_id(i)} (online k-space)" for i in range(len(self.slice_ids))]
        pathlib.Path(path).write_text("\n".join(lines) + "\n")


class OnlineSampler:
    """Evaluation sampler over an :class:`OnlineKspaceDataset` (the
    counterpart of :class:`~mri_inr_tpu_torch.data.dataset.MRISampler` with
    no files): whole slices of epoch-0 masks, shuffled once with the seed-42
    order both samplers share, served in turn, with the same ``shard(i, n)``.
    Build the dataset with ``remask_each_epoch=False`` for the offline
    pipeline's masks, and so its metrics."""

    def __init__(self, dataset: OnlineKspaceDataset, seed: int = 42,
                 num_samples: int | None = None, host_prefetch: bool | None = None):
        """``host_prefetch``: None copies the image stacks to the host in
        bulk when the sampler serves 64 slices or more (for the host
        sweeps); pass False for the device sweep, which reads
        :meth:`device_stacks` and never needs host copies."""
        self.dataset = dataset
        self._order = sampler_order(len(dataset.slice_ids), seed, num_samples)
        self._counter = 0
        if host_prefetch is None:
            host_prefetch = len(self._order) >= 64
        if host_prefetch:
            dataset.prefetch_host_images()

    def __len__(self) -> int:
        return len(self._order)

    def device_stacks(self, num_samples: int | None = None
                      ) -> tuple[list[str], torch.Tensor, torch.Tensor]:
        """(slice_ids, fully, under): the stacks on the device in serving
        order. Consumes the sampler as ``num_samples`` calls of
        :meth:`next_sample` would (from the current position, wrapping, the
        position advanced), so a visual pass that took some slices first
        leaves the device sweep the slices a host sweep would score."""
        fully, under = self.dataset.device_image_stacks()
        n = len(self._order)
        total = n if num_samples is None else min(num_samples, n)
        order = [self._order[(self._counter + i) % n] for i in range(total)]
        self._counter += total
        idx = torch.tensor(order, dtype=torch.int64).to(fully.device)
        return ([self.dataset.slice_id(i) for i in order], fully.index_select(0, idx),
                under.index_select(0, idx))

    def next_sample(self) -> SlicePair:
        idx = self._order[self._counter % len(self._order)]
        self._counter += 1
        return self.dataset.get_slice(idx)

    def shard(self, index: int, count: int) -> "OnlineSampler":
        """Every ``count``-th slice from ``index``, counter reset."""
        other = copy.copy(self)
        other._order = self._order[index::count]
        other._counter = 0
        return other
