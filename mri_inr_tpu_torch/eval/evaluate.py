"""Slice reconstruction and the metric sweep (counterpart of
``mri_inr_tpu/eval/evaluate.py``).

Per slice: tile the undersampled image, classify black patches (masked,
not filtered: a masked patch still counts in the fold's denominator), run
the forward, weighted-fold the reconstruction, plain-fold the fully-sampled
and undersampled tiles for reference images, and score PSNR / SSIM / NRMSE
of fully-sampled vs reconstruction. Artifacts: ``metrics_error.csv``
(FILENAME,PSNR,SSIM,NRMSE) and a mean/std/min/max ``metrics_summary.txt``.

One slice at a time (``SliceReconstructor.__call__``, the visual pass) pads
its patch batch to a multiple of ``patch_bucket``, as the JAX package's
per-slice program does. The metric sweeps score a stack of K slices of one
shape batched (``SliceReconstructor.metrics_stack``, the counterpart of the
JAX package's ``_build_many``): one forward for all K * n patches, no
padding, then the masks, the folds and the metrics of the K slices at once;
a stack of more than :data:`PIECE_PATCHES` patches runs in pieces of whole
slices, one forward a piece.

Three sweeps give the same rows: :func:`evaluate_files` (one slice at a
time, also returns the images), :func:`evaluate_files_chunked` (``chunk``
slices a stack, one copy back per chunk) and :func:`evaluate_files_device`
(every shape group uploaded once and scored as one stack). ``--shard I:N``
runs write ``metrics_shard*/`` directories that :func:`merge_shard_csvs`
combines; ranks that each swept their shard combine their rows with
:func:`gather_shard_results`.

``SliceReconstructor(halo=True, group=...)`` is the large-field-of-view
mode: the ranks split each slice's patch rows, not the files; each runs
the forward on its band of rows and folds it with the halo exchange of
``parallel/halo_fold.py``, and the bands are gathered on every rank for
the metrics. A slice whose patch-row count the ranks do not divide is
reconstructed whole on every rank, as the JAX package falls back.

Spans (``utils/profiling.span``): :func:`evaluate_files_device`'s
``mri.sweep.stage``, ``mri.sweep.dispatch`` and ``mri.sweep.fetch`` (its
``timings``).

Not carried over: the device sweep's padding to a bucket of slices and its
``steady_probe``, which exist to reuse compiled TPU programs; PyTorch
compiles nothing per shape.
"""

from __future__ import annotations

import csv
import pathlib
import re
import time
from dataclasses import dataclass

import numpy as np
import torch

from mri_inr_tpu_torch.eval import metrics as metrics_mod
from mri_inr_tpu_torch.ops import tiling
from mri_inr_tpu_torch.parallel import distributed, halo_fold
from mri_inr_tpu_torch.utils.device import resolve_device
from mri_inr_tpu_torch.utils.profiling import span

#: the most patches one forward of a metric sweep takes: a stack runs in
#: pieces of whole slices up to this many (81 slices of 320 x 320). The
#: card holds a few tens of KB a patch in flight (the tile, the encoder's
#: bf16 maps, the modulations, the output), about 1 GB at this count.
PIECE_PATCHES = 32768


def _bucket(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class SliceResult:
    slice_id: str
    psnr: float
    ssim: float
    nrmse: float


class SliceReconstructor:
    """Slice -> (reconstruction, fully, under, metrics).

    ``apply_fn``: (N, outer, outer) tiles -> (N, siren, siren), e.g. from
    :func:`~mri_inr_tpu_torch.ops.siren_kernel.make_apply_fn`. ``device``
    (default ``cuda``) is where images are placed and the pipeline runs.
    ``halo=True`` with a process ``group`` of N > 1 ranks: every rank is
    given the same slices and reconstructs its ``nv / N`` patch rows of
    each, through the halo fold (module docstring); every rank returns the
    same images and metrics."""

    def __init__(self, apply_fn, outer_patch_size: int = 32,
                 inner_patch_size: int = 16, siren_patch_size: int = 24,
                 patch_bucket: int = 512,
                 device: str | torch.device | None = None, halo: bool = False,
                 group=None):
        self.apply_fn = apply_fn
        self.outer = outer_patch_size
        self.inner = inner_patch_size
        self.siren = siren_patch_size
        self.patch_bucket = patch_bucket
        self.device = resolve_device(device)
        self.halo, self.group = halo, group
        self.rank, self.world = distributed.rank_world(group)

    def _halo_split(self, grid: tuple[int, int]) -> bool:
        return self.halo and self.world > 1 and grid[0] % self.world == 0

    def _reconstruct(self, patches: torch.Tensor, valid: torch.Tensor,
                     grid: tuple[int, int], bucket: int = 1) -> torch.Tensor:
        """(K, n, outer, outer) tiles and their (K, n) mask -> the (K, H', W')
        weighted folds of the masked forward, one forward over the patches
        (padded with zero tiles to a multiple of ``bucket``); in halo mode
        over this rank's patch rows, then the halo fold and the bands
        gathered."""
        outer, inner, siren = self.outer, self.inner, self.siren
        k = patches.shape[0]
        halo = self._halo_split(grid)
        if halo:
            patches = halo_fold.local_patch_rows(patches, grid, self.rank, self.world)
            valid = halo_fold.local_patch_rows(valid, grid, self.rank, self.world, dim=-1)
        flat = patches.reshape(-1, outer, outer)
        rows = flat.shape[0]
        if _bucket(rows, bucket) > rows:
            flat = torch.cat([flat, flat.new_zeros((_bucket(rows, bucket) - rows, outer, outer))])
        pred = self.apply_fn(flat)[:rows].float()
        pred = tiling.mask_black_patches(pred.reshape(k, -1, siren, siren), valid)
        if not halo:
            return tiling.patches_to_image_weighted_average(pred, grid, siren, inner)
        band = halo_fold.sharded_patches_to_image_weighted_average(pred, grid, siren, inner,
                                                                   self.group)
        return halo_fold.gather_bands(band, self.group)

    def _run(self, fully_img: torch.Tensor, under_img: torch.Tensor,
             metrics_only: bool):
        """``metrics_only`` scores against ``fully_img`` itself: the plain
        fold of unfiltered patches reproduces the image (every overlapping
        copy holds the same value), so the sweep skips both reference
        folds."""
        outer, inner = self.outer, self.inner
        grid = tiling.grid_shape(*under_img.shape, inner)
        under_patches = tiling.image_to_patches(under_img, outer, inner)
        valid = tiling.classify_black_patches(under_patches)
        recon = self._reconstruct(under_patches[None], valid[None], grid,
                                  self.patch_bucket)[0]
        if metrics_only:
            return metrics_mod.image_metrics(fully_img.float(), recon)
        fully = tiling.patches_to_image(
            tiling.image_to_patches(fully_img, outer, inner), grid, outer, inner)
        under = tiling.patches_to_image(under_patches, grid, outer, inner)
        return recon, fully, under, metrics_mod.image_metrics(fully, recon)

    @torch.no_grad()
    def __call__(self, fully_img: np.ndarray, under_img: np.ndarray):
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
        return self._run(as_t(fully_img), as_t(under_img), metrics_only=False)

    @torch.no_grad()
    def metrics_stack(self, fully_stack: torch.Tensor,
                      under_stack: torch.Tensor) -> torch.Tensor:
        """(K, H, W) stacks on the device -> a device (3, K) tensor of
        (psnr, ssim, nrmse) rows, in the stack's order; no host
        synchronisation. The slices run batched, in pieces of whole slices
        of at most :data:`PIECE_PATCHES` patches (one slice at least): one
        forward a piece over its patches, unpadded, then its masks, folds
        and metrics, as :meth:`_run` does for one slice with
        ``metrics_only``."""
        outer, inner = self.outer, self.inner
        k, height, width = under_stack.shape
        grid = tiling.grid_shape(height, width, inner)
        n = grid[0] * grid[1]
        per = max(1, PIECE_PATCHES // n)
        cols = []
        for start in range(0, k, per):
            fully, under = fully_stack[start : start + per], under_stack[start : start + per]
            patches = tiling.image_to_patches(under, outer, inner)  # (k', n, outer, outer)
            recon = self._reconstruct(patches, tiling.classify_black_patches(patches), grid)
            m = metrics_mod.image_metrics(fully.float(), recon)
            cols.append(torch.stack([m["psnr"], m["ssim"], m["nrmse"]]))
        return torch.cat(cols, dim=1)

    def metrics_chunk_async(self, fully_stack: np.ndarray,
                            under_stack: np.ndarray) -> torch.Tensor:
        """(K, H, W) host stacks -> a device (3, K) tensor of (psnr, ssim,
        nrmse) rows. Nothing here waits for the device: on the card the work
        is enqueued on PyTorch's stream and the host goes on to stack the
        next chunk; fetch with ``.cpu()`` when the values are needed."""
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)
        return self.metrics_stack(up(fully_stack), up(under_stack))

    def metrics_chunk(self, fully_stack: np.ndarray, under_stack: np.ndarray):
        """(K, H, W) host stacks -> (psnr, ssim, nrmse) numpy arrays of length
        K (blocking; one copy back)."""
        out = self.metrics_chunk_async(fully_stack, under_stack).cpu().numpy()
        return out[0], out[1], out[2]


def evaluate_files(reconstructor: SliceReconstructor, sampler,
                   num_samples: int | None = None, progress_every: int = 100,
                   log=print) -> list[SliceResult]:
    """Score ``num_samples`` slices (default: the whole sampler), one at a
    time."""
    total = len(sampler) if num_samples is None else min(num_samples, len(sampler))
    results = []
    for i in range(total):
        pair = sampler.next_sample()
        _, _, _, m = reconstructor(pair.fully_sampled, pair.undersampled)
        vals = torch.stack([m["psnr"], m["ssim"], m["nrmse"]]).cpu().numpy()
        results.append(SliceResult(pair.slice_id, float(vals[0]), float(vals[1]),
                                   float(vals[2])))
        if progress_every and (i + 1) % progress_every == 0:
            log(f"evaluated {i + 1}/{total} slices")
    return results


def evaluate_files_chunked(reconstructor: SliceReconstructor, sampler,
                           num_samples: int | None = None, chunk: int = 8,
                           progress_every: int = 100, log=print,
                           inflight: int = 4) -> list[SliceResult]:
    """Metric sweep with ``chunk`` slices per upload and one (3, K) copy back
    per chunk (metrics only; the visual pass keeps the per-slice path).
    Slices are grouped by image shape; a trailing partial chunk is padded by
    repeating its last slice and trimmed. The rows are those of
    :func:`evaluate_files`, in the sampler's order.

    Up to ``inflight`` chunks are enqueued before the oldest result is
    fetched. The JAX package needs that to overlap host stacking with device
    compute; PyTorch's stream is asynchronous already, so here the argument
    only bounds how many chunks' stacks are alive on the device."""
    total = len(sampler) if num_samples is None else min(num_samples, len(sampler))
    pairs = [sampler.next_sample() for _ in range(total)]
    results: dict[int, SliceResult] = {}
    by_shape: dict[tuple[int, int], list[int]] = {}
    for i, p in enumerate(pairs):
        by_shape.setdefault(p.fully_sampled.shape, []).append(i)

    pending: list[tuple[list[int], torch.Tensor]] = []
    done = 0
    t_start = time.perf_counter()

    def drain_one():
        nonlocal done
        grp, fut = pending.pop(0)
        vals = fut.cpu().numpy()
        for j, i in enumerate(grp):
            results[i] = SliceResult(pairs[i].slice_id, float(vals[0, j]),
                                     float(vals[1, j]), float(vals[2, j]))
        done += len(grp)
        if progress_every and done % progress_every < len(grp):
            dt = time.perf_counter() - t_start
            log(f"evaluated {done}/{total} slices ({dt:.1f}s, {done / dt:.1f} slices/s)")

    for idxs in by_shape.values():
        for start in range(0, len(idxs), chunk):
            grp = idxs[start : start + chunk]
            padded = grp + [grp[-1]] * (chunk - len(grp))
            fully = np.stack([pairs[i].fully_sampled for i in padded])
            under = np.stack([pairs[i].undersampled for i in padded])
            pending.append((grp, reconstructor.metrics_chunk_async(fully, under)))
            while len(pending) >= max(1, inflight):
                drain_one()
    while pending:
        drain_one()
    return [results[i] for i in range(total)]


def evaluate_files_device(reconstructor: SliceReconstructor, sampler,
                          num_samples: int | None = None, log=print,
                          ) -> tuple[list[SliceResult], dict[str, float]]:
    """Device-resident sweep: the slices are stacked per image shape and
    uploaded once, every slice is scored on the device, and each shape
    group's (3, K) metrics come back in one copy (the one synchronisation of
    the group); a group runs batched (:meth:`SliceReconstructor.metrics_stack`:
    one forward per piece of :data:`PIECE_PATCHES` patches). A sampler with
    ``device_stacks`` (:class:`~mri_inr_tpu_torch.data.online.OnlineSampler`)
    gives one group whose stacks are on the device already: no image data
    crosses from the host. The rows are those of :func:`evaluate_files`, in
    the sampler's order.

    Returns ``(results, timings)``: ``stage_seconds`` (load, stack, upload),
    ``dispatch_seconds`` (enqueueing every group's work) and
    ``execute_fetch_seconds`` (waiting for the device and copying back)."""
    total = len(sampler) if num_samples is None else min(num_samples, len(sampler))
    device = reconstructor.device

    with span("mri.sweep.stage") as stage:
        if hasattr(sampler, "device_stacks"):
            slice_ids, fully, under = sampler.device_stacks(total)
            groups = [(list(range(total)), fully.to(device), under.to(device))]
        else:
            pairs = [sampler.next_sample() for _ in range(total)]
            slice_ids = [p.slice_id for p in pairs]
            by_shape: dict[tuple[int, int], list[int]] = {}
            for i, p in enumerate(pairs):
                by_shape.setdefault(p.fully_sampled.shape, []).append(i)
            groups = [
                (idxs,
                 torch.from_numpy(np.stack([pairs[i].fully_sampled for i in idxs])).to(device),
                 torch.from_numpy(np.stack([pairs[i].undersampled for i in idxs])).to(device))
                for idxs in by_shape.values()
            ]
        _sync(device)

    with span("mri.sweep.dispatch") as dispatch:
        futs = [(idxs, reconstructor.metrics_stack(fully, under))
                for idxs, fully, under in groups]

    with span("mri.sweep.fetch") as fetch:
        rows: dict[int, SliceResult] = {}
        for idxs, fut in futs:
            vals = fut.cpu().numpy()
            for j, i in enumerate(idxs):
                rows[i] = SliceResult(slice_ids[i], float(vals[0, j]), float(vals[1, j]),
                                      float(vals[2, j]))
        results = [rows[i] for i in range(total)]

    timings = {
        "stage_seconds": stage.seconds,
        "dispatch_seconds": dispatch.seconds,
        "execute_fetch_seconds": fetch.seconds,
    }
    log(f"device sweep: {total} slices staged in {stage.seconds:.3f}s, "
        f"dispatched in {dispatch.seconds:.3f}s, executed+fetched in {fetch.seconds:.3f}s")
    return results, timings


def read_metrics_csv(path: str | pathlib.Path) -> list[SliceResult]:
    with open(path, newline="") as f:
        return [SliceResult(row["FILENAME"], float(row["PSNR"]), float(row["SSIM"]),
                            float(row["NRMSE"]))
                for row in csv.DictReader(f)]


def gather_shard_results(results: list[SliceResult]) -> list[SliceResult]:
    """Every rank's rows of a sweep over the ranks (counterpart of the JAX
    package's ``gather_shard_results``): counts may differ, every rank
    returns the combined list, rank 0's rows first. Rank ``r`` of ``N``
    scores the sampler's shard ``r:N``, so the list is the one
    :func:`merge_shard_csvs` reads from ``--shard r:N`` runs (it reads the
    directories in shard order). One process: identity."""
    return [r for rows in distributed.all_gather_host_values(list(results)) for r in rows]


def merge_shard_csvs(output_dir: str | pathlib.Path) -> list[SliceResult]:
    """Merge the ``metrics_shardI_N/metrics_error.csv`` files written by
    separate ``--shard I:N`` runs into one result list, in shard order I =
    0 .. N-1. Directories of more than one N, or a missing I, raise."""
    output_dir = pathlib.Path(output_dir)
    shard_csvs = list(output_dir.glob("metrics_shard*/metrics_error.csv"))
    if not shard_csvs:
        raise FileNotFoundError(f"no metrics_shard*/metrics_error.csv under {output_dir}")
    shards = {}
    for p in shard_csvs:
        m = re.fullmatch(r"metrics_shard(\d+)_(\d+)", p.parent.name)
        if m is None:
            raise ValueError(f"{p.parent} is not named metrics_shardI_N (--shard I:N)")
        shards[int(m[1]), int(m[2])] = p
    counts = sorted({n for _, n in shards})
    if len(counts) > 1:
        raise ValueError(f"shard directories of {counts} shards under {output_dir}: "
                         f"{sorted(p.parent.name for p in shard_csvs)}; remove the stale ones")
    n = counts[0]
    missing = [i for i in range(n) if (i, n) not in shards]
    beyond = sorted(i for i, _ in shards if i >= n)
    if missing or beyond:
        raise ValueError(f"shards of {n}: missing {missing}, out of range {beyond}, under "
                         f"{output_dir}: {sorted(p.parent.name for p in shard_csvs)}")
    results: list[SliceResult] = []
    for i in range(n):
        results.extend(read_metrics_csv(shards[i, n]))
    return results


def write_metrics_artifacts(results: list[SliceResult],
                            output_dir: str | pathlib.Path) -> dict[str, dict[str, float]]:
    """Write ``metrics_error.csv`` + ``metrics_summary.txt``; return the
    summary statistics."""
    output_dir = pathlib.Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    with open(output_dir / "metrics_error.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["FILENAME", "PSNR", "SSIM", "NRMSE"])
        for r in results:
            writer.writerow([r.slice_id, r.psnr, r.ssim, r.nrmse])

    summary, lines = {}, []
    for name, attr in (("PSNR", "psnr"), ("SSIM", "ssim"), ("NRMSE", "nrmse")):
        arr = np.array([getattr(r, attr) for r in results])
        stats = {"mean": float(arr.mean()), "std": float(arr.std()),
                 "min": float(arr.min()), "max": float(arr.max())}
        summary[name] = stats
        lines.append(f"{name}: mean={stats['mean']:.4f} std={stats['std']:.4f} "
                     f"min={stats['min']:.4f} max={stats['max']:.4f}")
    (output_dir / "metrics_summary.txt").write_text("\n".join(lines) + "\n")
    return summary
