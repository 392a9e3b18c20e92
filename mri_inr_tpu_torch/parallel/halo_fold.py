"""The weighted overlap-add fold of a slice whose patch rows are split over
the ranks (counterpart of ``mri_inr_tpu/parallel/halo_fold.py``).

Rank ``r`` of ``N`` holds the ``nv / N`` consecutive patch rows of band
``r`` (:func:`local_patch_rows`), folds them with the vertical halo left on
(:func:`local_fold_padded`), sends the ``pad = (siren - inner) / 2`` rows
above its band to rank ``r - 1`` and those below to rank ``r + 1``, adds
what it receives from both (:func:`exchange_halos`: the edge ranks receive
nothing, which is the single-device fold's crop) and divides by its band of
the fold's denominator, a function of the geometry alone. The result is
its band of image rows, equal to the same rows of
``tiling.patches_to_image_weighted_average``; :func:`gather_bands` joins
the bands. The exchange is ``dist.batch_isend_irecv``; under gloo the bands
cross the host (gloo sends CPU tensors only).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from mri_inr_tpu_torch.ops import tiling
from mri_inr_tpu_torch.parallel import distributed, mesh

#: calls and host seconds of :func:`exchange_halos` (under gloo a call is
#: synchronous: its bands are copied to the host and back)
exchange_stats = {"calls": 0, "seconds": 0.0}


def local_patch_rows(patches: torch.Tensor, grid: tuple[int, int], rank: int,
                     world: int, dim: int = -3) -> torch.Tensor:
    """Band ``rank``'s patches of row-major (..., nv*nh, s, s) patches (the
    patch axis at ``dim``): its ``nv / world`` consecutive patch rows."""
    nv, nh = grid
    rows = mesh.check_divisible(nv, world, "patch-row grid")
    return patches.narrow(dim, rank * rows * nh, rows * nh)


def local_fold_padded(patches: torch.Tensor, nv: int, nh: int, kernel: int,
                      stride: int) -> torch.Tensor:
    """Overlap-add of a band's (..., nv*nh, kernel, kernel) patches without
    cropping the vertical halo: (..., nv*stride + 2*pad, nh*stride) with
    ``pad = (kernel - stride) // 2``; patch (r, c) covers canvas rows
    ``r*stride .. + kernel``. The horizontal halo is cropped (rows are the
    only split axis)."""
    pad = (kernel - stride) // 2
    lead = patches.shape[:-3]
    cols = patches.reshape(-1, nv * nh, kernel * kernel).transpose(1, 2)
    canvas = F.fold(cols, ((nv - 1) * stride + kernel, (nh - 1) * stride + kernel), kernel,
                    stride=stride)
    out = canvas[:, 0, : nv * stride + 2 * pad, pad : pad + nh * stride]
    return out.reshape(*lead, *out.shape[-2:])


def exchange_halos(canvas: torch.Tensor, pad: int, group) -> torch.Tensor:
    """A band's padded canvas (..., rows + 2*pad, W) -> its (..., rows, W)
    body with the neighbours' halo rows added: the top ``pad`` rows go to
    the previous rank, the bottom ones to the next; the first and last
    rank receive nothing on their outer side. One rank crops."""
    rank, world = distributed.rank_world(group)
    if pad == 0:
        return canvas
    body = canvas[..., pad:-pad, :]
    if world == 1:
        return body
    t0 = time.perf_counter()
    staged = distributed.host_staged(canvas, group)
    wire = lambda t: (t.cpu() if staged else t).contiguous()
    peer = lambda i: dist.get_global_rank(group, i)
    ops, got = [], {}
    for side, other, halo in (("prev", rank - 1, canvas[..., :pad, :]),
                              ("next", rank + 1, canvas[..., -pad:, :])):
        if 0 <= other < world:
            got[side] = torch.empty_like(wire(halo))
            ops += [dist.P2POp(dist.isend, wire(halo), peer(other), group),
                    dist.P2POp(dist.irecv, got[side], peer(other), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    body = body.clone()
    if "next" in got:
        body[..., -pad:, :] += got["next"].to(body.device)
    if "prev" in got:
        body[..., :pad, :] += got["prev"].to(body.device)
    exchange_stats["calls"] += 1
    exchange_stats["seconds"] += time.perf_counter() - t0
    return body


def sharded_patches_to_image_weighted_average(patches: torch.Tensor,
                                              grid: tuple[int, int],
                                              siren_patch_size: int,
                                              inner_patch_size: int,
                                              group) -> torch.Tensor:
    """This rank's band of ``tiling.patches_to_image_weighted_average``:
    ``patches`` are its (..., nv/N * nh, s, s) patch rows
    (:func:`local_patch_rows`); returns (..., nv/N * inner, nh * inner).
    ``nv`` must be divisible by the ranks; ``group=None`` is one rank."""
    rank, world = distributed.rank_world(group)
    nv, nh = grid
    rows = mesh.check_divisible(nv, world, "patch-row grid")
    weights = tiling._weight_matrix_on(siren_patch_size, patches.device)
    canvas = local_fold_padded(patches * weights, rows, nh, siren_patch_size,
                               inner_patch_size)
    num = exchange_halos(canvas, (siren_patch_size - inner_patch_size) // 2, group)
    den = tiling._fold_den(grid, siren_patch_size, inner_patch_size, True, patches.device)
    band = rows * inner_patch_size
    return num / den[rank * band : (rank + 1) * band]


def gather_bands(band: torch.Tensor, group) -> torch.Tensor:
    """Every rank's band, joined in rank order into (..., nv*inner, W) on
    every rank."""
    if group is None or dist.get_world_size(group) == 1:
        return band
    return torch.cat(distributed.all_gather(band, group), dim=-2)
