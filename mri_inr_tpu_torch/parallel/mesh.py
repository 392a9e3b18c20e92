"""The data layout over ranks (counterpart of ``mri_inr_tpu/parallel/mesh.py``).

The JAX package shards a batch's leading axis over a 1-D ``data`` mesh
(``PartitionSpec("data")``): device ``i`` of ``N`` holds the ``i``-th
contiguous block of ``B / N`` rows. Here each rank takes that block of the
global batch itself; nothing stands for the ``Mesh`` object.
"""

from __future__ import annotations

DATA_AXIS = "data"


def check_divisible(batch_size: int, world: int, what: str = "batch") -> int:
    """``batch_size // world``; an indivisible batch raises, as
    ``shard_batch``'s invariant does."""
    if batch_size % world:
        raise ValueError(f"the {what} of {batch_size} rows is not divisible by the "
                         f"{world} ranks of the {DATA_AXIS!r} axis")
    return batch_size // world


def local_rows(batch, rank: int, world: int):
    """Rank ``rank``'s contiguous ``B / world`` rows of a global batch
    (anything sliceable along its first axis: a tensor, an array)."""
    per = check_divisible(len(batch), world)
    return batch[rank * per : (rank + 1) * per]
