"""Data parallelism across ranks (counterpart of ``mri_inr_tpu/parallel``).

The JAX package has two levels: hosts joined by ``jax.distributed`` (DCN)
and each host's devices in a mesh (ICI). Here they collapse into one:
one process per rank, one ``torch.distributed`` process group
(:mod:`.distributed`); a rank uses one card, or the CPU under gloo.
:mod:`.mesh` lays a global batch out over the ranks, :mod:`.halo_fold`
folds a slice whose patch rows are split over them.
"""
