"""Device selection (counterpart of ``mri_inr_tpu/utils/platform.py``).

The JAX package picks its platform through ``jax.config``; here every entry
point takes an explicit ``device=`` argument and resolves it through
:func:`resolve_device`. The default is the card: a missing card raises
instead of quietly running on the CPU, so a measurement or a sweep can never
report CPU numbers as device numbers.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> the current CUDA device; raise when CUDA is asked for but
    unavailable. ``cuda`` without an index resolves to ``cuda:<current>``,
    so resolved devices compare equal to a module's parameter device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def module_device(module: torch.nn.Module) -> torch.device:
    """The device of a module's parameters."""
    return next(module.parameters()).device
