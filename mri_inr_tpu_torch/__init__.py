"""mri_inr_tpu_torch — the PyTorch / CUDA port of ``mri_inr_tpu``.

The JAX package ``mri_inr_tpu`` is the reference and stays as it is; this
package computes the same functions with ``torch`` on an NVIDIA H100, and
imports nothing of JAX or of the reference package. Module names mirror the
reference's (``ops/siren_kernel.py`` here ports ``mri_inr_tpu/ops/
siren_kernel.py``, and so on), so each counterpart is easy to find.

This slice ports the evaluation path: conv encoder -> modulator -> fused
SIREN forward (a hand-written CUDA kernel, ``ops/csrc/siren_forward.cu``)
-> weighted overlap-add fold -> PSNR / SSIM / NRMSE.

Entry points run on the card (``cuda``) unless the caller passes
``device="cpu"``; without a card and without that argument they raise.
"""

__version__ = "0.1.0"
