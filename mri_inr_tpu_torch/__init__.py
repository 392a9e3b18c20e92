"""mri_inr_tpu_torch — the PyTorch / CUDA port of ``mri_inr_tpu``.

The JAX package ``mri_inr_tpu`` is the reference and stays as it is; this
package computes the same functions with ``torch`` on an NVIDIA H100, and
imports nothing of JAX or of the reference package. Module names mirror the
reference's (``ops/siren_kernel.py`` here ports ``mri_inr_tpu/ops/
siren_kernel.py``, and so on), so each counterpart is easy to find.

It covers evaluation, training, preprocessing, the quantised evaluation and
the autoencoder pretraining (``cli/``), with every TPU kernel of the JAX
package as a hand-written CUDA kernel under ``ops/csrc/``.

Entry points run on the card (``cuda``) unless the caller passes
``device="cpu"``; without a card and without that argument they raise.
"""

__version__ = "0.1.0"
