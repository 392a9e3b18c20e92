"""Snapshot rendering (own copy of ``normalize_image`` and
``save_image_comparison`` from ``mri_inr_tpu/utils/visualization.py``).

``matplotlib`` is imported at first use, headless, so the package imports on
a machine without it; only rendering a snapshot needs it.
"""

from __future__ import annotations

import pathlib

import numpy as np


def normalize_image(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    lo, hi = img.min(), img.max()
    if hi > lo:
        img = (img - lo) / (hi - lo)
    return img


def save_image_comparison(images: list, titles: list[str], name: str,
                          output_dir: str | pathlib.Path) -> None:
    """Write ``{name}.png``: the images side by side, each min-max
    normalised, grey."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    output_dir = pathlib.Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    fig, axes = plt.subplots(1, len(images), figsize=(4 * len(images), 4))
    if len(images) == 1:
        axes = [axes]
    for ax, img, title in zip(axes, images, titles):
        ax.imshow(normalize_image(np.asarray(img)), cmap="gray")
        ax.set_title(title)
        ax.axis("off")
    fig.savefig(output_dir / f"{name}.png", dpi=150, bbox_inches="tight")
    plt.close(fig)
