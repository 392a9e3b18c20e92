"""Image and plot artifacts (own copy of
``mri_inr_tpu/utils/visualization.py``): min-max-normalised grey PNGs,
comparison panels, metric boxplots and density plots, same file names.

``matplotlib`` is imported at first use, headless, so the package imports on
a machine without it; only rendering needs it (:func:`have_matplotlib`).
"""

from __future__ import annotations

import pathlib

import numpy as np


def have_matplotlib() -> bool:
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def normalize_image(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    lo, hi = img.min(), img.max()
    if hi > lo:
        img = (img - lo) / (hi - lo)
    return img


def save_image(img, name: str, output_dir: str | pathlib.Path, dpi: int = 300) -> None:
    """Write ``{name}.png``: one min-max-normalised grey image."""
    plt = _pyplot()
    output_dir = pathlib.Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots()
    ax.imshow(normalize_image(np.asarray(img)), cmap="gray")
    ax.axis("off")
    fig.savefig(output_dir / f"{name}.png", dpi=dpi, bbox_inches="tight")
    plt.close(fig)


def save_image_comparison(images: list, titles: list[str], name: str,
                          output_dir: str | pathlib.Path) -> None:
    """Write ``{name}.png``: the images side by side, each min-max
    normalised, grey."""
    plt = _pyplot()
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


def metrics_boxplot(values: dict[str, np.ndarray], output_dir: str | pathlib.Path) -> None:
    """Write ``{metric}_boxplot.png`` per metric."""
    plt = _pyplot()
    output_dir = pathlib.Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    for name, arr in values.items():
        fig, ax = plt.subplots()
        ax.boxplot(np.asarray(arr))
        ax.set_title(f"{name} boxplot")
        ax.set_ylabel(name)
        fig.savefig(output_dir / f"{name.lower()}_boxplot.png", dpi=150)
        plt.close(fig)


def metrics_density_plot(values: dict[str, np.ndarray],
                         output_dir: str | pathlib.Path) -> None:
    """Write ``{metric}_density.png`` per metric: a histogram and, where the
    values spread, a Gaussian kernel density estimate (Silverman's rule)."""
    plt = _pyplot()
    output_dir = pathlib.Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    for name, arr in values.items():
        arr = np.asarray(arr)
        fig, ax = plt.subplots()
        ax.hist(arr, bins=40, density=True, alpha=0.6)
        if arr.std() > 0:
            grid = np.linspace(arr.min(), arr.max(), 200)
            bw = 1.06 * arr.std() * len(arr) ** (-1 / 5)
            kde = np.exp(-0.5 * ((grid[:, None] - arr[None, :]) / bw) ** 2).sum(axis=1) / (
                len(arr) * bw * np.sqrt(2 * np.pi))
            ax.plot(grid, kde)
        ax.set_title(f"{name} density")
        ax.set_xlabel(name)
        fig.savefig(output_dir / f"{name.lower()}_density.png", dpi=150)
        plt.close(fig)
