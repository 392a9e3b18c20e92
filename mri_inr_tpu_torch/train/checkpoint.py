"""Checkpoints with the JAX package's run-directory and resume discovery
(counterpart of ``mri_inr_tpu/train/checkpoint.py``).

One train-state checkpoint (model, optimizer, step) per save, under
``{output_dir}/{name}_{timestamp}/checkpoints/step_{N:08d}/state.pt``,
written with ``torch.save`` where the JAX package uses Orbax. Discovery is
the same: the newest ``{name}_{timestamp}`` run directory (timestamps sort
lexicographically) and its highest step.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import re

import torch

RUN_DIR_RE = r"^(?P<name>.+)_(?P<ts>\d{4}-\d{2}-\d{2}_\d{2}-\d{2}-\d{2})$"
STEP_DIR_RE = r"^step_(?P<step>\d+)$"
STATE_FILE = "state.pt"


def new_run_dir(output_dir: str | pathlib.Path, name: str,
                timestamp: str | None = None) -> pathlib.Path:
    ts = timestamp or datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    run_dir = pathlib.Path(output_dir) / f"{name}_{ts}"
    run_dir.mkdir(parents=True, exist_ok=True)
    return run_dir


def find_latest_run_dir(output_dir: str | pathlib.Path, name: str) -> pathlib.Path | None:
    """Newest ``{name}_{timestamp}`` run directory."""
    output_dir = pathlib.Path(output_dir)
    if not output_dir.is_dir():
        return None
    candidates = []
    for p in output_dir.iterdir():
        m = re.match(RUN_DIR_RE, p.name)
        if p.is_dir() and m and m.group("name") == name:
            candidates.append((m.group("ts"), p))
    if not candidates:
        return None
    return max(candidates)[1]


def find_latest_step(run_dir: str | pathlib.Path) -> int | None:
    ckpt_dir = pathlib.Path(run_dir) / "checkpoints"
    if not ckpt_dir.is_dir():
        return None
    steps = [
        int(m.group("step"))
        for p in ckpt_dir.iterdir()
        if (m := re.match(STEP_DIR_RE, p.name))
    ]
    return max(steps) if steps else None


def checkpoint_path(run_dir: str | pathlib.Path, step: int) -> pathlib.Path:
    return pathlib.Path(run_dir) / "checkpoints" / f"step_{step:08d}"


def save_state(run_dir: str | pathlib.Path, step: int, state) -> pathlib.Path:
    """Write ``state`` (a :class:`~mri_inr_tpu_torch.train.trainer.TrainState`)
    for ``step``; an existing checkpoint of that step is replaced. The file
    is written beside its target and renamed, so a reader never sees half a
    checkpoint."""
    path = checkpoint_path(run_dir, step)
    path.mkdir(parents=True, exist_ok=True)
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
    }
    tmp = path / (STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path / STATE_FILE)
    return path


def restore_state(run_dir: str | pathlib.Path, step: int, state):
    """Load the checkpoint of ``step`` into ``state`` in place (tensors land
    on the devices ``state`` already uses) and return it."""
    path = checkpoint_path(run_dir, step) / STATE_FILE
    # weights_only: a checkpoint holds tensors and plain containers only
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state


def resolve_resume(output_dir: str | pathlib.Path,
                   name: str) -> tuple[pathlib.Path, int] | None:
    """(run_dir, latest_step) of the newest resumable run, or None."""
    run_dir = find_latest_run_dir(output_dir, name)
    if run_dir is None:
        return None
    step = find_latest_step(run_dir)
    if step is None:
        return None
    return run_dir, step
