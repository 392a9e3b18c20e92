"""TensorBoard scalars: a package's ``SummaryWriter``, ``tensorboardX``'s as
the JAX package uses, else ``torch.utils.tensorboard``'s (which needs the
``tensorboard`` package, and imports TensorFlow where that is installed),
and TensorBoard's own reader for what it wrote. With neither writer the
call raises, so a run that asked for scalars never goes on without them.
"""

from __future__ import annotations

import itertools
import os
import pathlib

_opened = itertools.count()


def summary_writer(log_dir: str | pathlib.Path):
    """A ``SummaryWriter`` (``add_scalar(tag, value, step)``, ``flush``,
    ``close``) writing a new event file into ``log_dir``. The file's name
    ends in the process id and a count, since ``tensorboardX`` names it by
    the second only and would overwrite a file opened in the same second."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as err:
            raise ImportError(
                "training.logging writes TensorBoard scalars through tensorboardX or "
                "torch.utils.tensorboard, and neither imports here: install `tensorboard`, "
                "or set training.logging=false") from err
    return SummaryWriter(str(log_dir), filename_suffix=f".{os.getpid()}.{next(_opened)}")


def read_scalars(log_dir: str | pathlib.Path) -> dict[str, list[tuple[int, float]]]:
    """tag -> [(step, value)] of every event file in ``log_dir``, as
    TensorBoard shows them (a value is a float32)."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}
