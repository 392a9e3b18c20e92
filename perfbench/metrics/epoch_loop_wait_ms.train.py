"""Milliseconds a traced unit in which the card is idle while the host
is inside the epoch loop's spans: the batch order (``mri.epoch.perm``), the
dropout draws (``mri.epoch.seeds``), the staging (``mri.epoch.stage``), the
replay call (``mri.epoch.replay``), a capture (``mri.epoch.capture``), the
eager epoch (``mri.epoch.warm``) and the plain loop (``mri.epoch.run``)
(``metrics/_spans.py``)."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location("perfbench_metric__spans",
                                               pathlib.Path(__file__).with_name("_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)

LOOP = {f"mri.epoch.{n}" for n in ("perm", "seeds", "stage", "replay", "capture", "warm", "run")}


def read(ctx):
    return _spans.idle_under_ms(ctx, LOOP.__contains__)
