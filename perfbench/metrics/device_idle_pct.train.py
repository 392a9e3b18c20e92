"""The card's idle share over the traced window: ``1 - union of device
kernel, copy and set intervals / window`` (``metrics/_idle.py``)."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location("perfbench_metric__idle",
                                               pathlib.Path(__file__).with_name("_idle.py"))
_idle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_idle)


def read(ctx):
    return _idle.idle_pct(ctx)
