"""Milliseconds a traced sweep in which the card is idle while the host
is inside the sweep's spans (``mri.sweep.*``: staging the stacks, enqueueing
each piece, the fetch of the metrics and the rows made of them)
(``metrics/_spans.py``)."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location("perfbench_metric__spans",
                                               pathlib.Path(__file__).with_name("_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(ctx):
    return _spans.idle_under_ms(ctx, lambda name: name.startswith("mri.sweep."))
