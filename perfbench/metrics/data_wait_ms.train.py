"""Milliseconds a traced unit in which the card is idle while the host
is inside the data layer's spans (``mri.data.*``: materialise, the host mask
draw, images, tiles): what the data layer's work costs the card
(``metrics/_spans.py``)."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location("perfbench_metric__spans",
                                               pathlib.Path(__file__).with_name("_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(ctx):
    return _spans.idle_under_ms(ctx, lambda name: name.startswith("mri.data."))
