"""Host milliseconds of the online data set's materialisation
(``mri.data.materialize``: the host mask draw, the masked DFT, the
normalisation and the tiles, ``data/online.py``) inside each traced train
epoch (``mri.epoch.train``), the median over those epochs
(``metrics/_spans.py``)."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location("perfbench_metric__spans",
                                               pathlib.Path(__file__).with_name("_spans.py"))
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)


def read(ctx):
    return _spans.per_entry_ms(ctx, "mri.data.materialize", "mri.epoch.train")
