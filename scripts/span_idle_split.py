#!/usr/bin/env python3
"""One traced run of a benchmark cell, as ``perfbench/run.py --trace 1``
makes it, and the card's idle time split by the program's spans
(``mri.*``, ``utils/profiling.py``).

    python3 scripts/span_idle_split.py --workload <cell> --seed <n> --seconds <s> [--out FILE]
    python3 scripts/span_idle_split.py --workload <cell> --seed 1 --seconds 2 --tiny   # on the CPU

Standard output: the cell's result line (the JSON object ``run.py`` prints
last), then a summary of the split. ``--out`` writes the whole analysis as
JSON:

- ``split_idle_ms_per_unit``: the traced window's idle milliseconds a unit
  under the data layer (``mri.data.*``), the epoch loop
  (``mri.epoch.{perm,seeds,stage,replay,capture,warm,run}``, the spans
  ``epoch_loop_wait_ms.train`` reads), the trainer's bookkeeping
  (``mri.epoch.fetch``, ``mri.train.*``), the sweep (``mri.sweep.*``),
  ``mri.epoch.call`` and any ``mri.*`` span; ``idle_total`` is all of it.
  A gap under spans of two groups counts in each.
- ``per_span``: entries, host ms and idle ms under each span, a unit;
- ``top_gaps``: the twelve longest idle gaps, each with the innermost host
  event at its middle, the ``mri.*`` spans around it and the host events
  near it;
- ``host_ops_inside_ms_per_unit``: the host operations inside a few spans;
- ``window_spans``: ``SPANS``' seconds and entries over the whole window
  (traced and untraced units), ``unit_s`` each unit's seconds and
  ``epoch_host_s`` the window's ``launch_seconds``.

``--tiny`` runs the cell cut to the CPU (``perfbench/tests/tiny.py``);
otherwise it needs one card. Imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.core import harness  # noqa: E402

START = harness.process_start()

LOOP = {f"mri.epoch.{n}" for n in ("perm", "seeds", "stage", "replay", "capture", "warm", "run")}
BOOKKEEPING = {"mri.epoch.fetch", "mri.train.post_epoch", "mri.train.invalidate_packs",
               "mri.train.checkpoint"}
GROUPS = {
    "data": lambda n: n.startswith("mri.data."),
    "epoch_loop": LOOP.__contains__,
    "bookkeeping": BOOKKEEPING.__contains__,
    "sweep": lambda n: n.startswith("mri.sweep."),
    "epoch_call_other": lambda n: n == "mri.epoch.call",
    "any_mri": lambda n: n.startswith("mri."),
}
INSIDE = ("mri.epoch.replay", "mri.epoch.stage", "mri.epoch.fetch", "mri.data.materialize",
          "mri.sweep.fetch", "mri.sweep.dispatch")


def _spans_module():
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric__spans", ROOT / "perfbench" / "metrics" / "_spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(workload: str, seed: int, seconds: float, tiny: bool):
    """The cell's outcome, its result line, and ``SPANS`` over the window."""
    import torch

    from mri_inr_tpu_torch.utils import profiling
    from perfbench.core import drive

    window = {}
    begin, finish = drive.Window.begin, drive.Window.finish

    def spans_begin(self, *args, **kwargs):
        profiling.SPANS.reset()
        return begin(self, *args, **kwargs)

    def spans_finish(self):
        window.update(sections=dict(profiling.SPANS.sections),
                      counts=dict(profiling.SPANS.counts))
        return finish(self)

    drive.Window.begin, drive.Window.finish = spans_begin, spans_finish
    cell = harness.resolve(harness.load_spec(), workload)
    device = torch.device("cpu") if tiny else torch.device("cuda", 0)
    if tiny:
        from perfbench.tests import tiny as tiny_cells

        small = tiny_cells.cell(workload, trace_units=2)
        small.end_to_end, small.per_layer = cell.end_to_end, cell.per_layer
        cell = small
    out = harness.driver(cell.traffic["kind"]).drive(cell.config, cell.traffic, seed, seconds,
                                                     True, device)
    out.end_to_end["setup_s"] = out.first_unit - START
    info = {"platform": device.type, "count": 1, "memory_peak_bytes": out.memory_peak_bytes,
            "kind": "cpu" if tiny else torch.cuda.get_device_name(0)}
    return out, harness.result_line(cell, out, True, info), window


def split(tr) -> dict:
    """The analysis of one trace (see the module's docstring)."""
    from perfbench.core.trace import gaps

    spans = _spans_module()
    lo, hi = tr.window
    idle = gaps([(s, e) for _, s, e in tr.device], lo, hi)

    def cover(match):
        return [(max(s, lo), min(e, hi)) for n, s, e in tr.host if match(n) and e > lo and s < hi]

    def idle_ms(match):
        return 1e3 * spans.overlap_seconds(idle, cover(match)) / tr.units

    groups = {k: idle_ms(m) for k, m in GROUPS.items()}
    groups["idle_total"] = 1e3 * sum(e - s for s, e in idle) / tr.units
    per_span = {}
    for name in sorted({n for n, _, _ in tr.host if n.startswith("mri.")}):
        inside = [(s, e) for n, s, e in tr.host if n == name and s >= lo and e <= hi]
        per_span[name] = {"entries": len(inside),
                          "host_ms_per_unit": 1e3 * sum(e - s for s, e in inside) / tr.units,
                          "idle_under_ms_per_unit": idle_ms(lambda n, name=name: n == name)}
    top = []
    for s, e in sorted(idle, key=lambda g: g[0] - g[1])[:12]:
        mid = (s + e) / 2
        around = sorted((he - hs, n) for n, hs, he in tr.host if hs <= mid <= he)
        near = sorted((hs, n, he) for n, hs, he in tr.host
                      if he > s - 1e-3 and hs < e + 1e-3 and not n.startswith("mri."))
        top.append({"ms": 1e3 * (e - s), "at_ms": 1e3 * (s - lo),
                    "innermost": around[0][1] if around else None,
                    "mri_chain": [n for _, n in reversed(around) if n.startswith("mri.")],
                    "host_events": [(n, round(1e3 * (hs - s), 3), round(1e3 * (he - hs), 3))
                                    for hs, n, he in near][:40]})
    ops = {}
    for parent in INSIDE:
        held = [(s, e) for n, s, e in tr.host if n == parent and s >= lo and e <= hi]
        acc = {}
        for n, s, e in tr.host:
            if not n.startswith("mri.") and any(s >= ps and e <= pe for ps, pe in held):
                acc[n] = acc.get(n, 0.0) + (e - s)
        if held:
            ops[parent] = sorted(((k, 1e3 * v / tr.units) for k, v in acc.items()),
                                 key=lambda kv: -kv[1])[:8]
    return {"units_traced": tr.units, "window_s": tr.window_s, "split_idle_ms_per_unit": groups,
            "per_span": per_span, "top_gaps": top, "host_ops_inside_ms_per_unit": ops}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tiny", action="store_true", help="the cell cut to the CPU")
    ap.add_argument("--out", type=pathlib.Path, help="write the whole analysis here as JSON")
    a = ap.parse_args(argv)
    out, line, window = run_cell(a.workload, a.seed, a.seconds, a.tiny)
    print(json.dumps(line), flush=True)
    res = {"cell": a.workload, "seed": a.seed, "line": line, **split(out.context.trace),
           "window_spans": window, "unit_s": out.context.spans.get("unit_s", []),
           "epoch_host_s": out.context.spans.get("epoch_host_s")}
    if not a.tiny:
        res["gpu"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(res, indent=1))
    summary = {"split_idle_ms_per_unit": res["split_idle_ms_per_unit"],
               "top_gaps": [{k: g[k] for k in ("ms", "innermost", "mri_chain")}
                            for g in res["top_gaps"][:5]]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
