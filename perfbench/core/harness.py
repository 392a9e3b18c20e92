"""Find a cell and everything it names by the names in ``BENCHMARK.json``,
run it once, and assemble its result line.

- a cell (``workloads[].name``) names a configuration (``configs[].name``,
  whose ``file`` holds it) and a traffic mix, ``traffic/<traffic>.json``;
- the mix's ``kind`` names its driver, ``drivers/<kind>.py`` (``drive``,
  ``control_numbers``, ``plant``, ``FAULTS``);
- an end-to-end metric is the driver's own reading of that name; a
  per-layer metric is ``metrics/<name>.py``, whose ``read(ctx)`` returns a
  number, or None when the traced run held nothing to read.

A name that is missing raises :class:`LookupError` naming it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import sys
import time
from dataclasses import dataclass, field

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

#: top-level modules no run may hold once its window has closed: JAX, its
#: libraries, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mri_inr_tpu")


def process_start() -> float:
    """The wall-clock time this process started (from ``/proc``), or now."""
    try:
        stat = pathlib.Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(pathlib.Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list = field(default_factory=list)  # metric entries this cell reports
    per_layer: list = field(default_factory=list)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise LookupError(f"no {what} named {name!r} in BENCHMARK.json")


def _json_file(path: pathlib.Path, what: str) -> dict:
    if not path.is_file():
        raise LookupError(f"{what}: no file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(root: pathlib.Path = ROOT) -> dict:
    return _json_file(root / "BENCHMARK.json", "the benchmark")


def resolve(spec: dict, workload: str, root: pathlib.Path = ROOT) -> Cell:
    w = _named(spec["workloads"], workload, "workload")
    c = _named(spec["configs"], w["config"], "configuration")
    return Cell(
        name=w["name"], chips=int(w["chips"]), config_name=c["name"],
        config=_json_file(root / c["file"], f"configuration {c['name']!r}"),
        traffic_name=w["traffic"],
        traffic=_json_file(BENCH_DIR / "traffic" / f"{w['traffic']}.json",
                           f"traffic {w['traffic']!r}"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, workload)])


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"per-layer metric {name!r}: no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    """``drivers/<kind>.py``, the driver of a traffic kind."""
    path = BENCH_DIR / "drivers" / f"{kind}.py"
    if not kind.isidentifier() or not path.is_file():
        raise LookupError(f"traffic kind {kind!r}: no file {path.relative_to(ROOT)}")
    return importlib.import_module(f"perfbench.drivers.{kind}")


def result_line(cell: Cell, outcome, trace: bool, device: dict) -> dict:
    """The JSON object the run prints last: ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device`` (with ``--trace 1`` also ``busy_s``,
    ``window_s`` and ``breakdown``), and last ``checks``, each compared
    number beside its limit."""
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] not in outcome.end_to_end:
                raise LookupError(f"{cell.name}: the driver reads no {m['name']!r}")
            metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = metric_reader(m["name"])(outcome.context)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": dict(device)}
    if trace and outcome.context.trace is not None:
        tr = outcome.context.trace
        line["device"]["busy_s"] = tr.busy_s()
        line["device"]["window_s"] = tr.window_s
        from perfbench.core.trace import breakdown
        line["breakdown"] = breakdown(tr)
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in outcome.checks}
    return line
