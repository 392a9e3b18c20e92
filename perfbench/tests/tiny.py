"""A cell cut to a size the CPU runs in seconds, for the tests: the same
files the benchmark reads, with the widths, depth, batch and data shrunk."""

from __future__ import annotations

import copy
import json

from perfbench.core import harness

MODEL = {"dim_hidden": 64, "latent_dim": 32}


def cell(workload: str, **traffic):
    """The cell ``<config>.<traffic>`` at the tests' size: the files
    ``BENCHMARK.json`` names, or for a cell it does not list (a mix kept for
    later), the configuration's and the mix's files by those names."""
    spec = harness.load_spec()
    try:
        c = harness.resolve(spec, workload)
    except LookupError:
        config, mix = workload.split(".", 1)
        c = harness.Cell(
            name=workload, chips=1, config_name=config,
            config=json.loads((harness.BENCH_DIR / "configs" / f"{config}.json").read_text()),
            traffic_name=mix,
            traffic=json.loads((harness.BENCH_DIR / "traffic" / f"{mix}.json").read_text()))
    c.config = copy.deepcopy(c.config)
    depth = 3 if not c.config["model"]["residual"] else 4
    for m in (c.config["model"], c.config["port"]["model"]):
        m.update(MODEL, num_layers=depth)
    c.config["port"]["training"]["batch_size"] = 32
    t = c.traffic = copy.deepcopy(c.traffic)
    t.update(size=64, ref_block=16)
    if t["kind"] == "train":
        t.update(volumes=4, val_volumes=1, slices=2, warmup_epochs=2, trace_units=1)
    else:
        t.update(volumes=3, slices=2, warmup_units=1, trace_units=1, check_sample=6)
    t.update(traffic)
    return c
