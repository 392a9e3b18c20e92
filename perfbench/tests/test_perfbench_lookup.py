"""The harness finds cells, configurations, traffic mixes, drivers and
per-layer metrics by the names in ``BENCHMARK.json``, and refuses a name it
cannot find; the file keeps to the benchmark's contract."""

import json
import re

import pytest

from perfbench.core import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(workload):
    cell = harness.resolve(SPEC, workload)
    assert cell.config["name"] == cell.config_name
    drv = harness.driver(cell.traffic["kind"])
    assert callable(drv.drive) and callable(drv.control_numbers) and drv.FAULTS
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))


@pytest.mark.parametrize("what", ["workload", "config", "traffic", "metric", "kind"])
def test_a_missing_name_is_refused(what):
    spec = json.loads(json.dumps(SPEC))
    with pytest.raises(LookupError):
        if what == "workload":
            harness.resolve(spec, "no.such_cell")
        elif what == "config":
            spec["workloads"][0]["config"] = "no_such_config"
            harness.resolve(spec, spec["workloads"][0]["name"])
        elif what == "traffic":
            spec["workloads"][0]["traffic"] = "no_such_traffic"
            harness.resolve(spec, spec["workloads"][0]["name"])
        elif what == "metric":
            harness.metric_reader("no_such_metric")
        else:
            harness.driver("no_such_kind")


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    ends = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in ends
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in ends and m["better"] in ("lower", "higher")
        assert not m["name"].endswith("_roofline") or m["unit"] == "%"
        for w in m.get("workloads", []):
            cell = harness.resolve(SPEC, w)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
