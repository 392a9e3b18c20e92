"""The readers of the program's spans (``metrics/_spans.py`` and the four
metrics on it) on made-up traces: idle time partly under a span counts only
its overlap, spans of one name over several units give per-unit and median
values, a trace with no ``mri.*`` span reads None, and the spans' ranges on
the card's timeline are no device work."""

import importlib.util

import pytest

from perfbench.core import trace
from perfbench.core.drive import Context
from perfbench.core.harness import BENCH_DIR, metric_reader

_spec = importlib.util.spec_from_file_location("perfbench_metric__spans",
                                               BENCH_DIR / "metrics" / "_spans.py")
_spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_spans)

SPAN_METRICS = ["materialize_ms.train", "data_wait_ms.train", "epoch_loop_wait_ms.train",
                "sweep_host_wait_ms"]


def ctx_of(t):
    return Context(config={}, traffic={}, trace=t)


def train_trace():
    """Two train epochs in a 10 s window; the card is busy over 1-3, 4-6
    and 7-9 s, so idle over 0-1, 3-4, 6-7 and 9-10 s."""
    t = trace.Trace(window=(0.0, 10.0), units=2)
    t.device = [("chain_kernel", 1.0, 3.0), ("chain_kernel", 4.0, 6.0), ("dw_kernel", 7.0, 9.0)]
    t.host = [
        ("mri.epoch.train", 0.5, 3.55), ("mri.epoch.train", 5.0, 9.5),
        ("mri.data.materialize", 0.5, 1.5), ("mri.data.masks", 0.6, 1.2),  # idle 0.5-1
        ("mri.data.materialize", 5.0, 6.5), ("mri.data.images", 5.1, 6.4),  # idle 6-6.5
        ("mri.epoch.replay", 1.5, 3.5), ("mri.epoch.replay", 6.5, 8.0),  # idle 3-3.5, 6.5-7
        ("mri.epoch.seeds", 6.45, 6.5),  # under the data spans' idle too: counted once
        ("mri.epoch.val", 3.6, 4.5), ("mri.epoch.replay", 3.6, 3.9),  # idle 3.6-3.9
        ("mri.epoch.fetch", 9.0, 9.4),  # bookkeeping: in no reader's set
        ("aten::item", 9.0, 9.4),
    ]
    return t


def test_idle_partly_under_a_span_counts_only_its_overlap():
    c = ctx_of(train_trace())
    assert metric_reader("data_wait_ms.train")(c) == pytest.approx(1e3 * (0.5 + 0.5) / 2)
    # replays 0.5 + 0.5 + the validation's 0.3, seeds 6.45-6.5 lie under a replay's idle
    assert metric_reader("epoch_loop_wait_ms.train")(c) == pytest.approx(
        1e3 * (0.5 + 0.5 + 0.3 + 0.05) / 2)


def test_spans_of_one_name_over_units_give_the_median_inside_each_train_epoch():
    c = ctx_of(train_trace())
    # materialise 1.0 and 1.5 s a train epoch; the replays 2.0 and 1.5 s (the
    # validation epoch's replay lies in no train epoch)
    assert metric_reader("materialize_ms.train")(c) == pytest.approx(1250.0)
    assert _spans.per_entry_ms(c, "mri.epoch.replay", "mri.epoch.train") == pytest.approx(1750.0)


def test_a_span_cut_by_the_window_counts_inside_it_only():
    t = train_trace()
    t.window = (0.8, 10.0)  # idle 0.8-1 under the first materialisation
    c = ctx_of(t)
    assert metric_reader("data_wait_ms.train")(c) == pytest.approx(1e3 * (0.2 + 0.5) / 2)
    # the first train epoch began before the window: only the second counts
    assert metric_reader("materialize_ms.train")(c) == pytest.approx(1500.0)


def test_sweep_host_wait_per_sweep():
    t = trace.Trace(window=(0.0, 6.0), units=3)
    t.device = [("forward_kernel", 0.2, 1.8), ("forward_kernel", 2.1, 3.9),
                ("forward_kernel", 4.3, 5.7)]
    t.host = []
    # a sweep each 2 s: stage, dispatch, a fetch that returns
    # 0.1 s after the card's last kernel
    for lo, done in ((0.0, 1.8), (2.0, 3.9), (4.0, 5.7)):
        t.host += [("mri.sweep.stage", lo, lo + 0.1), ("mri.sweep.dispatch", lo + 0.1, lo + 0.5),
                   ("mri.sweep.fetch", lo + 0.5, done + 0.1)]
    # idle under the spans: 0-0.2, 2.0-2.1, 4.0-4.3 and each fetch's last 0.1 s;
    # not the rest of 1.8-2.0 and 5.7-6.0 (the benchmark's own code between sweeps)
    got = metric_reader("sweep_host_wait_ms")(ctx_of(t))
    assert got == pytest.approx(1e3 * (0.2 + 0.1 + 0.3 + 3 * 0.1) / 3)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_trace_with_no_program_span_reads_none(name):
    t = trace.Trace(window=(0.0, 10.0), units=2)
    t.device = [("chain_kernel", 1.0, 3.0)]
    t.host = [("aten::item", 4.0, 5.0), ("cudaGraphLaunch", 5.0, 6.0)]
    assert metric_reader(name)(ctx_of(t)) is None
    assert metric_reader(name)(ctx_of(None)) is None


def test_span_ranges_on_the_card_are_no_device_work():
    host = [("mri.epoch.train", 0.0, 9.0), ("mri.epoch.replay", 1.0, 2.0),
            ("cudaGraphLaunch", 1.0, 2.0)]
    device = [("mri.epoch.train", 0.0, 9.0), ("mri.epoch.replay", 1.0, 2.0),
              ("void chain_kernel<256>(Args)", 1.5, 2.5)]
    work = trace.device_work(device, host)
    assert [n for n, _, _ in work] == ["void chain_kernel<256>(Args)"]
    t = trace.Trace(window=(0.0, 10.0), units=1, device=work, host=host)
    assert t.busy_s() == pytest.approx(1.0)
    assert not any(n.startswith("mri.") for n, _ in trace.breakdown(t)["device_ops"])
    # the card idles 0-1.5 under the replay span's host side only over 1-1.5
    assert metric_reader("epoch_loop_wait_ms.train")(ctx_of(t)) == pytest.approx(500.0)
