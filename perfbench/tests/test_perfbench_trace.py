"""The idle share's union arithmetic, the gaps and the breakdown on a
made-up trace with overlapping kernels."""

import pytest

from perfbench.core import trace


def made_up():
    t = trace.Trace(window=(0.0, 10.0), units=2)
    t.device = [("void k_a<256>(float*)", 1.0, 3.0), ("k_b", 2.0, 4.0),  # overlap: 1..4
                ("void k_a<256>(float*)", 3.5, 3.8), ("Memcpy HtoD", 6.0, 7.0), ("k_c", 6.5, 8.0)]  # 6..8
    t.host = [("train_epoch", 0.0, 10.0), ("cudaStreamSynchronize", 4.0, 6.0),
              ("aten::item", 8.5, 9.9)]
    return t


def test_union_counts_overlap_once():
    assert trace.union_seconds([(1, 3), (2, 4), (3.5, 3.8), (6, 7), (6.5, 8)]) == 5.0
    t = made_up()
    assert t.busy_s() == 5.0 and t.window_s == 10.0
    assert 1 - t.busy_s() / t.window_s == pytest.approx(0.5)


def test_gaps():
    got = trace.gaps([(1, 3), (2, 4), (6, 8)], 0.0, 10.0)
    assert got == [(0.0, 1), (4, 6), (8, 10.0)]


def test_breakdown_names_gaps_by_the_innermost_host_event():
    b = trace.breakdown(made_up())
    assert b["device_ops"][0] == ["k_a<256>", pytest.approx(2.3)]
    gaps = dict((round(t, 6), n) for n, t in b["idle_gaps"])
    assert gaps[2.0] == "aten::item"  # 8..10, midpoint 9
    assert gaps[1.0] == "train_epoch"  # 0..1
    assert b["idle_gaps"][0][1] == pytest.approx(2.0)


@pytest.mark.parametrize("raw, short", [
    ("void (anonymous namespace)::chain_kernel<256, 5, false>(CUtensorMap, Args)",
     "chain_kernel<256, 5, false>"),
    ("void siren_fwd::forward_kernel<256, (anonymous namespace)::TrainEpilogue<5, false> >"
     "(CUtensorMap, TrainEpilogue<5, false>::Args)",
     "siren_fwd::forward_kernel<256, TrainEpilogue<5, false> >"),
    ("Memcpy HtoD (Pinned -> Device)", "Memcpy HtoD"),
])
def test_short_name(raw, short):
    assert trace.short_name(raw) == short


def test_host_annotations_on_the_device_timeline_are_no_work():
    host = [("perfbench.traced", 0.0, 10.0), ("Optimizer.step#Adam.step", 1.0, 2.0),
            ("cudaLaunchKernel", 1.0, 1.1)]
    device = [("perfbench.traced", 0.0, 10.0), ("Optimizer.step#Adam.step", 1.0, 2.0),
              ("void k<1>(float*)", 1.2, 1.5), ("Memcpy HtoD (Pinned -> Device)", 3.0, 3.5)]
    assert [n for n, _, _ in trace.device_work(device, host)] == [
        "void k<1>(float*)", "Memcpy HtoD (Pinned -> Device)"]
