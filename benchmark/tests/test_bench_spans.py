"""The readers of the program's spans (``benchmark/spans.py`` and the six
metrics over it) on hand-made traces: idle inside a span, nested spans, a
span cut at the window's end, spans absent; and the count metrics from a
traced tiny PCG run on the CPU.

    python -m pytest benchmark/tests/test_bench_spans.py -q -p no:cacheprovider
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from benchmark import run as bench_run
from benchmark import spans
from benchmark.spec import Bench
from benchmark.tests.tiny import REPO, tiny_root
from benchmark.trace import TraceData

SPAN_METRICS = ["tables_idle_ms.match", "fgate_idle_ms.match", "cg_iterations_per_trial.pcg",
                "trials_per_lm_iter.pcg", "blocks_idle_ms.ba", "layout_idle_ms.ba"]


def span(s, e, name):
    return (float(s), float(e), name, "user_annotation")


def kernel(s, e, name="k"):
    return (float(s), float(e), name, "kernel")


def make(host, device, window=(0.0, 1000.0)):
    return TraceData(window=window, device=device, host=host)


def read(metric, trace, **counters):
    return Bench(REPO).reader(metric).read(SimpleNamespace(cell="c", trace=trace,
                                                           counters=counters))


def test_idle_inside_a_span_is_the_gaps_it_covers():
    # busy [100, 200) and [300, 400): idle [0, 100), [200, 300), [400, 1000)
    t = make([span(50, 350, "a"), span(900, 950, "a"), span(0, 1000, "other")],
             [kernel(100, 200), kernel(300, 400)])
    assert spans.intervals(t, "a") == [(50.0, 350.0), (900.0, 950.0)]
    assert spans.count(t, "a") == 2
    # [50, 100) + [200, 300) + [900, 950)
    assert spans.idle_s(t, "a") == pytest.approx(200e-6)
    assert spans.idle_s(t, "other") == pytest.approx(800e-6)


def test_nested_and_overlapping_spans_count_idle_once():
    t = make([span(0, 500, "a"), span(100, 300, "a"), span(450, 600, "a"),
              span(120, 180, "a.b")],
             [kernel(200, 250)])
    assert spans.count(t, "a") == 3
    # union [0, 600) less busy [200, 250)
    assert spans.idle_s(t, "a") == pytest.approx(550e-6)
    assert spans.idle_s(t, "a.b") == pytest.approx(60e-6)


def test_a_span_cut_at_the_window_end_is_not_counted():
    """The profiler exports a span still open at its stop with its end at
    the stop, after the window's end: its idle inside the window counts,
    the span does not."""
    t = make([span(100, 200, "ba.trial"), span(700, 1012.5, "ba.trial")], [kernel(0, 50)],
             window=(0.0, 1000.0))
    assert spans.count(t, "ba.trial") == 1
    # [100, 200) + [700, 1000): idle gaps end at the window
    assert spans.idle_s(t, "ba.trial") == pytest.approx(400e-6)


def test_absent_spans_and_no_device_read_none():
    t = make([span(0, 10, "x")], [kernel(0, 5)])
    assert spans.intervals(t, "match.tables") == [] and spans.count(t, "match.tables") == 0
    assert spans.idle_s(t, "match.tables") is None
    # no device event: idle is not measured
    assert spans.idle_s(make([span(0, 10, "x")], []), "x") is None
    counters = dict(traced_passes=2, chunks=10, traced_iterations=8)
    for metric in SPAN_METRICS:
        assert read(metric, t, **counters) is None, metric
        assert read(metric, None, **counters) is None, metric


def test_the_six_readers_on_a_hand_made_trace():
    host = [span(0, 400, "match.pass"), span(500, 900, "match.pass"),
            span(300, 400, "match.tables"), span(800, 900, "match.tables"),
            span(100, 150, "match.fgate"), span(600, 700, "match.fgate"),
            span(0, 50, "ba.layout"),
            span(60, 100, "ba.blocks"), span(500, 540, "ba.blocks"),
            span(100, 200, "ba.trial"), span(200, 300, "ba.trial"), span(540, 640, "ba.trial"),
            span(980, 1100, "ba.trial")]                                   # cut: not counted
    host += [span(100 + 5 * i, 104 + 5 * i, "ba.pcg.cg_iteration") for i in range(16)]
    host += [span(200 + 3 * i, 202 + 3 * i, "ba.pcg.cg_iteration") for i in range(32)]
    host += [span(540 + 1.5 * i, 541 + 1.5 * i, "ba.pcg.cg_iteration") for i in range(64)]
    # busy [120, 140), [350, 380), [620, 650), [850, 860); the rest idle
    t = make(host, [kernel(120, 140), kernel(350, 380), kernel(620, 650), kernel(850, 860)])
    c = dict(traced_passes=2, chunks=1, traced_iterations=2)
    # tables: idle 70 + 90 us over 2 passes
    assert read("tables_idle_ms.match", t, **c) == pytest.approx(160e-3 / 2)
    # fgate: idle 30 + 70 us over 2 x 1 chunks
    assert read("fgate_idle_ms.match", t, **c) == pytest.approx(100e-3 / 2)
    assert read("cg_iterations_per_trial.pcg", t, **c) == pytest.approx(112 / 3)
    assert read("trials_per_lm_iter.pcg", t, **c) == pytest.approx(3 / 2)
    # blocks: 40 + 40 us of idle over 2 LM iterations
    assert read("blocks_idle_ms.ba", t, **c) == pytest.approx(80e-3 / 2)
    # layout: 50 us over one solve
    assert read("layout_idle_ms.ba", t, **c) == pytest.approx(50e-3)
    # no traced pass / iteration: nothing to divide by
    z = dict(traced_passes=0, chunks=1, traced_iterations=0)
    for metric in ("tables_idle_ms.match", "fgate_idle_ms.match", "trials_per_lm_iter.pcg",
                   "blocks_idle_ms.ba"):
        assert read(metric, t, **z) is None, metric


def test_benchmark_json_lists_the_six_as_program_spans():
    bench = Bench(REPO)
    entries = {m["name"]: m for m in bench.doc["per_layer"]}
    assert [m["name"] for m in bench.doc["per_layer"][-6:]] == SPAN_METRICS
    for name in SPAN_METRICS:
        assert entries[name]["source"] == "program_span" and entries[name]["workloads"]
        assert callable(bench.reader(name).read)
    assert entries["cg_iterations_per_trial.pcg"]["workloads"] == ["ba-venice1778-pcg"]
    assert set(entries["blocks_idle_ms.ba"]["workloads"]) == {"ba-venice1778-pcg",
                                                             "ba-venice52-dense"}


def test_traced_tiny_pcg_run_reports_the_cg_and_trial_counts(tmp_path):
    """On the CPU a traced PCG solve has the spans (no device events, so the
    idle metrics read nothing): every trial's CG loop stops at a host read
    every 16 iterations or at the cap of 64."""
    bench = Bench(tiny_root(tmp_path))
    out = bench_run.run_cell(bench, "ba-venice1778-pcg", seed=2 ** 31 + 3, seconds=0.1,
                             trace=True, device="cpu", t0=time.perf_counter())
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert 16 <= m["cg_iterations_per_trial.pcg"]["value"] <= 64
    assert m["trials_per_lm_iter.pcg"]["value"] >= 1
    assert "blocks_idle_ms.ba" not in m and "layout_idle_ms.ba" not in m
