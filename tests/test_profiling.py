"""Observability utilities: phase timers, iteration histograms, metrics."""
import json

import numpy as np

from myldpccppapi.utils.profiling import (
    PhaseTimer,
    emit_metrics,
    iterations_histogram,
)


def test_phase_timer_accumulates():
    t = PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    rep = t.report()
    assert rep["a"]["calls"] == 2 and rep["b"]["calls"] == 1
    assert rep["a"]["total_s"] >= 0
    t.reset()
    assert t.report() == {}


def test_iterations_histogram():
    h = iterations_histogram(np.array([1, 2, 2, 40, 3]), max_iters=40)
    assert h["mean"] == 9.6 and h["max"] == 40 and h["at_cap"] == 1
    assert h["counts"][2] == 2 and len(h["counts"]) == 41


def test_emit_metrics(tmp_path):
    p = tmp_path / "m.json"
    s = emit_metrics(str(p), a=1, b=2.5)
    assert json.loads(s) == {"a": 1, "b": 2.5}
    assert json.loads(p.read_text()) == {"a": 1, "b": 2.5}
