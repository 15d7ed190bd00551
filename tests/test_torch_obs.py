"""repro_torch.obs against repro.obs: the same observations give the same
summaries and exposition text, and spans, sinks and the slow-query log
behave alike.

Everything here is host-side Python in both packages, so every comparison
is exact (tolerance 0): the histograms bucket the same floats with the same
bisect, and the summaries round the same sums.
"""

import urllib.request

import numpy as np
import pytest
import torch

from repro.obs import metrics as jmetrics
from repro.obs import slowlog as jslowlog
from repro.obs import trace as jtrace
from repro_torch import obs as tobs
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import slowlog as tslowlog
from repro_torch.obs import trace as ttrace


def _observe(reg, seed):
    """One seeded stream of counter, gauge and histogram writes."""
    rng = np.random.default_rng(seed)
    c = reg.counter("index.compaction_passes", "passes")
    g = reg.gauge("scheduler.queue_depth", "depth")
    h = reg.histogram("index.query_ms", "query latency")
    rows = reg.histogram("batcher.batch_rows", buckets=(1.0, 2.0, 4.0, 8.0, 16.0))
    for v in rng.lognormal(mean=0.0, sigma=2.0, size=500):
        h.observe(float(v))
    for v in rng.integers(1, 40, size=50):
        rows.observe(float(v))
    c.inc(int(rng.integers(1, 9)))
    c.inc()
    g.set(float(rng.uniform(0, 100)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_observations_same_summaries_and_exposition(seed):
    jreg, treg = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    _observe(jreg, seed)
    _observe(treg, seed)
    assert treg.snapshot() == jreg.snapshot()
    assert treg.prometheus() == jreg.prometheus()
    for name in ("index.query_ms", "batcher.batch_rows"):
        jh, th = jreg.get(name), treg.get(name)
        assert th.cumulative() == jh.cumulative()
        for p in (0, 1, 50, 95, 99, 100):
            assert th.percentile(p) == jh.percentile(p)


def test_default_buckets_and_registry_rules_match():
    assert tmetrics.DEFAULT_BUCKETS_MS == jmetrics.DEFAULT_BUCKETS_MS
    for mod in (jmetrics, tmetrics):
        reg = mod.MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError):
            reg.histogram("x")
        with pytest.raises(ValueError):
            mod.Histogram("h", buckets=(2.0, 1.0))
        assert reg.histogram("empty").summary() == {
            "count": 0, "sum": 0.0, "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}


def test_serve_http_exposes_the_registry():
    reg = tmetrics.MetricsRegistry()
    _observe(reg, 3)
    server = tmetrics.serve_http(0, registry=reg)
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            assert r.read().decode() == reg.prometheus()
    finally:
        server.shutdown()
        server.server_close()


class _Clock:
    """A deterministic clock: each read advances 1 ms."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


@pytest.fixture
def both_tracers(monkeypatch):
    """Both tracers on, with one fake clock each; off again afterwards."""
    for mod in (jtrace, ttrace):
        monkeypatch.setattr(mod, "clock", _Clock())
        mod.enable()
    yield
    for mod in (jtrace, ttrace):
        mod.disable()


def _tree(mod):
    roots = []
    mod.add_sink(roots.append)
    try:
        with mod.span("index.query", metric=None, rows=4) as root:
            with mod.span("index.fan.stage1", segments=2):
                with mod.span("engine.strips", rows=8):
                    pass
                with mod.span("engine.strips", rows=8) as sp:
                    sp.set(base=8)
            inner_id = mod.current_trace_id()
        assert mod.current_trace_id() == 0
    finally:
        mod.remove_sink(roots.append)
    assert roots == [root] and inner_id == root.trace_id != 0
    return root


def _strip_ids(d):
    d = dict(d, trace_id=0)
    d["children"] = [_strip_ids(c) for c in d["children"]]
    return d


def test_spans_nest_time_and_sink_alike(both_tracers):
    jroot, troot = _tree(jtrace), _tree(ttrace)
    assert _strip_ids(troot.to_dict()) == _strip_ids(jroot.to_dict())
    assert troot.tree() == jroot.tree()
    assert [s.attrs for s in troot.find("engine.strips")] == [
        s.attrs for s in jroot.find("engine.strips")]


def test_span_errors_are_recorded_and_raised(both_tracers):
    for mod in (jtrace, ttrace):
        with pytest.raises(KeyError):
            with mod.span("index.query") as sp:
                raise KeyError("x")
        assert sp.attrs["error"] == "KeyError"


def test_disabled_span_is_the_shared_null_span():
    ttrace.disable()
    assert ttrace.span("index.query", rows=1) is ttrace.NULL_SPAN
    assert not ttrace.span("x")
    with ttrace.span("x") as sp:
        assert sp.set(a=1) is ttrace.NULL_SPAN


def test_span_metric_fills_the_histogram(both_tracers):
    for mod, reg in ((jtrace, jmetrics.REGISTRY), (ttrace, tmetrics.REGISTRY)):
        before = reg.histogram("test.obs_span_ms").count
        with mod.span("test.obs", metric="test.obs_span_ms"):
            pass
        assert reg.histogram("test.obs_span_ms").count == before + 1


def test_profiler_scope_marks_spans_as_profiler_ranges():
    tobs.enable(profiler_scope=True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tobs.span("index.query.profiled"):
                torch.ones(4).sum()
    finally:
        tobs.disable()
    assert "index.query.profiled" in {e.key for e in prof.key_averages()}


# equal durations: a later trace never displaces an earlier one when the log
# is full, and entries list later traces first
@pytest.mark.parametrize("capacity,want", [(1, [2]), (3, [4, 2, 0])])
def test_slow_log_keeps_the_same_worst_traces(both_tracers, capacity, want):
    durations = [5, 1, 7, 3, 7, 2]  # clock reads per query (ms)
    kept = []
    for mod, log_mod in ((jtrace, jslowlog), (ttrace, tslowlog)):
        log = log_mod.SlowQueryLog(capacity=capacity)
        for i, d in enumerate(durations):
            with mod.span("index.query", q=i) as sp:
                for _ in range(d - 1):
                    mod.clock()
            log.offer(sp)
        with mod.span("index.compact") as sp:  # not a query root: filtered
            pass
        assert log.offer(sp) is False
        kept.append(([(e["attrs"]["q"], e["duration_ms"]) for e in log.entries()],
                     log.offered, log.admitted, len(log)))
    assert kept[1] == kept[0]
    assert [q for q, _ in kept[1][0]] == want


def test_global_slow_log_is_a_tracer_sink(both_tracers):
    tobs.GLOBAL_SLOW_LOG.clear()
    with ttrace.span("batcher.query", rows=1):
        pass
    assert len(tobs.GLOBAL_SLOW_LOG) == 1
    tobs.GLOBAL_SLOW_LOG.clear()
