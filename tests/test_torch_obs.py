"""The port's metrics registry, time-series store and SLO monitors
against the reference's on the CPU.  Both get the same operations on
private registries over an explicit synthetic timeline (every call
takes ``t`` / ``now``), and every snapshot, delta, derived statistic,
objective state and health verdict is compared exactly."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.obs import metrics as j_metrics  # noqa: E402
from repro.obs import slo as j_slo  # noqa: E402
from repro.obs.timeseries import TimeSeriesStore as JStore  # noqa: E402

from repro_torch.obs import metrics, slo  # noqa: E402
from repro_torch.obs.timeseries import TimeSeriesStore  # noqa: E402


def _drive(reg, step, rng):
    """One step of a node-like workload: counters, gauges, histograms,
    with labels that need escaping."""
    for node in ("0", "1", "a=b,c}"):
        n = int(rng.integers(0, 5))
        reg.counter("node_queries", node=node).inc(n)
        reg.counter("node_drops", node=node).inc(int(rng.integers(0, n + 1)))
        h = reg.histogram("node_latency_s", node=node)
        for v in rng.random(n) * 3.0:
            h.observe(float(v))
        if step % 3 == 0:
            reg.gauge("node_slo_firing", node=node).set(float(step % 2))
    reg.gauge("ppo_updates").set(step // 2)


def _pair():
    return metrics.MetricsRegistry(), j_metrics.MetricsRegistry()


def test_registry_snapshot_and_delta_match_reference():
    ours, theirs = _pair()
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    prev_o = prev_t = None
    for step in range(6):
        _drive(ours, step, r1)
        _drive(theirs, step, r2)
        assert ours.snapshot() == theirs.snapshot()
        assert ours.delta(prev_o) == theirs.delta(prev_t)
        prev_o, prev_t = ours.snapshot(), theirs.snapshot()
    assert [k for k, _ in ours.instruments()] == \
        [k for k, _ in theirs.instruments()]
    with pytest.raises(TypeError):
        ours.counter("ppo_updates")          # registered as a gauge
    ours.reset()
    assert ours.snapshot() == {}


def test_labels_and_percentile_match_reference():
    for labels in ({}, {"node": "3"}, {"b": "x=y", "a": "p,q}"}):
        assert metrics.metric_key("m", **labels) == \
            j_metrics.metric_key("m", **labels)
    for v in ("plain", "a\\b", "k=v,w}"):
        assert metrics.escape_label(v) == j_metrics.escape_label(v)
        assert metrics.unescape_label(metrics.escape_label(v)) == v
    for xs in ([], [1.0], [3.0, 1.0, 2.0, 9.0]):
        for q in (50, 95, 99):
            assert metrics.percentile(xs, q) == j_metrics.percentile(xs, q)


def test_metrics_switch_reads_enable_metrics_only():
    was = metrics.metrics_enabled()
    try:
        metrics.enable_metrics(False)
        assert not metrics.metrics_enabled()
        metrics.enable_metrics(True)
        assert metrics.metrics_enabled()
    finally:
        metrics.enable_metrics(was)


def test_timeseries_store_matches_reference():
    ours_r, theirs_r = _pair()
    ours = TimeSeriesStore(ours_r, window_s=20.0, max_points=8,
                           ewma_alpha=0.4)
    theirs = JStore(theirs_r, window_s=20.0, max_points=8, ewma_alpha=0.4)
    r1, r2 = np.random.default_rng(1), np.random.default_rng(1)
    keys = None
    for step in range(14):
        t = 3.0 * step + (0.5 if step % 4 == 0 else 0.0)
        _drive(ours_r, step, r1)
        _drive(theirs_r, step, r2)
        assert ours.sample(t) == theirs.sample(t)
        keys = sorted(ours_r.snapshot())
        for key in keys:
            for w in (None, 5.0, 12.0):
                assert ours.series(key, w) == theirs.series(key, w)
                assert ours.rate(key, w) == theirs.rate(key, w)
                assert ours.increment(key, w) == theirs.increment(key, w)
                assert ours.summary(key, w) == theirs.summary(key, w)
            assert ours.ewma(key) == theirs.ewma(key)
        assert ours.rollup() == theirs.rollup()
        assert ours.rollup(6.0) == theirs.rollup(6.0)
        assert len(ours) == len(theirs)
        assert ours.latest() == theirs.latest()
    assert keys and len(ours) == 8


def test_node_objectives_match_reference():
    for node, slo_s in ((0, 1.5), ("x,y", 0.2)):
        ours = slo.node_objectives(node, slo_s)
        theirs = j_slo.node_objectives(node, slo_s)
        assert [dataclasses.asdict(o) for o in ours] == \
            [dataclasses.asdict(o) for o in theirs]
    with pytest.raises(ValueError):
        slo.Objective("bad", "ratio", "m")
    with pytest.raises(ValueError):
        slo.Objective("bad", "median", "m")
    with pytest.raises(ValueError):
        slo.Objective("bad", "quantile", "m", budget=0.0)


def test_slo_monitor_matches_reference():
    """A node that turns slow and drops for a stretch, then recovers:
    burn rates, FIRING/OK transitions (both windows needed to fire,
    hysteresis to clear) and health verdicts, evaluation by evaluation."""
    pair = []
    for m, s, store_cls in ((metrics, slo, TimeSeriesStore),
                            (j_metrics, j_slo, JStore)):
        reg = m.MetricsRegistry()
        store = store_cls(reg, window_s=60.0)
        mon = s.SLOMonitor(store, s.node_objectives(
            0, 1.5, windows=((10.0, 2.0), (30.0, 1.0))), clear_evals=2)
        pair.append((reg, store, mon))
    for step in range(40):
        t = 2.0 * step
        bad = 10 <= step < 22
        for reg, store, mon in pair:
            rng = np.random.default_rng(step)
            n = 6
            reg.counter("node_queries", node="0").inc(n)
            reg.counter("node_drops", node="0").inc(3 if bad else 0)
            reg.counter("node_shed", node="0").inc(0)
            reg.counter("node_kv_exhaustions", node="0").inc(
                1 if step % 7 == 0 else 0)
            h = reg.histogram("node_ttft_s", node="0")
            l = reg.histogram("node_latency_s", node="0")
            for v in rng.random(n) * (3.0 if bad else 0.5):
                h.observe(float(v))
                l.observe(float(v) * 1.5)
            store.sample(t)
            mon.evaluate(t)
        (_, _, ours), (_, _, theirs) = pair
        assert ours.firing() == theirs.firing()
        assert ours.health() == theirs.health()
        assert {n: (st.status, st.burns, st.since, st.transitions)
                for n, st in ours.states.items()} == \
            {n: (st.status, st.burns, st.since, st.transitions)
             for n, st in theirs.states.items()}
    ours = pair[0][2]
    assert sum(st.transitions for st in ours.states.values()) >= 2
    assert ours.ok()
