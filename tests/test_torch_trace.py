"""The port's span tracing, flight recorder, device profile and
exposition against the reference on the CPU.

The tracer nests spans per trace id, emits retroactive and batched
spans, and reads no clock while off (the port's ``perf_counter`` is
booby-trapped through a real paged decode segment and a standing run);
the recorder's ring wraps and exports the reference's JSONL schema; a
traced run turns the metric pushes on.  A traced ``replay_trace`` over
the olmo-1b + xlstm-350m smoke pair with standing (and with per-slot)
queues, capacities
pinned as in ``test_torch_runtime.py``, gives each query the reference's
span tree (names, parent links and every attribute that is not a time),
and the port's export passes ``tools/trace_report.py --check``.  The
Prometheus text of equal registries is the reference's, round-trips
through the parser, and ``TelemetryServer`` serves it with the health
verdict."""
import json
import pathlib
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from test_torch_cluster import SLO, _nodes, world  # noqa: E402,F401
from test_torch_runtime import ARCHS, _idents, _pin  # noqa: E402

from repro import obs as j_obs  # noqa: E402
from repro.cluster import ClusterRuntime as JRuntime  # noqa: E402
from repro.cluster import LiveWorkload as JWorkload  # noqa: E402
from repro.cluster import replay_trace as j_replay  # noqa: E402
from repro.core.inter_node import CapacityFunction as JCap  # noqa: E402
from repro.obs.timeseries import TimeSeriesStore as JStore  # noqa: E402
from repro.retrieval.encoder import TextEncoder as JEncoder  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.cluster import (ClusterRuntime, LiveWorkload,  # noqa: E402
                                 replay_trace)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.inter_node import CapacityFunction  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.obs import metrics, recorder  # noqa: E402
from repro_torch.obs import trace as trace_mod  # noqa: E402
from repro_torch.retrieval.encoder import TextEncoder  # noqa: E402
from repro_torch.serving import (ContinuousQueue, GenerationParams,  # noqa: E402
                                 ServeEngine)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tools import trace_report  # noqa: E402


def _check_cli(path) -> str:
    """``tools/trace_report.py <path> --check`` as CI runs it."""
    out = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "trace_report.py"),
                          str(path), "--check"], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


# --------------------------------------------------------------- unit layer


def test_span_nesting_and_retroactive_emit(tmp_path):
    rec = obs.enable(capacity=64)
    try:
        tr = obs.get_tracer()
        with tr.span("request", trace="r1"):
            with tr.span("retrieve", trace="r1", k=2):
                tr.event("semantic_cache", "r1", hit=False)
            tr.emit("queue_wait", "r1", 1.0, 2.0, slot=0)
            with tr.span("decode_segment", traces=["r1", "r2"], rows=2) \
                    as sp:
                sp.set(finished=1)
    finally:
        obs.disable()
    assert not obs.enabled() and obs.get_tracer().recorder is None
    path = rec.export_jsonl(str(tmp_path / "nest.jsonl"))
    meta, events, errors = trace_report.load(path)
    assert not trace_report.check(meta, events, errors, min_complete=0.0)
    spans = {(e["trace"], e["name"]): e for e in events
             if e["kind"] == "span"}
    root = spans[("r1", "request")]
    assert root["parent"] is None
    assert spans[("r1", "retrieve")]["parent"] == root["id"]
    assert spans[("r1", "retrieve")]["attrs"] == {"k": 2}
    assert spans[("r1", "queue_wait")]["parent"] == root["id"]
    assert spans[("r1", "queue_wait")]["t0"] == 1.0
    ev = next(e for e in events if e["kind"] == "event")
    assert ev["parent"] == spans[("r1", "retrieve")]["id"]
    seg1, seg2 = spans[("r1", "decode_segment")], \
        spans[("r2", "decode_segment")]
    assert seg1["t0"] == seg2["t0"] and seg1["t1"] == seg2["t1"]
    assert seg1["parent"] == root["id"] and seg2["parent"] is None
    assert seg1["attrs"] == seg2["attrs"] == {"rows": 2, "finished": 1}
    assert obs.query_trace(7) == j_obs.query_trace(7) == "q7"


def test_recorder_ring_wraparound(tmp_path):
    ours, theirs = obs.FlightRecorder(capacity=8), \
        j_obs.FlightRecorder(capacity=8)
    for rec in (ours, theirs):
        for i in range(20):
            rec.record({"kind": "event", "trace": "t", "id": i,
                        "parent": None, "name": f"e{i}", "t": float(i)})
        rec.record_metrics({"x": 1}, 20.0)
    assert (len(ours), ours.total, ours.dropped) == (8, 21, 13)
    assert ours.events() == theirs.events()
    a = ours.export_jsonl(str(tmp_path / "a" / "ring.jsonl"))
    b = theirs.export_jsonl(str(tmp_path / "b" / "ring.jsonl"))
    assert pathlib.Path(a).read_text() == pathlib.Path(b).read_text()
    meta, events, errors = trace_report.load(a)
    assert not errors and meta["dropped"] == 13 and len(events) == 8
    assert events[0]["id"] == 13 and ours.span_count() == 0
    ours.clear()
    assert len(ours) == 0 and ours.total == 0


def test_disabled_mode_never_reads_clock(monkeypatch):
    """With tracing off, neither the tracer nor the serving path's spans
    read the tracer's clock: a paged decode segment, a standing run and
    a prefix fork, with the port's ``perf_counter`` booby-trapped."""
    assert not obs.enabled()

    def boom():
        raise AssertionError("perf_counter read on the disabled path")

    monkeypatch.setattr(trace_mod, "perf_counter", boom)
    tr = obs.get_tracer()
    assert tr.span("decode_segment", traces=["a", "b"]) is obs.NULL_SPAN
    assert tr.now() == 0.0
    tr.event("prefix_cache", "a", hit=True)
    tr.emit("decode", "a", 0.0, 1.0)
    cfg = get_smoke_config("olmo-1b", max_d_model=32, vocab=48)
    eng = ServeEngine(cfg, Model(cfg).init_params(seed=0, device="cpu"),
                      max_len=64, batch_size=2, prefill_chunk=8, paged=True,
                      block_size=8, device="cpu")
    q = ContinuousQueue(eng, GenerationParams(max_new_tokens=3),
                        standing=True)
    ctx = [5, 6, 7, 2, 3, 4, 1, 2, 9]
    rids = [q.submit(ctx + [14, 4], prefix_len=len(ctx), trace="a"),
            q.submit([8, 30, 2], trace="b"),
            q.submit(ctx + [7, 8], prefix_len=len(ctx), trace="c"),
            q.submit(ctx + [9, 1], prefix_len=len(ctx), trace="d")]
    q.run(wait_for=rids[:1])
    q.run()
    assert q.stats.prefix_hits >= 1 and q.stats.segments >= 2
    q.close()
    assert all(len(q.result(r).tokens) == 3 for r in rids)
    assert tr.recorder is None


def test_metrics_switch_follows_tracing():
    """Tracing turns the metric pushes on, as ``enable_metrics`` does,
    in both packages."""
    for o, m in ((obs, metrics), (j_obs, j_obs)):
        m.enable_metrics(False)
        assert not m.metrics_enabled()
        o.enable(capacity=8)
        try:
            assert m.metrics_enabled()
        finally:
            o.disable()
        assert not m.metrics_enabled()


def test_device_profile_start_stop(tmp_path):
    """``ServeEngine(profile=logdir)`` brackets a run with a
    torch.profiler trace: a second start while one is live is a no-op,
    and the stop writes the trace into ``logdir``."""
    cfg = get_smoke_config("olmo-1b", max_d_model=32, vocab=48)
    eng = ServeEngine(cfg, Model(cfg).init_params(seed=0, device="cpu"),
                      max_len=64, batch_size=2, prefill_chunk=8, paged=True,
                      block_size=8, profile=str(tmp_path / "prof"),
                      device="cpu")
    q = ContinuousQueue(eng, GenerationParams(max_new_tokens=2))
    q.submit([1, 2, 3])
    assert recorder.start_device_profile(str(tmp_path / "outer"), "cpu")
    try:
        assert not eng.start_profile()          # one live profile only
    finally:
        assert recorder.stop_device_profile()
    assert not recorder.stop_device_profile()
    q.run()
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]
    assert not eng.stop_profile()


# ------------------------------------------------------- live integration


def _tree(events):
    """Per trace: its events in record order as (kind, name, parent's
    position in the trace or None, attributes); times dropped."""
    by_trace = {}
    for e in events:
        if e["kind"] in ("span", "event"):
            by_trace.setdefault(e["trace"], []).append(e)
    out = {}
    for tid, evs in by_trace.items():
        pos = {e["id"]: i for i, e in enumerate(evs)}
        out[tid] = [(e["kind"], e["name"],
                     pos[e["parent"]] if e["parent"] is not None else None,
                     e.get("attrs")) for e in evs]
        assert all(e["parent"] is None or e["parent"] in pos for e in evs)
    return out


@pytest.fixture(scope="module", params=["standing", "continuous"])
def traced_replays(world, tmp_path_factory, request):
    """A traced replay of 3 uniform slots of 4 queries over the smoke
    pair with standing or per-slot queues in each package: (port dump
    path, reference dump path)."""
    dim = TextEncoder(seed=0).dim
    ours_i, theirs_i = _idents(dim)
    _, qas, _, _, _, _ = world
    paths = []
    for port in (True, False):
        o = obs if port else j_obs
        nodes = _nodes(world, port, ARCHS, queue=request.param)
        _pin(nodes, CapacityFunction if port else JCap)
        rt = (ClusterRuntime if port else JRuntime)(
            nodes, ours_i if port else theirs_i, seed=0)
        wl = (LiveWorkload(qas, TextEncoder(seed=0), seed=2) if port
              else JWorkload(qas, JEncoder(seed=0), seed=2))
        o.registry().reset()
        rec = o.enable()
        try:
            (replay_trace if port else j_replay)(
                rt, wl, n_slots=3, slo_s=SLO, base_volume=4,
                trace="uniform", seed=3)
            rt.close()
            assert [n.unfinished() for n in nodes] == [0, 0]
        finally:
            o.disable()
            o.registry().reset()
        paths.append(rec.export_jsonl(str(
            tmp_path_factory.mktemp("trace") / f"{port}.jsonl")))
    return paths


def test_traced_replay_span_trees_match_reference(traced_replays):
    ours_p, theirs_p = traced_replays
    out = _check_cli(ours_p)
    assert "12/12 request traces complete" in out, out
    _, ours, _ = trace_report.load(ours_p)
    _, theirs, _ = trace_report.load(theirs_p)
    t_o, t_t = _tree(ours), _tree(theirs)
    assert sorted(t_o) == sorted(t_t)
    for tid in t_t:
        assert t_o[tid] == t_t[tid], tid
    names = {e["name"] for e in ours}
    assert {"request", "identify", "route", "retrieve", "federate",
            "queue_wait", "prefill", "decode_segment", "decode",
            "detokenize", "prefix_cache", "semantic_cache"} <= names
    # every stage of a query nests (transitively) under its request root
    for tid, evs in t_o.items():
        if not tid.startswith("q"):
            continue
        root = next(i for i, e in enumerate(evs) if e[1] == "request")
        for e in evs:
            p = e[2]
            while p is not None and p != root:
                p = evs[p][2]
            assert p == root or e[1] == "request", (tid, e)


# ------------------------------------------------------------- exposition


def _registries():
    ours, theirs = metrics.MetricsRegistry(), j_obs.MetricsRegistry()
    for reg in (ours, theirs):
        for node in ("0", "1", 'a"b\\c,d=e}'):
            reg.counter("node_queries", node=node).inc(3)
            reg.gauge("node_slo_firing", node=node).set(1.0)
            h = reg.histogram("node_latency_s", node=node)
            for v in (0.25, 0.5, 2.0):
                h.observe(v)
        reg.gauge("kv_pool_utilization").set(float("nan"))
        reg.counter("queue_tokens_out").inc(12)
    return ours, theirs


def test_prometheus_text_matches_reference():
    ours, theirs = _registries()
    for reg_arg in (False, True):
        got = obs.to_prometheus(ours.snapshot(), ours if reg_arg else None,
                                namespace="coedge")
        want = j_obs.to_prometheus(theirs.snapshot(),
                                   theirs if reg_arg else None,
                                   namespace="coedge")
        assert got == want
    text = obs.to_prometheus(ours.snapshot(), ours)
    parsed = obs.parse_prometheus(text)
    assert parsed.keys() == j_obs.parse_prometheus(text).keys()
    key = ("node_queries", (("node", 'a"b\\c,d=e}'),))
    assert parsed[key] == 3.0
    for k in ours.snapshot():
        assert obs.parse_key(k) == j_obs.parse_key(k)
    with pytest.raises(ValueError):
        obs.parse_prometheus("not a sample line at all\n")


def test_dashboard_matches_reference():
    ours, theirs = _registries()
    s_o, s_t = obs.TimeSeriesStore(ours), JStore(theirs)
    for t in (0.0, 5.0):
        s_o.sample(t)
        s_t.sample(t)
    assert obs.render_dashboard(s_o, color=False) == \
        j_obs.render_dashboard(s_t, color=False)


def test_telemetry_server_serves_metrics_and_health():
    ours, _ = _registries()
    health = {"status": "ok"}
    srv = obs.TelemetryServer(
        metrics_fn=lambda: obs.to_prometheus(ours.snapshot(), ours),
        health_fn=lambda: dict(health), port=0).start()
    try:
        assert srv.port > 0
        body = urllib.request.urlopen(srv.url("/metrics"),
                                      timeout=10).read().decode()
        assert obs.parse_prometheus(body)
        resp = urllib.request.urlopen(srv.url("/health"), timeout=10)
        assert resp.status == 200 and json.loads(resp.read()) == health
        health["status"] = "degraded"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url("/health"), timeout=10)
        assert e.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url("/nope"), timeout=10)
        assert e.value.code == 404
    finally:
        srv.stop()
