"""Exposition: Prometheus text format, /metrics + /health endpoint,
and a live ANSI dashboard.

A copy of ``repro/obs/export.py`` (the port imports nothing of the
reference).

``to_prometheus(snapshot)`` renders any ``MetricsRegistry.snapshot()``
as Prometheus text exposition format 0.0.4 (counters/gauges as single
samples, histograms as ``summary`` families with quantile lines plus
``_sum``/``_count``/``_max``/``_min``).  Registry keys like
``name{k=v}`` are parsed back through :func:`parse_key`, which honors
the label-value escaping ``obs.metrics.escape_label`` applies, and
label values are re-escaped per the Prometheus spec.

``TelemetryServer`` is a stdlib ``http.server`` wrapper serving
``/metrics`` (current exposition) and ``/health`` (JSON SLO verdict;
HTTP 503 while any objective is FIRING) on a daemon thread —
``cluster_serve --metrics-port`` starts one next to the slot loop.

``render_dashboard`` turns a ``TimeSeriesStore`` + per-node
``SLOMonitor``s into a per-slot ANSI rollup (``cluster_serve
--dashboard``).
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.obs.metrics import (Counter, Gauge, MetricsRegistry,
                                     metric_key, unescape_label)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

_QUANTS = (("p50", "0.5"), ("p95", "0.95"), ("p99", "0.99"))


def parse_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Registry key ``name{k=v,...}`` -> (name, labels), honoring the
    ``\\``-escapes ``obs.metrics.escape_label`` writes."""
    if not key.endswith("}") or "{" not in key:
        return key, {}
    name, _, inner = key[:-1].partition("{")
    labels: Dict[str, str] = {}
    k, buf, esc, in_key = [], [], False, True
    for ch in inner:
        if esc:
            buf.append("\\" + ch)
            esc = False
        elif ch == "\\":
            esc = True
        elif ch == "=" and in_key:
            k, buf, in_key = buf, [], False
        elif ch == ",":
            labels["".join(k)] = unescape_label("".join(buf))
            k, buf, in_key = [], [], True
        else:
            buf.append(ch)
    if k or buf:
        labels["".join(k)] = unescape_label("".join(buf))
    return name, labels


def _prom_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    return "_" + name if name and name[0].isdigit() else name


def _prom_labels(labels: Dict[str, str], extra: Dict[str, str] = None
                 ) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    def esc(v: str) -> str:
        return str(v).replace("\\", "\\\\").replace('"', '\\"') \
            .replace("\n", "\\n")
    inner = ",".join(f'{_prom_name(k)}="{esc(v)}"'
                     for k, v in sorted(items.items()))
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    if isinstance(v, float) and v != v:                       # NaN
        return "NaN"
    return repr(float(v)) if isinstance(v, float) else str(v)


def to_prometheus(snapshot: Dict[str, object],
                  reg: Optional[MetricsRegistry] = None,
                  namespace: str = "") -> str:
    """Render a snapshot as Prometheus exposition text.  When ``reg``
    is given its instrument classes pick counter vs gauge types;
    otherwise ints render as counters and floats as gauges."""
    kinds = {k: m for k, m in reg.instruments()} if reg is not None else {}
    families: Dict[str, List[str]] = {}
    types: Dict[str, str] = {}
    prefix = namespace + "_" if namespace else ""
    for key in sorted(snapshot):
        val = snapshot[key]
        name, labels = parse_key(key)
        fam = prefix + _prom_name(name)
        if isinstance(val, dict):                       # histogram summary
            types[fam] = "summary"
            lines = families.setdefault(fam, [])
            for src, q in _QUANTS:
                lines.append(f"{fam}{_prom_labels(labels, {'quantile': q})}"
                             f" {_fmt(val[src])}")
            lines.append(f"{fam}_sum{_prom_labels(labels)}"
                         f" {_fmt(val['sum'])}")
            lines.append(f"{fam}_count{_prom_labels(labels)}"
                         f" {_fmt(val['count'])}")
            for ext in ("max", "min"):
                if ext in val:
                    efam = f"{fam}_{ext}"
                    types.setdefault(efam, "gauge")
                    families.setdefault(efam, []).append(
                        f"{efam}{_prom_labels(labels)} {_fmt(val[ext])}")
        else:
            m = kinds.get(key)
            if isinstance(m, Counter):
                kind = "counter"
            elif isinstance(m, Gauge):
                kind = "gauge"
            else:
                kind = "counter" if isinstance(val, int) \
                    and not isinstance(val, bool) else "gauge"
            prior = types.setdefault(fam, kind)
            if prior != kind:          # mixed labels resolved same family
                kind = prior
            families.setdefault(fam, []).append(
                f"{fam}{_prom_labels(labels)} {_fmt(val)}")
    out: List[str] = []
    for fam in sorted(families):
        out.append(f"# TYPE {fam} {types[fam]}")
        out.extend(families[fam])
    return "\n".join(out) + "\n" if out else ""


_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str
                     ) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                               float]:
    """Parse exposition text back into {(name, sorted label items):
    value} — the round-trip check used by tests and the cluster_serve
    endpoint self-probe.  Raises ValueError on a malformed line."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"malformed exposition line: {line!r}")
        name, rawlabels, value = m.groups()
        labels = {}
        if rawlabels:
            for k, v in _LABEL_RE.findall(rawlabels):
                labels[k] = v.replace('\\"', '"').replace("\\n", "\n") \
                    .replace("\\\\", "\\")
        out[(name, tuple(sorted(labels.items())))] = float(value)
    return out


# ------------------------------------------------------------- endpoint


class TelemetryServer:
    """``/metrics`` + ``/health`` on a daemon thread; stdlib only.

        srv = TelemetryServer(metrics_fn=lambda: to_prometheus(
                                  obs.registry().snapshot()),
                              health_fn=runtime.health, port=0)
        srv.start()                     # srv.port has the bound port
        ...
        srv.stop()
    """

    def __init__(self, *, metrics_fn: Callable[[], str],
                 health_fn: Optional[Callable[[], Dict]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):       # keep the slot loop quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        body = outer.metrics_fn().encode()
                        self._send(200, body,
                                   "text/plain; version=0.0.4")
                    elif path == "/health":
                        health = outer.health_fn() if outer.health_fn \
                            else {"status": "ok"}
                        code = 200 if health.get("status") == "ok" else 503
                        self._send(code, json.dumps(health).encode(),
                                   "application/json")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as e:          # surface, don't kill thread
                    self._send(500, f"error: {e}\n".encode(), "text/plain")

        self.metrics_fn = metrics_fn
        self.health_fn = health_fn
        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.host = host
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def url(self, path: str = "") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def start(self) -> "TelemetryServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="telemetry-server",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ------------------------------------------------------------ dashboard

_GREEN, _RED, _DIM, _BOLD, _RESET = ("\x1b[32m", "\x1b[31m", "\x1b[2m",
                                     "\x1b[1m", "\x1b[0m")


def render_dashboard(store, monitors: Optional[Dict] = None, *,
                     window_s: Optional[float] = None,
                     color: bool = True) -> str:
    """Per-node live rollup rendered from the time-series store: request
    and drop rates, windowed latency/ttft percentiles, assigned share,
    and each node's SLO verdict.  Returns a printable block."""
    monitors = monitors or {}
    g, r, d, b, z = (_GREEN, _RED, _DIM, _BOLD, _RESET) if color \
        else ("",) * 5
    t, snap = store.latest()
    if t is None:
        return f"{d}dashboard: no samples yet{z}"
    node_ids = sorted({parse_key(k)[1]["node"]
                       for k in snap if parse_key(k)[1].get("node")},
                      key=lambda s: (len(s), s))
    for nid in monitors:
        if str(nid) not in node_ids:
            node_ids.append(str(nid))
    w = store.window_s if window_s is None else window_s
    head = (f"{b}telemetry{z} {d}(window {w:g}s){z}  "
            f"tokens/s={store.rate('queue_tokens_out', w, now=t):.1f}  "
            f"kv_util={store.ewma('kv_pool_utilization'):.2f}  "
            f"shed/s={store.rate('queue_shed_hint_drops', w, now=t):.2f}")
    lines = [head,
             f"{d}{'node':>6} {'q/s':>7} {'drop/s':>7} {'p95_lat':>9} "
             f"{'p95_ttft':>9} {'share':>6} {'slo':>10}{z}"]
    for nid in node_ids:
        qps = store.rate(metric_key("node_queries", node=nid), w, now=t)
        drops = store.rate(metric_key("node_drops", node=nid), w, now=t)
        lat = store.summary(metric_key("node_latency_s", node=nid), w,
                            now=t)["p95"]
        ttft = store.summary(metric_key("node_ttft_s", node=nid), w,
                             now=t)["p95"]
        share = snap.get(metric_key("node_assigned_share", node=nid), 0.0)
        mon = monitors.get(nid)
        if mon is None and nid.lstrip("-").isdigit():
            mon = monitors.get(int(nid))
        if mon is None:
            slo = f"{d}-{z}"
        else:
            firing = mon.firing()
            slo = f"{r}FIRING:{','.join(firing)}{z}" if firing \
                else f"{g}OK{z}"
        lines.append(f"{nid:>6} {qps:>7.2f} {drops:>7.2f} "
                     f"{lat:>8.3f}s {ttft:>8.3f}s {share:>6.2f} {slo}")
    return "\n".join(lines)
