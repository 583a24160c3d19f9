"""Live edge-cluster serving launcher of the port: the hierarchical
scheduler over real per-node engines, end to end, on the card.

Counterpart of ``repro/launch/cluster_serve.py``.  Builds N live nodes
(an architecture and a private domain-partitioned corpus each), profiles
their measured throughput, then replays a trace-driven workload through
the PPO identifier and the Algorithm-1 inter-node scheduler, printing
per-slot measured latency, quality and drops.

    PYTHONPATH=src python -m repro_torch.launch.cluster_serve --smoke \\
        --nodes 2 --slots 2 --standing --paged --admission sjf \\
        --federated --trace-out build/trace_cluster.jsonl \\
        --metrics-every 1 --metrics-port 0
    ... --device cpu             # the plain PyTorch path, no GPU needed
    ... --no-inter-node          # capacity-unaware routing ablation
    ... --trace spike --arrival-rate 40   # open-loop saturation replay
    ... --index ivf --nprobe 3   # ANN retrieval instead of the flat scan

Every flag of the reference is accepted, with its default: without
``--paged`` the nodes serve through the non-paged engine, and ``--queue
wave`` runs synchronous waves.  Nodes cycle through the reference's
``NODE_ARCHS`` (olmo-1b, xlstm-350m, hymba-1.5b, qwen2-moe-a2.7b), so
``--nodes 4`` serves one node of each.  What the port does not serve yet
raises ``NotImplementedError`` before anything is built: ``--ckpt``
(ROADMAP A6), and a node of an architecture the port has no config for
(A4).  ``build_cluster(models=...)`` takes each node's ``(cfg, params)``
in place of the drawn weights.
"""
import argparse
import json
import time

import numpy as np

from repro_torch import obs
from repro_torch.cluster import ClusterRuntime, LiveEdgeNode, LiveWorkload, \
    enable_federation, replay_trace
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core.identifier import OnlineQueryIdentifier
from repro_torch.data.corpus import DOMAINS, generate_corpus
from repro_torch.data.partition import coverage_matrix, partition_edge_data
from repro_torch.data.tokenizer import Tokenizer
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.retrieval.cache import SemanticQueryCache
from repro_torch.retrieval.encoder import TextEncoder

# heterogeneous architectures, cycled across nodes (the reference's)
NODE_ARCHS = ("olmo-1b", "xlstm-350m", "hymba-1.5b", "qwen2-moe-a2.7b")


def check_ported(n_nodes: int, archs=NODE_ARCHS, *, ckpt=None) -> None:
    """Raise ``NotImplementedError``, naming its ROADMAP item, for what
    the port cannot serve yet."""
    if ckpt:
        raise NotImplementedError("--ckpt: loading trained checkpoints is "
                                  "not ported yet (ROADMAP A6)")
    missing = sorted({archs[n % len(archs)] for n in range(n_nodes)}
                     - set(ARCH_IDS))
    if missing:
        raise NotImplementedError(
            f"--nodes {n_nodes} needs {missing}: the port serves "
            f"{ARCH_IDS} so far (ROADMAP A4)")


def build_cluster(n_nodes: int, *, smoke: bool = True, entities: int = 8,
                  archs=NODE_ARCHS, max_len: int = 192, batch: int = 4,
                  new_tokens: int = 8, top_k: int = 2, d_model: int = 32,
                  seed: int = 0, update_threshold: int = 16,
                  index_kind: str = "flat", nprobe=None,
                  cache: bool = False, federated: bool = False,
                  fanout: int = 2, sketch_centroids: int = 8,
                  ckpt=None, queue: str = "continuous",
                  prefill_chunk: int = 32, paged: bool = False,
                  block_size: int = 16, admission: str = "fifo",
                  models=None, device="cuda"):
    """Corpus + tokenizer + N live nodes + PPO identifier on ``device``.
    Returns (nodes, workload-ready qas, tokenizer, encoder, identifier,
    coverage matrix).  Node n serves ``models[n]`` = (cfg, params) when
    ``models`` is given, else a smoke config of its architecture with
    weights drawn from seed ``seed + n``; ``federated`` attaches a shared
    ``FederatedRetriever`` to all nodes."""
    check_ported(n_nodes, archs, ckpt=ckpt)
    if models is not None and len(models) != n_nodes:
        raise ValueError(f"models has {len(models)} entries for "
                         f"{n_nodes} nodes")
    dev = resolve_device(device)
    docs, qas = generate_corpus(entities, seed=seed)
    tok = Tokenizer.build([d.text for d in docs]
                          + [qa.question for qa in qas]
                          + ["context question answer <sep>"])
    encoder = TextEncoder(seed=seed)
    n_domains = len(DOMAINS)
    primaries = [[d for d in range(n_domains) if d % n_nodes == n]
                 for n in range(n_nodes)]
    node_docs = partition_edge_data(docs, n_nodes, primaries, seed=seed)
    nodes = []
    for n in range(n_nodes):
        arch = archs[n % len(archs)]
        if models is not None:
            cfg, params = models[n]
        else:
            cfg = get_smoke_config(arch,
                                   max_d_model=d_model if smoke else 128,
                                   vocab=len(tok))
            params = Model(cfg).init_params(seed=seed + n, device=dev)
        nodes.append(LiveEdgeNode(
            n, arch, cfg, params, node_docs[n], tok, encoder,
            batch_size=batch, max_len=max_len, top_k=top_k,
            max_new_tokens=new_tokens, seed=seed + 10 * n,
            index_kind=index_kind, nprobe=nprobe,
            cache=SemanticQueryCache() if cache else None,
            queue=queue, prefill_chunk=prefill_chunk,
            paged=paged, block_size=block_size, admission=admission,
            device=dev))
    if federated:
        enable_federation(nodes, fanout=fanout,
                          n_centroids=sketch_centroids, seed=seed)
    ident = OnlineQueryIdentifier(encoder.dim, n_nodes, seed=seed,
                                  update_threshold=update_threshold,
                                  device=dev)
    cov = coverage_matrix(node_docs, n_domains)
    return nodes, qas, tok, encoder, ident, cov


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--per-slot", type=int, default=48,
                    help="base query volume per slot (trace modulates it)")
    ap.add_argument("--slo", type=float, default=1.5,
                    help="per-slot latency SLO in seconds")
    ap.add_argument("--trace", default="diurnal",
                    choices=["diurnal", "uniform", "spike", "ramp"])
    ap.add_argument("--arrival-rate", type=float, default=None,
                    metavar="QPS",
                    help="open-loop arrival rate: sets the base per-slot "
                         "volume to QPS * --slot-s (overrides --per-slot)")
    ap.add_argument("--slot-s", type=float, default=1.0,
                    help="nominal slot duration --arrival-rate multiplies")
    ap.add_argument("--require-healthy-exit", action="store_true",
                    help="exit 1 unless every admitted request finished "
                         "and /health recovers to ok after the trace")
    ap.add_argument("--no-inter-node", action="store_true",
                    help="ablation: capacity-unaware identifier sampling")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny models + corpus")
    ap.add_argument("--entities", type=int, default=None,
                    help="entities per domain (default 8 smoke / 24 full)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=192)
    ap.add_argument("--top-k", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--index", default="flat", choices=["flat", "ivf"],
                    help="per-node retrieval backend (ivf = ANN probe)")
    ap.add_argument("--nprobe", type=int, default=None,
                    help="IVF lists probed per query (default ~20%%)")
    ap.add_argument("--federated", action="store_true",
                    help="sketch-routed cross-node retrieval")
    ap.add_argument("--fanout", type=int, default=2,
                    help="shards probed per query when --federated")
    ap.add_argument("--cache", action="store_true",
                    help="per-node semantic query cache")
    ap.add_argument("--ckpt", default=None,
                    help="trained checkpoint (not ported: ROADMAP A6)")
    ap.add_argument("--queue", default="continuous",
                    choices=["continuous", "standing", "wave"],
                    help="per-node request scheduler: continuous "
                         "batching fresh per slot, one standing queue "
                         "whose frame stays warm across slots, or "
                         "synchronous waves")
    ap.add_argument("--standing", action="store_true",
                    help="shorthand for --queue standing")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt chunk size of the continuous prefill")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache with shared retrieved-context "
                         "prefix forking")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV tokens per pool block (--paged)")
    ap.add_argument("--admission", default="fifo",
                    choices=["fifo", "sjf"],
                    help="admission policy: FIFO-with-skip or "
                         "shortest-prefill-first")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record request spans + telemetry and export a "
                         "flight-recorder JSONL dump here at exit "
                         "(read it with tools/trace_report.py)")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="N",
                    help="print a metrics-delta rollup every N slots "
                         "(0 = never print)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve /metrics (Prometheus text) and /health "
                         "(SLO verdict JSON) on this port for the whole "
                         "run (0 = pick a free port); the endpoint is "
                         "self-probed before exit")
    ap.add_argument("--dashboard", action="store_true",
                    help="print a live per-node telemetry rollup after "
                         "every slot")
    ap.add_argument("--no-slo-feedback", action="store_true",
                    help="ablation: keep the SLO monitors but sever their "
                         "feedback into routing and admission shedding")
    ap.add_argument("--shed-fraction", type=float, default=0.25,
                    help="fraction of a FIRING node's backlog its queue "
                         "sheds per slot")
    ap.add_argument("--device", default="cuda",
                    help="where the nodes and the identifier run: cuda "
                         "(the default, needs a GPU) or cpu")
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    if args.standing:
        args.queue = "standing"
    if args.arrival_rate is not None:
        args.per_slot = max(1, round(args.arrival_rate * args.slot_s))
    check_ported(args.nodes, ckpt=args.ckpt)
    device = resolve_device(args.device)

    rec = obs.enable() if args.trace_out else None
    # registry pushes stay on for the whole run: the SLO monitors, the
    # /metrics endpoint, and the dashboard all read from it
    obs.enable_metrics(True)
    srv = None
    try:
        t0 = time.perf_counter()
        entities = args.entities or (8 if args.smoke else 24)
        archs = ", ".join(NODE_ARCHS[i % len(NODE_ARCHS)]
                          for i in range(args.nodes))
        print(f"building {args.nodes} live nodes ({archs}) over "
              f"{entities * len(DOMAINS)} docs on {device}", flush=True)
        nodes, qas, tok, encoder, ident, cov = build_cluster(
            args.nodes, smoke=args.smoke, entities=entities,
            batch=args.batch, max_len=args.max_len,
            new_tokens=args.new_tokens, top_k=args.top_k, seed=args.seed,
            update_threshold=max(4, args.per_slot),
            index_kind=args.index, nprobe=args.nprobe, cache=args.cache,
            federated=args.federated, fanout=args.fanout,
            queue=args.queue, prefill_chunk=args.prefill_chunk,
            paged=args.paged, block_size=args.block_size,
            admission=args.admission, device=device)
        print("corpus coverage per node:\n", np.round(cov, 2), flush=True)
        if args.federated:
            fed = nodes[0].federation
            print(f"federation: {len(fed.sketches)} shard sketches "
                  f"published ({fed.n_centroids} centroids each), fanout "
                  f"{fed.fanout}", flush=True)

        runtime = ClusterRuntime(nodes, ident,
                                 use_inter_node=not args.no_inter_node,
                                 seed=args.seed,
                                 slo_feedback=not args.no_slo_feedback,
                                 shed_fraction=args.shed_fraction)
        if args.metrics_port is not None:
            srv = obs.TelemetryServer(
                metrics_fn=lambda: obs.to_prometheus(
                    obs.registry().snapshot(), obs.registry()),
                health_fn=runtime.health, port=args.metrics_port).start()
            print(f"telemetry: /metrics and /health at {srv.url()}",
                  flush=True)
        print("profiling measured node throughput ...", flush=True)
        runtime.initialize()
        for node in nodes:
            print(f"  node {node.node_id} [{node.arch}]: "
                  f"{node.capacity.k:.1f} q/s measured -> "
                  f"C({args.slo:g}s) = {node.capacity(args.slo):.0f} "
                  f"queries", flush=True)

        mode = "identifier-only (no inter-node)" if args.no_inter_node \
            else "PPO + Algorithm-1 inter-node"
        print(f"replaying {args.slots} slots of {args.trace} trace "
              f"(base {args.per_slot}/slot, SLO {args.slo:g}s) under "
              f"{mode}", flush=True)
        workload = LiveWorkload(qas, encoder, seed=args.seed + 2)

        on_slot = None
        if rec is not None or args.metrics_every or args.dashboard:
            reg = obs.registry()
            last_snap = [reg.snapshot()]

            def on_slot(t, m):
                d = reg.delta(last_snap[0])
                last_snap[0] = reg.snapshot()
                if rec is not None:
                    rec.record_metrics(last_snap[0],
                                       obs.get_tracer().now())
                if args.metrics_every and (t + 1) % args.metrics_every == 0:
                    scalars = {k: v for k, v in d.items()
                               if not isinstance(v, dict)}
                    line = " ".join(
                        f"{k}={v:.3g}" if isinstance(v, float)
                        else f"{k}={v}" for k, v in sorted(scalars.items()))
                    print(f"  metrics[slot {t}]: {line}", flush=True)
                if args.dashboard and runtime.store is not None:
                    print(obs.render_dashboard(runtime.store,
                                               runtime.monitors),
                          flush=True)

        report = replay_trace(runtime, workload, n_slots=args.slots,
                              slo_s=args.slo, base_volume=args.per_slot,
                              trace=args.trace, seed=args.seed + 3,
                              verbose=True, on_slot=on_slot)

        s = report.summary()
        print(f"\nsummary: {s['queries']} queries in {s['slots']} slots | "
              f"quality={s['quality_mean']:.3f} "
              f"drop={s['drop_rate']:.2f} "
              f"p50={s['latency_p50_s']:.2f}s "
              f"p95={s['latency_p95_s']:.2f}s "
              f"imbalance={s['load_imbalance']:.2f} "
              f"ppo_updates={s['ppo_updates']}")
        lost = sum(node.unfinished() for node in nodes)
        runtime.close()          # drain + release standing sessions
        for node in nodes:
            st = node.stats
            extra = ""
            if args.cache:
                extra += f", {st.cache_hits} cache hits"
            if args.federated:
                extra += (f", {st.remote_contexts} remote ctx "
                          f"({st.remote_gold} gold)")
            rounds = "waves" if args.queue == "wave" else "frames"
            if args.queue != "wave":
                extra += (f", {st.refills} refills, "
                          f"ttft {st.ttft_mean * 1e3:.0f}ms mean")
            if st.shed:
                extra += f", {st.shed} shed"
            print(f"  node {node.node_id} [{node.arch}]: {st.queries} "
                  f"queries in {st.waves} {rounds}, {st.tokens_out} tokens, "
                  f"{st.drops} drops, {st.queries_per_s:.1f} q/s measured"
                  + extra)
        if args.queue == "standing":
            print(f"standing: {lost} request(s) unfinished at exit")
        if runtime.monitors:
            h = runtime.health()
            print(f"slo: status={h['status']} "
                  f"feedback={'on' if runtime.slo_feedback else 'OFF'} "
                  f"firing_nodes={h['firing_nodes'] or '[]'}")
            for nid in sorted(runtime.monitors, key=str):
                mon = runtime.monitors[nid]
                trans = sum(s.transitions for s in mon.states.values())
                firing = mon.firing()
                state = "FIRING:" + ",".join(firing) if firing else "OK"
                print(f"  node {nid}: {state} ({trans} objective "
                      f"transition{'s' if trans != 1 else ''})")
        if args.federated:
            fs = nodes[0].federation.stats
            print(f"federation: {fs.shard_probes} shard probes "
                  f"({fs.remote_probes} remote) for {fs.queries} queries, "
                  f"{fs.remote_contexts} remote contexts merged")
        if rec is not None:
            rec.record_metrics(obs.registry().snapshot(),
                               obs.get_tracer().now())
            obs.disable()
            rec.export_jsonl(args.trace_out)
            print(f"trace: {rec.span_count()} spans "
                  f"({len(rec)} events, {rec.dropped} dropped) "
                  f"-> {args.trace_out}")
        healthy = True
        if args.require_healthy_exit:
            healthy = _await_recovery(runtime)
            print(f"health at exit: "
                  f"{'ok' if healthy else runtime.health()['status']}")
        if srv is not None:
            _probe_endpoint(srv)
        print(f"total {time.perf_counter() - t0:.0f}s")
        if args.require_healthy_exit and (lost or not healthy):
            raise SystemExit(f"unhealthy exit: {lost} unfinished "
                             f"request(s), health_ok={healthy}")
    finally:
        # a failed run must not leave the server thread or the process's
        # tracing and metrics switches on
        if srv is not None:
            srv.stop()
        if rec is not None:
            obs.disable()
        obs.enable_metrics(False)


def _await_recovery(runtime, timeout_s: float = 20.0) -> bool:
    """Give the SLO monitors time to clear after the trace's spike: bad
    samples age out of the burn-rate windows, burn drops below the
    clear threshold, hysteresis releases.  True once /health says ok."""
    t0 = time.perf_counter()
    while True:
        if runtime.store is not None:
            runtime.store.sample()
        for mon in runtime.monitors.values():
            mon.evaluate()
        if runtime.health()["status"] == "ok":
            return True
        if time.perf_counter() - t0 >= timeout_s:
            return False
        time.sleep(0.5)


def _probe_endpoint(srv) -> None:
    """Self-probe the telemetry endpoint before exit, so a scripted run
    asserts well-formed exposition without a second process: fetch
    /metrics and round-trip it through the parser, fetch /health and
    check the verdict JSON."""
    import urllib.error
    import urllib.request
    try:
        body = urllib.request.urlopen(srv.url("/metrics"),
                                      timeout=10).read().decode()
        samples = obs.parse_prometheus(body)
        if not samples:
            raise ValueError("empty /metrics exposition")
        try:
            resp = urllib.request.urlopen(srv.url("/health"), timeout=10)
            code, hbody = resp.status, resp.read().decode()
        except urllib.error.HTTPError as e:    # 503 while degraded
            code, hbody = e.code, e.read().decode()
        health = json.loads(hbody)
        if health.get("status") not in ("ok", "degraded", "firing"):
            raise ValueError(f"unexpected /health status: {health!r}")
    except Exception as e:
        print(f"metrics probe: FAILED ({e})")
        raise SystemExit(1)
    print(f"metrics probe: OK ({len(samples)} samples, "
          f"/health {code} status={health['status']})")


if __name__ == "__main__":
    main()
