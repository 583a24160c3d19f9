"""The port's cluster runtime against the reference's on the CPU, over
the smoke olmo-1b + xlstm-350m cluster of ``test_torch_cluster.py``
(two federated IVF nodes with semantic caches over the paged continuous
queue).

Both runtimes start from the reference identifier's policy (carried
across by ``bridge.policy_from_numpy``) and from pinned node capacities
(2 and 3 queries at the SLO, so Algorithm 1 inflates and reassigns), and
serve the same queries: assignments, results, qualities, ``ppo_updates``
and per-node load are equal, slot by slot, through a PPO update; the
policies' probabilities after it agree within the tolerance of
``test_torch_ppo.py`` (hidden pre-norm biases aligned).  The SLO never
decides a drop (1e9 s), so measured latencies do not enter what is
compared."""
import copy

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_cluster import SLO, _nodes, world  # noqa: E402,F401

from repro.cluster import ClusterRuntime as JRuntime  # noqa: E402
from repro.cluster import LiveWorkload as JWorkload  # noqa: E402
from repro.cluster import replay_trace as j_replay  # noqa: E402
from repro.core.cluster import Query as JQuery  # noqa: E402
from repro.core.identifier import OnlineQueryIdentifier as JIdent  # noqa: E402
from repro.core.inter_node import CapacityFunction as JCap  # noqa: E402
from repro.obs import metrics as j_metrics  # noqa: E402
from repro.obs import slo as j_slo  # noqa: E402
from repro.retrieval.encoder import TextEncoder as JEncoder  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.cluster import (ClusterRuntime, LiveWorkload,  # noqa: E402
                                 replay_trace)
from repro_torch.core import ppo  # noqa: E402
from repro_torch.core.cluster import Query  # noqa: E402
from repro_torch.core.identifier import OnlineQueryIdentifier  # noqa: E402
from repro_torch.core.inter_node import CapacityFunction  # noqa: E402
from repro_torch.core.protocols import SchedulableNode  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.obs import slo  # noqa: E402
from repro_torch.retrieval.encoder import TextEncoder  # noqa: E402

ARCHS = ("olmo-1b", "xlstm-350m")
CAPS = (2e-9, 3e-9)        # k of C(L) = k L: 2 and 3 queries at the SLO
THRESHOLD = 8              # PPO update after the second slot


def _idents(dim):
    theirs = JIdent(dim, 2, seed=0, update_threshold=THRESHOLD)
    ours = OnlineQueryIdentifier(dim, 2, seed=0, update_threshold=THRESHOLD,
                                 device="cpu")
    ours.load_policy(bridge.policy_from_numpy(
        jax.tree_util.tree_map(np.asarray, theirs.params), "cpu"))
    return ours, theirs


def _pin(nodes, cap_cls):
    for node, k in zip(nodes, CAPS):
        node.capacity = cap_cls(k=k, b=0.0, levels=[])


def _record(runtime, log):
    """Keep each slot's assignment and dispatched results."""
    route, dispatch = runtime._route, runtime._dispatch

    def routed(probs, slo_s):
        assign, props = route(probs, slo_s)
        log.append(("assign", assign.tolist(), props.tolist()))
        return assign, props

    def dispatched(queries, assign, slo_s):
        res = dispatch(queries, assign, slo_s)
        log.append(("results", [(r.qid, r.node, r.model, r.answer,
                                 r.quality, r.dropped) for r in res]))
        return res

    runtime._route, runtime._dispatch = routed, dispatched


@pytest.fixture(scope="module")
def runtimes(world):
    """(port runtime, reference runtime, their logs), capacities pinned."""
    dim = TextEncoder(seed=0).dim
    ours_i, theirs_i = _idents(dim)
    out = []
    for port, ident in ((True, ours_i), (False, theirs_i)):
        nodes = _nodes(world, port, ARCHS)
        _pin(nodes, CapacityFunction if port else JCap)
        rt = (ClusterRuntime if port else JRuntime)(nodes, ident, seed=0)
        log = []
        _record(rt, log)
        out.append((rt, log))
    return out


def _queries(world, idx, port):
    _, qas, _, _, _, _ = world
    enc = TextEncoder(seed=0) if port else JEncoder(seed=0)
    Q = Query if port else JQuery
    return [Q(qas[i].domain, enc.encode([qas[i].question])[0], 500 + i,
              qas[i].question, qas[i].answer) for i in idx]


def _slot_fields(m):
    return (m.n_queries, m.per_node_load.tolist(), m.quality_mean,
            m.drop_rate, m.ppo_updates, m.load_imbalance, m.slo_firing)


def test_run_slot_matches_reference(world, runtimes):
    (ours, log_o), (theirs, log_t) = runtimes
    assert all(isinstance(n, SchedulableNode) for n in ours.nodes)
    _, qas, _, _, _, _ = world
    slots = [[(7 * i) % len(qas) for i in range(j * 5, j * 5 + 5)]
             for j in range(3)]
    for j, idx in enumerate(slots):
        m_o = ours.run_slot(_queries(world, idx, True), SLO)
        m_t = theirs.run_slot(_queries(world, idx, False), SLO)
        assert _slot_fields(m_o) == _slot_fields(m_t), j
    assert log_o == log_t
    # 5 queries over capacities 2 + 3: every slot fills both nodes
    assigns = [entry[1] for entry in log_o if entry[0] == "assign"]
    assert all(sorted(np.bincount(a, minlength=2)) == [2, 3]
               for a in assigns)
    assert ours.identifier.updates_done == 1
    assert [m.ppo_updates for m in ours.history] == [0, 1, 1]
    assert ours.identifier.buffered() == theirs.identifier.buffered() == 5
    # the policies after the update (ppo.py tolerance, biases aligned)
    e = np.stack([q.embedding for q in _queries(world, range(12), True)])
    aligned = copy.deepcopy(ours.identifier.policy)
    for layer, want in zip(aligned.layers[:-1],
                           theirs.identifier.params["layers"]):
        layer.b.data.copy_(torch.as_tensor(np.array(want["b"])))
    np.testing.assert_allclose(
        ppo.act_probs(aligned, torch.as_tensor(e, dtype=torch.float32)
                      ).numpy(),
        theirs.identifier.identify(e), rtol=0, atol=1e-4)


def test_replay_trace_matches_reference(world, runtimes):
    (ours, log_o), (theirs, log_t) = runtimes
    _, qas, _, _, _, _ = world
    n0 = len(log_o)
    reports = []
    for rt, wl in ((ours, LiveWorkload(qas, TextEncoder(seed=0), seed=2)),
                   (theirs, JWorkload(qas, JEncoder(seed=0), seed=2))):
        reports.append(
            (replay_trace if rt is ours else j_replay)(
                rt, wl, n_slots=2, slo_s=SLO, base_volume=4,
                trace="uniform", seed=3))
    r_o, r_t = reports
    assert [m.n_queries for m in r_o.slots] == \
        [m.n_queries for m in r_t.slots] == [4, 4]
    assert [_slot_fields(m) for m in r_o.slots] == \
        [_slot_fields(m) for m in r_t.slots]
    assert log_o[n0:] == log_t[n0:]
    s_o, s_t = r_o.summary(), r_t.summary()
    for key in ("slots", "queries", "quality_mean", "drop_rate",
                "load_imbalance", "ppo_updates"):
        assert s_o[key] == s_t[key], key
    with pytest.raises(ValueError):
        replay_trace(ours, LiveWorkload(qas, TextEncoder(seed=0)),
                     n_slots=1, slo_s=SLO, trace="square-wave")


def _forced(runtime, obs_slo, slo_feedback):
    """Telemetry built for slot SLO 1.5 s, node 1's ttft objective forced
    FIRING: (capacities, shed hints, health)."""
    runtime.slo_feedback = slo_feedback
    runtime.monitors = {}
    runtime.store = None
    runtime._ensure_telemetry(1.5)
    runtime.monitors[1].states["ttft_p95"].status = obs_slo.FIRING
    caps = runtime._capacities(1.5).tolist()
    runtime._apply_shed_hints()
    hints = [n.shed_fraction for n in runtime.nodes]
    health = runtime.health()
    for n in runtime.nodes:
        n.shed_fraction = 0.0
    runtime.monitors = {}
    runtime.store = None
    runtime.slo_feedback = True
    return caps, hints, health


@pytest.mark.parametrize("slo_feedback", [True, False],
                         ids=["feedback", "no-feedback"])
def test_firing_node_is_penalized_like_reference(runtimes, slo_feedback):
    (ours, _), (theirs, _) = runtimes
    got = _forced(ours, slo, slo_feedback)
    want = _forced(theirs, j_slo, slo_feedback)
    assert got == want
    caps, hints, health = got
    base = [n.capacity(1.5) for n in ours.nodes]
    if slo_feedback:
        assert caps == pytest.approx([base[0], base[1] * 0.25])
        assert hints == [0.0, 0.25]
    else:
        assert caps == pytest.approx(base) and hints == [0.0, 0.0]
    assert health["status"] == "degraded" and health["firing_nodes"] == ["1"]


# queue-level pushes of ContinuousQueue (counters and end-of-run gauges)
QUEUE_KEYS = ("queue_", "kv_pool_", "prefix_cache_")


def test_metric_pushes_match_reference(world, runtimes):
    """One slot with metrics enabled in both packages: the same registry
    keys, the queue's included, the same deterministic counts and gauges,
    and an SLO evaluation per node."""
    (ours, _), (theirs, _) = runtimes
    snaps = []
    for rt, m, port in ((ours, metrics, True), (theirs, j_metrics, False)):
        m.registry().reset()
        m.enable_metrics(True)
        try:
            rt.run_slot(_queries(world, [3, 11, 19, 27, 35], port), SLO)
            snaps.append(m.registry().snapshot())
        finally:
            m.enable_metrics(False)
            m.registry().reset()
            rt.monitors, rt.store = {}, None
    ours_s, theirs_s = snaps
    assert sorted(ours_s) == sorted(theirs_s)
    assert any(k.startswith("node_ttft_s") for k in ours_s)
    assert sum(1 for k in ours_s if k.startswith(QUEUE_KEYS)) >= 15
    for key, v in theirs_s.items():
        if key.startswith(("node_queries", "node_drops", "node_shed",
                           "node_kv_exhaustions", "node_tokens_out",
                           "ppo_updates", "node_assigned_share",
                           "node_capacity_queries", "node_slo_firing",
                           "semantic_cache_hit_rate") + QUEUE_KEYS) \
                and not isinstance(v, dict):
            assert ours_s[key] == v, key
        elif isinstance(v, dict):
            assert ours_s[key]["count"] == v["count"], key
    assert ours.history[-1].slo_firing == theirs.history[-1].slo_firing == 0
