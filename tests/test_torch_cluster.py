"""The port's cluster path against the reference on the CPU: the modules
copied from it (semantic query cache, edge-data partition, answer
quality), sketch-routed federated retrieval over IVF shards, the
ContinuousQueue additions the live node needs (shed hint, snapshot /
delta), and two federated IVF smoke nodes with semantic caches over the
paged continuous queue, slot for slot: two olmo-1b nodes, and the
quickstart's pair, olmo-1b (node 0) + xlstm-350m (node 1).

The reference's IVF shards run their kernel path (``use_pallas=True``,
the Pallas kernel in interpret mode on the CPU), which orders exact ties
as the port's kernel does; a reference node's index is switched to it
after construction (an attribute of the test's object).  Everything
compared here is equal exactly: ids, texts, answers, qualities, flags
and counters."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.cluster import LiveEdgeNode as JNode  # noqa: E402
from repro.cluster import enable_federation as j_enable  # noqa: E402
from repro.cluster.federation import FederatedRetriever as JFed  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.core.cluster import Query as JQuery  # noqa: E402
from repro.data.corpus import generate_corpus as j_corpus  # noqa: E402
from repro.data.partition import coverage_matrix as j_coverage  # noqa: E402
from repro.data.partition import partition_edge_data as j_partition  # noqa: E402
from repro.data.tokenizer import Tokenizer as JTokenizer  # noqa: E402
from repro.metrics.text import composite_quality as j_quality  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.retrieval.cache import SemanticQueryCache as JCache  # noqa: E402
from repro.retrieval.encoder import TextEncoder as JEncoder  # noqa: E402
from repro.retrieval.ivf import IVFIndex as JIVFIndex  # noqa: E402
from repro.serving import ContinuousQueue as JQueue  # noqa: E402
from repro.serving import GenerationParams as JGen  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.cluster import (FederatedRetriever, LiveEdgeNode,  # noqa: E402
                                 enable_federation)
from repro_torch.core.cluster import Query  # noqa: E402
from repro_torch.data.corpus import DOMAINS  # noqa: E402
from repro_torch.data.corpus import generate_corpus  # noqa: E402
from repro_torch.data.partition import (coverage_matrix,  # noqa: E402
                                        partition_edge_data)
from repro_torch.data.tokenizer import Tokenizer  # noqa: E402
from repro_torch.metrics.text import composite_quality  # noqa: E402
from repro_torch.retrieval.cache import SemanticQueryCache  # noqa: E402
from repro_torch.retrieval.encoder import TextEncoder  # noqa: E402
from repro_torch.retrieval.ivf import IVFIndex  # noqa: E402
from repro_torch.serving import (ContinuousQueue, GenerationParams,  # noqa: E402
                                 ServeEngine)

SLO = 1e9          # the wall clock never decides a drop in these tests
NODE_COUNTERS = ("slots", "waves", "refills", "queries", "drops", "shed",
                 "kv_exhaustions", "tokens_out", "cache_hits", "prefix_hits",
                 "prefix_misses", "prefix_evictions", "remote_contexts",
                 "remote_gold")


@pytest.fixture(scope="module")
def world():
    """build_cluster's recipe (cluster_serve.py) at 8 entities, 2 nodes."""
    docs, qas = generate_corpus(8, seed=0)
    jdocs, _ = j_corpus(8, seed=0)
    texts = [d.text for d in docs] + [qa.question for qa in qas] \
        + ["context question answer <sep>"]
    tok = Tokenizer.build(texts)
    assert tok.vocab == JTokenizer.build(texts).vocab
    prim = [[d for d in range(len(DOMAINS)) if d % 2 == n] for n in range(2)]
    node_docs = partition_edge_data(docs, 2, prim, seed=0)
    j_node_docs = j_partition(jdocs, 2, prim, seed=0)
    return docs, qas, tok, prim, node_docs, j_node_docs


# ------------------------------------------------------------ copied modules


def test_partition_and_coverage_match_reference(world):
    _, _, _, _, node_docs, j_node_docs = world
    assert [[d.doc_id for d in n] for n in node_docs] == \
        [[d.doc_id for d in n] for n in j_node_docs]
    np.testing.assert_array_equal(coverage_matrix(node_docs, len(DOMAINS)),
                                  j_coverage(j_node_docs, len(DOMAINS)))


def test_semantic_cache_matches_reference():
    """Hits, misses, in-place dedup and LRU eviction over one sequence of
    lookups and inserts (capacity 3, near-duplicates above 0.98)."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((6, 16)).astype(np.float32)
    ours, theirs = SemanticQueryCache(capacity=3), JCache(capacity=3)
    events = []
    for step, j in enumerate([0, 1, 0, 2, 3, 1, 4, 0, 5, 2, 2, 3]):
        emb = base[j] + (1e-3 * step if step % 3 == 0 else 0.0)
        got = [ours.lookup(emb), theirs.lookup(emb)]
        assert got[0] == got[1], step
        if got[0] is None:
            ours.insert(emb, j)
            theirs.insert(emb, j)
        events.append(got[0])
        assert (ours.hits, ours.misses, ours.evictions, len(ours)) == \
            (theirs.hits, theirs.misses, theirs.evictions, len(theirs))
    assert ours.evictions >= 1 and ours.hits >= 2
    assert ours.hit_rate == theirs.hit_rate
    ours.clear()
    assert (len(ours), ours.hits, ours.misses) == (0, 0, 0)


@pytest.mark.parametrize("pair", [
    ("the route of heritage trav3 is summit lagoon .",
     "the route of heritage trav3 is summit lagoon ."),
    ("summit lagoon", "the route of heritage trav3 is summit lagoon ."),
    ("<unk> <unk> of", "the visa of bazaar trav1 is island voyage ."),
    ("", "the visa of bazaar trav1 is island voyage ."),
], ids=["exact", "partial", "unk", "empty"])
def test_composite_quality_matches_reference(pair):
    assert composite_quality(*pair) == j_quality(*pair)


# --------------------------------------------------------------- federation


class _Shard:
    def __init__(self, node_id, index):
        self.node_id = node_id
        self.index = index


def test_federated_retriever_matches_reference(world):
    """Three IVF shards (domain d on shard d % 3): routes, merged
    contexts, their sources and the federation counters."""
    docs, qas, _, _, _, _ = world
    enc, jenc = TextEncoder(seed=0), JEncoder(seed=0)
    ours, theirs = [], []
    for n in range(3):
        texts = [d.text for d in docs if d.domain % 3 == n]
        emb = enc.encode(texts)
        np.testing.assert_array_equal(emb, jenc.encode(texts))
        a = IVFIndex(enc.dim, nprobe=2, device="cpu")
        b = JIVFIndex(enc.dim, nprobe=2, use_pallas=True)
        a.add(emb, texts)
        b.add(emb, texts)
        ours.append(_Shard(n, a))
        theirs.append(_Shard(n, b))
    fed = FederatedRetriever(ours, fanout=2, n_centroids=4, seed=0)
    jfed = JFed(theirs, fanout=2, n_centroids=4, seed=0)
    embs = enc.encode([qa.question for qa in qas[::2]])
    for origin in range(3):
        assert fed.route(origin, embs) == jfed.route(origin, embs)
        got = fed.retrieve(origin, embs, 3)
        assert got == jfed.retrieve(origin, embs, 3)
    assert vars(fed.stats) == vars(jfed.stats)
    assert fed.stats.remote_contexts > 0


# ---------------------------------------------------------------- scheduler


@pytest.fixture(scope="module")
def small_model():
    cfg = get_smoke_config("olmo-1b", max_d_model=64, vocab=48)
    jparams = JModel(cfg).init_params(jax.random.PRNGKey(3))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return cfg, jparams, params


def test_queue_shed_hint_and_stats_deltas_match_reference(small_model):
    """Two intervals on one queue of each kind: the first sheds 40% of
    its pending tail, the second none.  The shed flags, the tokens of
    the served requests, every snapshot and every delta agree."""
    cfg, jparams, params = small_model
    kw = dict(max_len=64, batch_size=2, prefill_chunk=8, paged=True,
              block_size=8)
    ours = ContinuousQueue(ServeEngine(cfg, params, device="cpu", **kw),
                           GenerationParams(max_new_tokens=5))
    theirs = JQueue(JEngine(cfg, jparams, **kw), JGen(max_new_tokens=5))
    ctx = [5, 6, 7, 2, 3, 4, 1, 2, 9]
    intervals = [([ctx + [14, 4], [8, 30, 2, 19], ctx + [7, 8, 2],
                   [12, 33, 6], ctx + [9, 1]], 0.4),
                 ([[21, 3, 3, 17], ctx + [40, 2]], 0.0)]
    for prompts, shed in intervals:
        snaps = []
        for q in (ours, theirs):
            base = q.stats.snapshot()
            rids = [q.submit(p, prefix_len=len(ctx) if p[:9] == ctx else 0)
                    for p in prompts]
            q.set_shed(shed)
            q.run()
            comps = [q.pop_result(r) for r in rids]
            d = q.stats.delta(base)
            snaps.append((base, [(c.shed, c.tokens) for c in comps],
                          {k: getattr(d, k) for k in d.COUNTERS},
                          len(d.ttft_s), len(d.latency_s)))
        assert snaps[0] == snaps[1]
        assert snaps[0][2]["shed_hint_drops"] == int(len(prompts) * shed)
    assert ours.stats.snapshot() == theirs.stats.snapshot()
    with pytest.raises(KeyError):
        ours.pop_result(0)


# ------------------------------------------------------------ live nodes


def _nodes(world, port: bool, archs, queue: str = "continuous", **over):
    """Two federated IVF smoke nodes of ``archs`` with semantic caches
    over the paged ``queue`` (build_cluster's knobs, reduced; ``over``
    replaces any of them)."""
    docs, qas, tok, prim, node_docs, j_node_docs = world
    kw = dict(batch_size=2, max_len=192, top_k=2, max_new_tokens=6,
              index_kind="ivf", queue=queue, prefill_chunk=8,
              paged=True, block_size=8)
    kw.update(over)
    nodes = []
    for n, arch in enumerate(archs):
        cfg = get_smoke_config(arch, max_d_model=32, vocab=len(tok))
        jparams = JModel(cfg).init_params(jax.random.PRNGKey(n),
                                          max_seq=192)
        if port:
            params = bridge.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, jparams), cfg,
                device="cpu")
            nodes.append(LiveEdgeNode(
                n, arch, cfg, params, node_docs[n], tok,
                TextEncoder(seed=0), seed=10 * n, cache=SemanticQueryCache(),
                device="cpu", **kw))
        else:
            node = JNode(n, arch, cfg, jparams, j_node_docs[n],
                         JTokenizer(tok.vocab), JEncoder(seed=0),
                         seed=10 * n, cache=JCache(), **kw)
            node.index.use_pallas = True
            nodes.append(node)
    (enable_federation if port else j_enable)(nodes, fanout=2,
                                              n_centroids=8, seed=0)
    return nodes


def _slots(world):
    """Per node, two slots of questions from every domain; the second
    repeats two of the first's (semantic-cache hits) and each slot asks
    one question twice (a shared-prefix fork)."""
    _, qas, _, _, _, _ = world
    enc = TextEncoder(seed=0)
    slots = []
    for n in range(2):
        pick = [qas[(7 * i + 3 * n) % len(qas)] for i in range(7)]
        s1 = [pick[0], pick[1], pick[2], pick[1]]
        s2 = [pick[0], pick[3], pick[2], pick[4], pick[4]]
        slots.append([[(qid, qa) for qid, qa in
                       enumerate(s, start=100 * n + 10 * j)]
                      for j, s in enumerate((s1, s2))])
    emb = {qa.question: enc.encode([qa.question])[0] for qa in qas}
    return slots, emb


@pytest.mark.parametrize("archs", [("olmo-1b", "olmo-1b"),
                                   ("olmo-1b", "xlstm-350m")],
                         ids=["olmo+olmo", "olmo+xlstm"])
def test_live_nodes_match_reference(world, archs):
    slots, emb = _slots(world)
    runs = {}
    for port in (True, False):
        nodes = _nodes(world, port, archs)
        Q = Query if port else JQuery
        out = []
        for j in range(2):
            for n, node in enumerate(nodes):
                qs = [Q(qa.domain, emb[qa.question], qid, qa.question,
                        qa.answer) for qid, qa in slots[n][j]]
                res = node.process_slot(qs, SLO)
                out.append(([(r.qid, r.node, r.model, r.answer, r.quality,
                              r.dropped) for r in res],
                            node.last_contexts, node.last_sources))
        stats = [{k: getattr(nd.stats, k) for k in NODE_COUNTERS}
                 for nd in nodes]
        runs[port] = (out, stats, vars(nodes[0].federation.stats))
    ours, theirs = runs[True], runs[False]
    for a, b in zip(ours[0], theirs[0]):
        assert a == b
    assert ours[1] == theirs[1]
    assert ours[2] == theirs[2]
    for st in ours[1]:
        assert st["cache_hits"] >= 2 and st["prefix_hits"] >= 1
        assert st["drops"] == 0 and st["queries"] == 9
    assert sum(st["remote_contexts"] for st in ours[1]) > 0


def test_live_node_paths_not_ported_raise(world):
    docs, qas, tok, _, node_docs, _ = world
    cfg = get_smoke_config("olmo-1b", max_d_model=32, vocab=len(tok))
    from repro_torch.models import Model
    params = Model(cfg).init_params(seed=0, device="cpu")
    args = (0, "olmo-1b", cfg, params, node_docs[0], tok,
            TextEncoder(seed=0))
    # the wave queue and the non-paged engine build nodes now (ported
    # with the non-paged engine); wave nodes ignore paged, as in the
    # reference: (queue kind, engine paged, engine chunk)
    for kw, want in (({"queue": "wave", "paged": True}, ("wave", False,
                                                         None)),
                     ({}, ("continuous", False, 32)),
                     ({"queue": "standing"}, ("standing", False, 32))):
        built = LiveEdgeNode(*args, device="cpu", **kw)
        assert (built.queue_kind, built.engine.paged,
                built.engine.prefill_chunk) == want
    with pytest.raises(ValueError):
        LiveEdgeNode(*args, device="cpu", queue="batch", paged=True)
    node = LiveEdgeNode(*args, device="cpu", paged=True, max_len=128)
    node.reconfigure(batch_size=2)
    assert node.engine.batch_size == 2
    assert node.process_slot([], SLO) == []
    assert node.unfinished() == 0
    cap = node.profile(calib_queries=2)
    assert cap(1.0) >= 1.0 and node.capacity is cap
