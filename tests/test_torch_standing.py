"""The port's standing engine against the reference on the CPU: one
long-lived paged ``ContinuousQueue`` session across ``run()`` calls, on
bridged olmo-1b and xlstm-350m smoke models (f32), and a standing
``LiveEdgeNode`` pair with ``reconfigure``.

The paged cases of ``tests/test_standing_engine.py``: the straddling
3-slot ``wait_for`` schedule gives the tokens of the reference's solo
``generate_reference`` (the port has no ``generate_reference``) in one
frame, frames stay flat on a steady stream, a mid-frame shed drops the
pending tail without draining the frame, ``wait_for`` needs standing, and
the stats and depth accounting.  Then the port's standing queue and the
reference's on one stream (forks of a shared prefix, a shed, straddles):
tokens, completion slots and frames, frames, refills, forks and shed rids
equal; and two standing federated nodes, slot for slot, before and after
``reconfigure``."""
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_cluster import SLO, _nodes, _slots, world  # noqa: E402,F401

from repro.configs import get_smoke_config  # noqa: E402
from repro.core.cluster import Query as JQuery  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serving import ContinuousQueue as JQueue  # noqa: E402
from repro.serving import GenerationParams as JGen  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.core.cluster import Query  # noqa: E402
from repro_torch.serving import (ContinuousQueue, ContinuousStats,  # noqa: E402
                                 GenerationParams, ServeEngine)

ARCHS = ("olmo-1b", "xlstm-350m")
KW = dict(max_len=96, batch_size=2, prefill_chunk=8, paged=True,
          block_size=16)
PROMPTS = [[1, 2, 3, 4, 5, 6], [7, 8, 9], [11, 12, 13, 14],
           [3, 1, 4, 1, 5], [9, 2, 6]]
BUDGETS = [6, 2, 8, 4, 5]


@pytest.fixture(scope="module", params=ARCHS)
def engines(request):
    """(port engine, reference engine) over the same weights."""
    cfg = get_smoke_config(request.param, max_d_model=64)
    jparams = JModel(cfg).init_params(jax.random.PRNGKey(0), max_seq=96)
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return (ServeEngine(cfg, params, device="cpu", **KW),
            JEngine(cfg, jparams, **KW))


def reference_solo(jeng, prompt, budget):
    gp = JGen(max_new_tokens=budget)
    return jeng.generate_reference([prompt], gen=gp)[0][:budget]


def test_standing_stream_parity(engines):
    """Slot by slot, with a request left straddling a slot boundary
    mid-decode: the tokens of a solo reference run, in one frame."""
    eng, jeng = engines
    refs = [reference_solo(jeng, p, b) for p, b in zip(PROMPTS, BUDGETS)]
    q = ContinuousQueue(eng, GenerationParams(max_new_tokens=8),
                        standing=True)
    r0 = q.submit(PROMPTS[0], BUDGETS[0])
    r1 = q.submit(PROMPTS[1], BUDGETS[1])
    q.run(wait_for=[r0, r1])
    # the long request (budget 8) keeps its row into the next slot
    r2 = q.submit(PROMPTS[2], BUDGETS[2])
    r3 = q.submit(PROMPTS[3], BUDGETS[3])
    q.run(wait_for=[r3])
    assert r2 in q.unfinished()
    r4 = q.submit(PROMPTS[4], BUDGETS[4])
    q.run(wait_for=[r2, r4])
    assert q.unfinished() == []
    for rid, ref in zip([r0, r1, r2, r3, r4], refs):
        assert q.result(rid).tokens == ref, rid
    assert q.stats.frames == 1
    q.close()
    assert q._session is None


def test_frames_flat_on_steady_stream(engines):
    """A steady stream stays in ONE warm frame, every later request
    admitted by refill, and close() returns every pool block."""
    eng, _ = engines
    q = ContinuousQueue(eng, GenerationParams(max_new_tokens=4),
                        standing=True)
    n_slots = 6
    for s in range(n_slots):
        rids = [q.submit([s + 1, j + 2, 5], 3) for j in range(2)]
        q.run(wait_for=rids)
    assert q.stats.frames == 1
    assert q.stats.refills >= 2 * n_slots - eng.batch_size
    sess = q._session
    q.close()
    assert sess.allocator.available == eng.num_blocks
    assert (sess.allocator.refcount == 0).all()


def test_midframe_shed_and_recovery(engines):
    """A shed hint drops the pending tail at the next run() while the
    straddling row keeps decoding; clearing it costs no frame restart and
    the straggler finishes with the reference's tokens."""
    eng, jeng = engines
    ref_long = reference_solo(jeng, [1, 2, 3], 8)
    q = ContinuousQueue(eng, GenerationParams(max_new_tokens=8),
                        standing=True)
    r_short = q.submit([4, 5, 6], 2)
    r_long = q.submit([1, 2, 3], 8)
    q.run(wait_for=[r_short])
    assert r_long in q.unfinished()
    frames_before = q.stats.frames
    q.set_shed(1.0)
    shed_rids = [q.submit([7, 8], 4), q.submit([9, 1], 4)]
    q.run(wait_for=shed_rids)
    for rid in shed_rids:
        c = q.result(rid)
        assert c.shed and c.tokens == []
    assert q.stats.shed_hint_drops == 2
    assert r_long in q.unfinished()
    assert q.stats.frames == frames_before
    q.set_shed(0.0)
    r_new = q.submit([2, 4, 6], 3)
    q.run(wait_for=[r_long, r_new])
    assert q.result(r_long).tokens == ref_long
    assert len(q.result(r_new).tokens) == 3
    assert not q.result(r_new).shed
    assert q.stats.frames == frames_before
    q.close()


def test_wait_for_requires_standing(engines):
    eng, _ = engines
    q = ContinuousQueue(eng, GenerationParams(max_new_tokens=3))
    rid = q.submit([1, 2, 3], 2)
    with pytest.raises(ValueError, match="standing"):
        q.run(wait_for=[rid])


def test_ttft_and_latency_are_arrival_anchored(engines):
    eng, _ = engines
    q = ContinuousQueue(eng, GenerationParams(max_new_tokens=3),
                        standing=True)
    rid = q.submit([1, 2, 3], 3)
    wait = 0.05
    time.sleep(wait)
    q.run(wait_for=[rid])
    c = q.result(rid)
    assert c.ttft_s >= wait and c.done_s >= c.ttft_s
    assert q.stats.ttft_s[-1] == c.ttft_s
    q.close()


def test_stats_snapshot_delta():
    st_ = ContinuousStats()
    st_.requests, st_.tokens_out, st_.frames = 3, 12, 1
    st_.ttft_s, st_.latency_s = [0.1, 0.2], [0.3, 0.4]
    base = st_.snapshot()
    st_.requests += 2
    st_.tokens_out += 7
    st_.refills += 4
    st_.ttft_s += [0.5]
    st_.latency_s += [0.6, 0.7]
    d = st_.delta(base)
    assert (d.requests, d.tokens_out, d.frames, d.refills) == (2, 7, 0, 4)
    assert d.ttft_s == [0.5] and d.latency_s == [0.6, 0.7]
    full = st_.delta(ContinuousStats().snapshot())
    assert full.requests == st_.requests and full.ttft_s == st_.ttft_s


def test_depth_and_oldest_wait(engines):
    eng, _ = engines
    q = ContinuousQueue(eng, GenerationParams(max_new_tokens=2),
                        standing=True)
    assert q.depth() == 0 and q.oldest_wait_s() == 0.0
    r0 = q.submit([1, 2], 2)
    q.submit([3, 4], 2)
    assert q.depth() == 2 and q.oldest_wait_s() > 0.0
    q.run(wait_for=[r0])
    assert q.depth() == q.pending() + len(q._owner)
    q.run()
    assert q.depth() == 0 and q.oldest_wait_s() == 0.0
    q.close()


CTX = [5, 6, 7, 2, 3, 4, 1, 2, 9, 9, 3]          # 11 tokens: mid-block tail
# rounds of (submits as (prompt, budget, prefix_len), shed fraction,
# which of the round's rids to wait for: "all", "last" or "none")
ROUNDS = [
    ([(CTX + [14, 4, 1], 7, len(CTX)), ([8, 30, 2, 19, 7], 2, 0)],
     0.0, "all"),
    ([(CTX + [7, 8, 2, 40], 8, len(CTX)), ([21, 3, 3, 17], 2, 0),
      (CTX + [9, 1, 5], 3, len(CTX))], 0.0, "last"),
    ([([12, 33, 6, 7], 4, 0), ([2, 4, 6], 3, 0), ([9, 9], 2, 0)],
     0.5, "none"),
    ([(CTX + [14, 4, 1], 5, len(CTX))], 0.0, "all"),
]


def _stream(q):
    """Drive ROUNDS through a standing queue; returns per round the
    unfinished rids and the stats snapshot, and per rid its completion
    (tokens, slot, frame, shed)."""
    rounds, rids = [], []
    for reqs, shed, wait in ROUNDS:
        new = [q.submit(p, b, prefix_len=pl) for p, b, pl in reqs]
        rids += new
        q.set_shed(shed)
        q.run(wait_for={"all": new, "last": new[-1:], "none": []}[wait])
        rounds.append((sorted(q.unfinished()), q.stats.snapshot()))
    q.set_shed(0.0)
    q.close()
    comps = {r: (q.result(r).tokens, q.result(r).slot, q.result(r).frame,
                 q.result(r).shed) for r in rids}
    return rounds, comps, q.stats.snapshot()


def test_standing_queue_matches_reference(engines):
    """One stream with forks of a shared prefix (a copy-on-write tail;
    on xlstm-350m a row-state snapshot), a straddling row, a shed round
    that leaves rows mid-decode and a last round that forks again:
    every round's unfinished rids and counters, and every completion's
    tokens, slot, frame and shed flag, equal the reference's."""
    eng, jeng = engines
    ours = _stream(ContinuousQueue(eng, GenerationParams(max_new_tokens=8),
                                   standing=True))
    theirs = _stream(JQueue(jeng, JGen(max_new_tokens=8), standing=True))
    assert ours == theirs
    rounds, comps, final = ours
    assert any(unfinished for unfinished, _ in rounds[:-1])
    assert final["frames"] == 1 and final["refills"] >= 5
    assert final["cow_forks"] >= 1 and final["prefix_hits"] >= 2
    assert sum(c[3] for c in comps.values()) == final["shed_hint_drops"] >= 1


NODE_COUNTERS = ("slots", "waves", "refills", "queries", "drops", "shed",
                 "kv_exhaustions", "tokens_out", "cache_hits", "prefix_hits",
                 "prefix_misses", "prefix_evictions", "remote_contexts",
                 "remote_gold")


def test_standing_nodes_match_reference(world):
    """Two federated IVF nodes (olmo-1b + xlstm-350m) with standing
    queues, slot for slot: answers, contexts, sources and counters equal
    the reference's, one frame per node across both slots; then
    ``reconfigure`` (batch 3, chunk 16) drains, rebuilds and serves the
    next slot alike; nothing is left unfinished after close()."""
    slots, emb = _slots(world)
    runs = {}
    for port in (True, False):
        nodes = _nodes(world, port, ARCHS, queue="standing")
        Q = Query if port else JQuery
        out = []

        def serve(j):
            for n, node in enumerate(nodes):
                qs = [Q(qa.domain, emb[qa.question], qid, qa.question,
                        qa.answer) for qid, qa in slots[n][j]]
                res = node.process_slot(qs, SLO)
                out.append(([(r.qid, r.node, r.model, r.answer, r.quality,
                              r.dropped) for r in res],
                            node.last_contexts, node.last_sources,
                            node.unfinished()))

        serve(0)
        serve(1)
        frames = [nd.stats.waves for nd in nodes]
        for nd in nodes:
            nd.reconfigure(batch_size=3, prefill_chunk=16)
        shapes = [(nd.engine.batch_size, nd.engine.prefill_chunk)
                  for nd in nodes]
        serve(0)
        stats = [{k: getattr(nd.stats, k) for k in NODE_COUNTERS}
                 for nd in nodes]
        for nd in nodes:
            nd.close()
        runs[port] = (out, frames, shapes, stats,
                      [nd.unfinished() for nd in nodes])
    assert runs[True] == runs[False]
    out, frames, shapes, stats, unfinished = runs[True]
    assert frames == [1, 1] and shapes == [(3, 16), (3, 16)]
    assert unfinished == [0, 0]
    assert all(st["prefix_hits"] >= 1 and st["refills"] >= 3
               for st in stats)
