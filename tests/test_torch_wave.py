"""The port's wave scheduler and non-paged continuous batching against the
reference on the CPU, over the same bridged smoke weights (f32; olmo-1b
and xlstm-350m):

  * ``RequestQueue``: fullest-bucket-first packing, the wave each request
    ran in and its bucket, completion tokens, result order, waves, slot
    utilization and tokens out; the up-front ``max_new_tokens >=
    max_len`` error and intake truncation;
  * the non-paged ``ContinuousSession``: its ``can_refill`` geometry and
    admission cost at the frame's shared position, before and after a
    segment and a refill;
  * the non-paged ``ContinuousQueue`` (FIFO and SJF) on a stream with a
    straggler row, midstream refills and frame recycling (the frame
    drains when nothing pending fits and the next starts at 0): tokens,
    each completion's slot and frame, and every counter; the same queue
    standing, round by round with ``wait_for`` and a shed;
  * ``LiveEdgeNode(queue="wave")`` and ``LiveEdgeNode(paged=False)`` under
    the continuous and the standing queue, and ``RAGPipeline``'s wave
    path: answers, contexts, sources, scores and counters;
  * ``repro_torch.launch.serve.main`` and ``cluster_serve.main`` with
    ``--queue wave`` and without ``--paged`` on ``--device cpu``, and
    ``build_cluster`` over the reference's weights slot for slot;
    ``serve --arch whisper-base`` on the reference launcher's weights
    and prompts, whose tokens it prints.

Everything compared is equal exactly (greedy tokens of f32 models whose
logits agree within 1e-4; ``test_torch_generate.py`` holds the engine's
near-tie margins)."""
import ast
import contextlib
import io
import re
import sys
import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_cluster import SLO, _nodes, _slots, world  # noqa: E402,F401
from test_torch_rag import corpus  # noqa: E402,F401

from repro.configs import get_smoke_config  # noqa: E402
from repro.core.cluster import Query as JQuery  # noqa: E402
from repro.launch import cluster_serve as j_serve  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.rag.pipeline import RAGPipeline as JRAG  # noqa: E402
from repro.serving import ContinuousQueue as JQueue  # noqa: E402
from repro.serving import ContinuousSession as JSession  # noqa: E402
from repro.serving import GenerationParams as JGen  # noqa: E402
from repro.serving import RequestQueue as JRequestQueue  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402

from repro_torch import bridge, obs  # noqa: E402
from repro_torch.core.cluster import Query  # noqa: E402
from repro_torch.launch import cluster_serve, serve  # noqa: E402
from repro_torch.rag.pipeline import RAGPipeline  # noqa: E402
from repro_torch.serving import (ContinuousQueue, ContinuousSession,  # noqa: E402
                                 GenerationParams, RequestQueue, ServeEngine)

ARCHS = ("olmo-1b", "xlstm-350m")
VOCAB = 48
# (prompt length, budget): a straggler (budget 12) in row 0 of the first
# frame while short rows refill around it; the frame's shared position
# nears max_len 56 until nothing pending fits, the frame drains, and the
# next starts at 0
STREAM = [(17, 12), (5, 3), (9, 3), (3, 4), (20, 6), (5, 12), (11, 2),
          (2, 5), (14, 3), (6, 12), (4, 10), (8, 12)]
NODE_COUNTERS = ("slots", "waves", "refills", "queries", "drops", "shed",
                 "kv_exhaustions", "tokens_out", "cache_hits", "prefix_hits",
                 "prefix_misses", "prefix_evictions", "remote_contexts",
                 "remote_gold")


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    cfg = get_smoke_config(request.param, max_d_model=64, vocab=VOCAB)
    jparams = JModel(cfg).init_params(jax.random.PRNGKey(5))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return cfg, jparams, params


def _prompt(n, salt):
    return [5 + (7 * i + 3 * salt) % (VOCAB - 5) for i in range(n)]


def _pair(bridged, **kw):
    cfg, jparams, params = bridged
    return (ServeEngine(cfg, params, device="cpu", **kw),
            JEngine(cfg, jparams, **kw))


# ------------------------------------------------------------ RequestQueue


def _wave_run(queue, prompts):
    rids = queue.submit_all(prompts)
    steps = []
    while queue.pending():
        steps.append([c.rid for c in queue.step()])
    outs = queue.run()
    st = queue.stats
    comps = [(queue.result(r).tokens, queue.result(r).prompt_len,
              queue.result(r).bucket, queue.result(r).wave) for r in rids]
    return (steps, list(outs.items()), comps,
            (st.waves, st.requests, st.tokens_out, st.slots_run,
             st.slots_used, st.slot_utilization, len(st.latency_s)))


def test_request_queue_matches_reference(bridged):
    eng, jeng = _pair(bridged, max_len=64, batch_size=3)
    gp, jgp = GenerationParams(max_new_tokens=5), JGen(max_new_tokens=5)
    lengths = [3, 17, 9, 4, 12, 5, 30, 2, 70]        # the last is clipped
    prompts = [_prompt(n, i) for i, n in enumerate(lengths)]
    with pytest.warns(UserWarning, match="truncated-left"):
        ours = _wave_run(RequestQueue(eng, gp), prompts)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = _wave_run(JRequestQueue(jeng, jgp), prompts)
    assert ours == theirs
    steps, _, comps, stats = ours
    assert stats[0] == len(steps) >= 3 and stats[3] == 3 * stats[0]
    assert len({c[2] for c in comps}) >= 3       # several buckets served
    assert comps[-1][1] == 64 - 5                # clipped at intake
    with pytest.raises(ValueError, match="max_new_tokens"):
        RequestQueue(eng, GenerationParams(max_new_tokens=64))


# ------------------------------------------------------- ContinuousSession


def _geometry(sess, grid):
    return [(sess.can_refill(p, b), sess.admission_cost(p, b))
            for p, b in grid]


def test_nonpaged_can_refill_geometry(bridged):
    """``can_refill`` (padded chunks below the shared position, budget
    above it) and the admission cost over a grid, at the frame's start,
    after a segment and after a refill, against the reference's session
    driven through the same calls."""
    eng, jeng = _pair(bridged, max_len=56, batch_size=2, prefill_chunk=8)
    grid = [(p, b) for p in (1, 8, 9, 16, 17, 24, 25, 40)
            for b in (1, 6, 20, 32, 40)]
    runs = []
    for sess in (ContinuousSession(eng, GenerationParams(max_new_tokens=12)),
                 JSession(jeng, JGen(max_new_tokens=12))):
        assert not sess.can_refill(3, 2)            # no frame yet
        sess.begin_frame([_prompt(17, 0), _prompt(5, 1)], [12, 3])
        out = [sess.length, _geometry(sess, grid)]
        out.append(sess.run_segment())
        out += [sess.length, sess.free_slots(), _geometry(sess, grid)]
        sess.refill(1, _prompt(9, 2), 6)
        out += [sess.length, sess.free_slots(), _geometry(sess, grid)]
        out.append(sess.run_segment(drain=True))
        out += [sess.length, sess.active(), sess.pool_fragmentation()]
        sess.release()
        runs.append(out)
    assert runs[0] == runs[1]
    assert runs[0][0] == 24 and runs[0][-2] is False
    fits = [ok for ok, _ in runs[0][1]]
    assert any(fits) and not all(fits)


def _cont_run(queue, stream):
    rids = [queue.submit(_prompt(n, i), b) for i, (n, b) in enumerate(stream)]
    outs = queue.run()
    st = queue.stats
    comps = [(outs[r], queue.result(r).slot, queue.result(r).frame,
              queue.result(r).budget) for r in rids]
    counters = {k: getattr(st, k) for k in st.COUNTERS}
    return comps, counters


@pytest.mark.parametrize("policy", ["fifo", "sjf"])
@pytest.mark.parametrize("stop", ["budget", "eos"])
def test_nonpaged_continuous_queue_matches_reference(bridged, policy, stop):
    eng, jeng = _pair(bridged, max_len=56, batch_size=2, prefill_chunk=8)
    eos = None
    if stop == "eos":
        free, _ = _cont_run(ContinuousQueue(
            eng, GenerationParams(max_new_tokens=12), policy=policy), STREAM)
        eos = free[1][0][1]          # a token the model really emits early
    ours = _cont_run(ContinuousQueue(
        eng, GenerationParams(max_new_tokens=12, eos_id=eos),
        policy=policy), STREAM)
    theirs = _cont_run(JQueue(jeng, JGen(max_new_tokens=12, eos_id=eos),
                              policy=policy), STREAM)
    assert ours == theirs
    comps, counters = ours
    assert counters["frames"] >= 2          # a drained frame recycled
    assert counters["refills"] >= 2         # midstream admissions
    assert counters["admission_skips"] >= 1
    assert counters["prefix_hits"] == counters["cow_forks"] == 0
    # the straggler decodes in frame 1 while other rows refill around it
    assert comps[0][2] == 1 and len([c for c in comps if c[2] == 1]) > 2
    if stop == "budget":
        assert [len(c[0]) for c in comps] == [b for _, b in STREAM]


ROUNDS = [([(6, 6, 3), (3, 2, 0)], 0.0, "all"),
          ([(4, 8, 0), (5, 2, 2), (3, 3, 0)], 0.0, "last"),
          ([(4, 4, 0), (3, 3, 0), (2, 2, 0)], 0.5, "none"),
          ([(7, 5, 0)], 0.0, "all")]


def _stream(q):
    """ROUNDS of (length, budget, prefix_len) submits through a standing
    queue (prefix marks are ignored by a non-paged session); per round
    the unfinished rids and counters, per rid its completion."""
    rounds, rids = [], []
    for reqs, shed, wait in ROUNDS:
        new = [q.submit(_prompt(n, len(rids) + j), b, prefix_len=pl)
               for j, (n, b, pl) in enumerate(reqs)]
        rids += new
        q.set_shed(shed)
        q.run(wait_for={"all": new, "last": new[-1:], "none": []}[wait])
        rounds.append((sorted(q.unfinished()), q.stats.snapshot()))
    q.set_shed(0.0)
    q.close()
    comps = {r: (q.result(r).tokens, q.result(r).slot, q.result(r).frame,
                 q.result(r).shed) for r in rids}
    return rounds, comps, q.stats.snapshot()


def test_nonpaged_standing_queue_matches_reference(bridged):
    eng, jeng = _pair(bridged, max_len=96, batch_size=2, prefill_chunk=8)
    ours = _stream(ContinuousQueue(eng, GenerationParams(max_new_tokens=8),
                                   standing=True))
    theirs = _stream(JQueue(jeng, JGen(max_new_tokens=8), standing=True))
    assert ours == theirs
    rounds, comps, final = ours
    assert any(unfinished for unfinished, _ in rounds[:-1])
    assert final["refills"] >= 3 and final["shed_hint_drops"] >= 1


# ------------------------------------------------------- nodes and the RAG


@pytest.mark.parametrize("queue", ["wave", "continuous", "standing"])
def test_live_nodes_nonpaged_match_reference(world, queue):
    """The olmo-1b + xlstm-350m federated IVF pair with semantic caches,
    non-paged, slot for slot: answers, qualities, contexts, sources and
    counters equal the reference's; a wave slot's latency is its wave's
    finish time."""
    slots, emb = _slots(world)
    runs = {}
    for port in (True, False):
        nodes = _nodes(world, port, ARCHS, queue=queue, paged=False)
        Q = Query if port else JQuery
        out = []
        for j in range(2):
            for n, node in enumerate(nodes):
                qs = [Q(qa.domain, emb[qa.question], qid, qa.question,
                        qa.answer) for qid, qa in slots[n][j]]
                waves0 = node.stats.waves
                res = node.process_slot(qs, SLO)
                out.append(([(r.qid, r.node, r.model, r.answer, r.quality,
                              r.dropped) for r in res],
                            node.last_contexts, node.last_sources))
                if queue == "wave":
                    # one latency per wave: each request finishes with it
                    assert len({r.latency_s for r in res}) == \
                        node.stats.waves - waves0
        stats = [{k: getattr(nd.stats, k) for k in NODE_COUNTERS}
                 for nd in nodes]
        for nd in nodes:
            nd.close()
        runs[port] = (out, stats, [nd.unfinished() for nd in nodes],
                      [(nd.engine.paged, nd.engine.prefill_chunk)
                       for nd in nodes])
    assert runs[True] == runs[False]
    out, stats, unfinished, shapes = runs[True]
    assert unfinished == [0, 0]
    want = None if queue == "wave" else 8
    assert shapes == [(False, want)] * 2
    for st in stats:
        assert st["queries"] == 9 and st["drops"] == 0
        assert st["prefix_hits"] == 0 and st["cache_hits"] >= 2


def test_wave_node_profile_and_reconfigure(world):
    docs, qas, tok, _, node_docs, _ = world
    nodes = _nodes(world, True, ARCHS, queue="wave", paged=False)
    for node in nodes:
        cap = node.profile(calib_queries=3)
        assert cap(1.0) > 0.0 and node.capacity is cap
        node.reconfigure(batch_size=3, prefill_chunk=16)
        assert (node.engine.batch_size, node.engine.prefill_chunk,
                node.engine.paged) == (3, None, False)
        assert node.process_slot([], SLO) == []


def test_rag_pipeline_wave_path_matches_reference(corpus):
    tok, enc, index, jenc, jindex, qs = corpus
    cfg = get_smoke_config("olmo-1b", max_d_model=64, vocab=len(tok))
    jparams = JModel(cfg).init_params(jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    eng = ServeEngine(cfg, params, max_len=160, batch_size=3, device="cpu")
    jeng = JEngine(cfg, jparams, max_len=160, batch_size=3)
    rag = RAGPipeline(enc, index, eng, tok, top_k=2, max_new_tokens=8)
    jrag = JRAG(jenc, jindex, jeng, tok, top_k=2, max_new_tokens=8)
    ours, theirs = rag.answer(qs), jrag.answer(qs)
    assert [(r.question, r.answer, r.contexts) for r in ours] == \
        [(r.question, r.answer, r.contexts) for r in theirs]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.scores, b.scores, atol=1e-5)
    st, jst = rag.last_stats, jrag.last_stats
    assert (st.waves, st.requests, st.tokens_out, st.slot_utilization) == \
        (jst.waves, jst.requests, jst.tokens_out, jst.slot_utilization)
    assert st.waves >= 3


# ------------------------------------------------------------- launchers


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs(arch, capsys):
    got = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "3", "--requests", "7", "--prompt-len",
                      "24", "--new-tokens", "5", "--max-len", "64",
                      "--reference"])
    out = capsys.readouterr().out
    assert "generated 35 tokens for 7 requests" in out
    assert "generate_reference" in out
    assert got["tokens"] == 35 and len(got["outputs"]) == 7
    lengths = [max(1, 24 // (1 + i % 3)) for i in range(7)]
    assert lengths == [24, 12, 8, 24, 12, 8, 24]
    want = [24, 12, 8] if arch == "xlstm-350m" else [32, 16, 8]
    assert sorted(set(got["buckets"]), reverse=True) == want
    assert got["waves"] == 3 and got["slot_utilization"] == 7 / 9
    assert got["generate_tok_s"] > 0 and got["reference_tok_s"] > 0


def test_serve_unported_arch_raises_before_building(monkeypatch):
    """``serve --arch whisper-base --smoke``, the last arch to be ported
    (the test keeps its name from before), runs on ``--device cpu`` on
    the reference launcher's weights (``init_params(PRNGKey(0),
    max_seq=--max-len)``) and prompts: 8 requests in 3 waves, the two it
    prints the reference launcher's tokens.  ``check_ported`` still
    raises, naming A4, for an arch without a port config."""
    from repro.launch import serve as j_launch_serve
    with pytest.raises(NotImplementedError, match="A4"):
        serve.check_ported("no-such-arch")
    arch = "whisper-base"
    cfg = get_smoke_config(arch)
    np_params = jax.tree_util.tree_map(np.asarray, JModel(cfg).init_params(
        jax.random.PRNGKey(0), max_seq=128))
    key = jax.random.PRNGKey(1)
    prompts = [[int(t) for t in jax.random.randint(
        jax.random.fold_in(key, i), (max(1, 16 // (1 + i % 3)),), 5,
        cfg.vocab_size)] for i in range(8)]

    class Bridged(serve.Model):
        def init_params(self, seed=0, device="cuda", max_seq=2048):
            assert (seed, max_seq) == (0, 128)
            return bridge.params_from_numpy(np_params, self.cfg, device)

    monkeypatch.setattr(serve, "Model", Bridged)
    monkeypatch.setattr(serve, "make_prompts", lambda n, L, vocab: prompts)
    got = serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert got["tokens"] == 128 and got["waves"] == 3
    assert all(len(o) == 16 for o in got["outputs"])
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--smoke"])
    with contextlib.redirect_stdout(buf):
        j_launch_serve.main()
    printed = re.findall(r"req(\d): (\[.*\])", buf.getvalue())
    assert [int(i) for i, _ in printed] == [0, 1]
    assert [ast.literal_eval(t) for _, t in printed] == got["outputs"][:2]
    assert "generated 128 tokens for 8 requests" in buf.getvalue()


@pytest.mark.parametrize("queue", ["wave", "continuous"])
def test_build_cluster_nonpaged_one_slot_matches_reference(queue):
    kw = dict(entities=3, batch=2, max_len=192, new_tokens=4, top_k=2,
              seed=0, queue=queue, paged=False)
    theirs = j_serve.build_cluster(2, **kw)
    models = [(n.engine.cfg, bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, n.engine.params), n.engine.cfg,
        device="cpu")) for n in theirs[0]]
    ours = cluster_serve.build_cluster(2, models=models, device="cpu", **kw)
    picks = [ours[1][i] for i in (0, 4, 9, 4, 13)]
    out = {}
    for port, (nodes, _, _, enc, _, _) in ((True, ours), (False, theirs)):
        Q = Query if port else JQuery
        res = []
        for node in nodes:
            qs = [Q(qa.domain, enc.encode([qa.question])[0], 40 + i,
                    qa.question, qa.answer) for i, qa in enumerate(picks)]
            res.append(([(r.qid, r.answer, r.quality, r.dropped)
                         for r in node.process_slot(qs, 1e9)],
                        node.last_contexts, node.last_sources,
                        node.stats.waves, node.stats.refills))
        out[port] = res
    assert out[True] == out[False]
    assert [n.engine.paged for n in ours[0]] == [False, False]


@pytest.mark.parametrize("extra,rounds", [([], "frames"),
                                          (["--queue", "wave"], "waves")],
                         ids=["nonpaged", "wave"])
def test_cluster_serve_main_without_paged(extra, rounds, capsys):
    """The reference's default cluster run (no --paged) and its wave
    variant through the port's main on the CPU."""
    cluster_serve.main(["--smoke", "--nodes", "2", "--slots", "3",
                        "--per-slot", "8", "--device", "cpu"] + extra)
    out = capsys.readouterr().out
    assert "summary:" in out and "replaying 3 slots" in out
    node_lines = [ln for ln in out.splitlines()
                  if ln.startswith("  node ") and "queries in" in ln]
    assert len(node_lines) == 2
    assert all(f" {rounds}, " in ln for ln in node_lines)
    assert ("refills" in node_lines[0]) == (rounds == "frames")
    assert not obs.metrics_enabled()
