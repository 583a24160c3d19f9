"""The port's slice end to end against the reference: the same corpus,
tokenizer and encoder, FlatIndex retrieval (ids exact, scores within
1e-5: f32 dot products of unit vectors summed in another order), and
RAGPipeline.answer on a paged engine (prefill chunk 8, block 8) over the
same bridged olmo-1b smoke weights -- the same answers, string for
string."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.data.corpus import generate_corpus as j_corpus  # noqa: E402
from repro.data.tokenizer import Tokenizer as JTokenizer  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.rag.pipeline import RAGPipeline as JRAG  # noqa: E402
from repro.retrieval.encoder import TextEncoder as JEncoder  # noqa: E402
from repro.retrieval.index import FlatIndex as JFlatIndex  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.data.corpus import generate_corpus  # noqa: E402
from repro_torch.data.tokenizer import Tokenizer  # noqa: E402
from repro_torch.rag.pipeline import RAGPipeline  # noqa: E402
from repro_torch.retrieval.encoder import TextEncoder  # noqa: E402
from repro_torch.retrieval.index import FlatIndex  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402


@pytest.fixture(scope="module")
def corpus():
    docs, qas = generate_corpus(3, seed=0)
    jdocs, jqas = j_corpus(3, seed=0)
    assert [(d.doc_id, d.text) for d in docs] == \
        [(d.doc_id, d.text) for d in jdocs]
    assert [(q.question, q.answer) for q in qas] == \
        [(q.question, q.answer) for q in jqas]
    texts = [d.text for d in docs] + [q.question for q in qas]
    tok, jtok = Tokenizer.build(texts), JTokenizer.build(texts)
    assert tok.vocab == jtok.vocab
    enc, jenc = TextEncoder(seed=0), JEncoder(seed=0)
    emb = enc.encode([d.text for d in docs])
    np.testing.assert_array_equal(emb, jenc.encode([d.text for d in docs]))
    index = FlatIndex(enc.dim, device="cpu")
    index.add(emb, [d.text for d in docs])
    jindex = JFlatIndex(jenc.dim)
    jindex.add(emb, [d.text for d in docs])
    # five distinct questions, then two repeats: repeats fork the cached
    # retrieved-context prefix
    qs = [q.question for q in qas[::4]][:5]
    qs += [qs[1], qs[2]]
    return tok, enc, index, jenc, jindex, qs


def test_flat_index_matches_reference(corpus):
    _, enc, index, _, jindex, qs = corpus
    q_emb = enc.encode(qs)
    s, i = index.search(q_emb, 3)
    s2, i2 = jindex.search(q_emb, 3)
    np.testing.assert_array_equal(i, i2)
    np.testing.assert_allclose(s, s2, rtol=0, atol=1e-5)
    assert i.dtype == np.int32


def test_rag_answers_match_reference(corpus):
    tok, enc, index, jenc, jindex, qs = corpus
    cfg = get_smoke_config("olmo-1b", max_d_model=64, vocab=len(tok))
    jparams = JModel(cfg).init_params(jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    kw = dict(max_len=256, batch_size=2, prefill_chunk=8, paged=True,
              block_size=8)
    ours = RAGPipeline(enc, index, ServeEngine(cfg, params, device="cpu",
                                               **kw),
                       tok, top_k=2, max_new_tokens=6)
    theirs = JRAG(jenc, jindex, JEngine(cfg, jparams, **kw), tok, top_k=2,
                  max_new_tokens=6)
    got, want = ours.answer(qs), theirs.answer(qs)
    assert [r.answer for r in got] == [r.answer for r in want]
    assert [r.contexts for r in got] == [r.contexts for r in want]
    assert ours.last_stats.prefix_hits == theirs.last_stats.prefix_hits >= 1
    assert all(r.answer for r in got)


def _spans(rec):
    """The recorder's spans and events with trace ids renamed by first
    appearance, ids by record order, and times dropped."""
    events = rec.events()
    pos = {e["id"]: i for i, e in enumerate(events)}
    names = {}
    return [(e["kind"], names.setdefault(e["trace"], f"t{len(names)}"),
             e["name"], None if e["parent"] is None else pos[e["parent"]],
             e.get("attrs")) for e in events]


def test_traced_rag_with_semantic_cache_matches_reference(corpus):
    """RAGPipeline with a semantic query cache, traced in both packages:
    the same answers, contexts, cache hits and scores (within 1e-5), and
    the same request trees (``request`` > ``retrieve`` with its
    ``semantic_cache`` events, ``queue_wait``, ``prefill``, decode spans,
    ``detokenize``)."""
    from repro import obs as j_obs
    from repro.retrieval.cache import SemanticQueryCache as JCache

    from repro_torch import obs
    from repro_torch.retrieval.cache import SemanticQueryCache
    tok, enc, index, jenc, jindex, qs = corpus
    cfg = get_smoke_config("olmo-1b", max_d_model=32, vocab=len(tok))
    jparams = JModel(cfg).init_params(jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    kw = dict(max_len=256, batch_size=2, prefill_chunk=8, paged=True,
              block_size=8)
    ours = RAGPipeline(enc, index, ServeEngine(cfg, params, device="cpu",
                                               **kw),
                       tok, top_k=2, max_new_tokens=4,
                       cache=SemanticQueryCache())
    theirs = JRAG(jenc, jindex, JEngine(cfg, jparams, **kw), tok, top_k=2,
                  max_new_tokens=4, cache=JCache())
    runs = []
    for rag, o in ((ours, obs), (theirs, j_obs)):
        rec = o.enable()
        try:
            # the repeats come in a second call: the first inserts
            res = rag.answer(qs[:5]) + rag.answer(qs[5:])
        finally:
            o.disable()
        runs.append((res, rag.cache.hits, _spans(rec)))
    (got, hits, spans), (want, j_hits, j_spans) = runs
    assert [r.answer for r in got] == [r.answer for r in want]
    assert [r.contexts for r in got] == [r.contexts for r in want]
    np.testing.assert_allclose(np.stack([r.scores for r in got]),
                               np.stack([r.scores for r in want]),
                               rtol=0, atol=1e-5)
    assert hits == j_hits == 2
    assert spans == j_spans
    assert {s[2] for s in spans} >= {"request", "retrieve", "semantic_cache",
                                     "queue_wait", "prefill", "decode",
                                     "decode_segment", "detokenize"}
