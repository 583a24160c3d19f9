"""The reference's cache-kind tests over the port's dense decoders
(llama3-8b, gemma2-9b, nemotron-4-15b) at the smoke config (d 64, vocab
48, gemma2's window 16), on the CPU: exact greedy tokens.

  * the port's copy of ``tests/test_paged_kv.py``'s
    ``test_paged_parity_frame_refill_fork`` (one frame, a plain refill,
    a prefix fork: the reference's solo tokens, every block returned)
    and of ``tests/test_standing_engine.py``'s
    ``test_standing_stream_parity`` (its ``ARCH_PROMPTS``: a request
    straddling a slot, paged and non-paged);
  * gemma2 waves bucketed with left pads, as the reference's (the
    "local" kind is not recurrent);
  * ``serve.main`` with no ``--arch`` (gemma2-9b, the reference's
    default) on ``--device cpu``.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dense import ARCHS, dense_pair  # noqa: E402

from repro.serving import GenerationParams as JGen  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402

from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import (ContinuousQueue,  # noqa: E402
                                 ContinuousSession, GenerationParams,
                                 ServeEngine)

# the reference's standing prompts (tests/test_standing_engine.py); the
# reference lists none for nemotron, which shares llama3's path
ARCH_PROMPTS = {
    "llama3-8b": [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14, 15],
                  [3, 1, 4, 1], [9, 2, 6]],
    "gemma2-9b": [[1, 2, 3, 4, 5, 6], [7, 8, 9], [11, 12, 13, 14],
                  [3, 1, 4, 1, 5], [9, 2, 6]],
}
ARCH_PROMPTS["nemotron-4-15b"] = ARCH_PROMPTS["llama3-8b"]
BUDGETS = [6, 2, 8, 4, 5]


KW = dict(max_len=96, batch_size=2, prefill_chunk=8, block_size=16)


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """(arch, (cfg, reference params, port params), the reference's solo
    greedy tokens of ``ARCH_PROMPTS[arch]`` at ``BUDGETS``)."""
    arch = request.param
    cfg, jparams, params = dense_pair(arch, key=0)
    jeng = JEngine(cfg, jparams, **KW)
    refs = [jeng.generate_reference([p], gen=JGen(max_new_tokens=b))[0][:b]
            for p, b in zip(ARCH_PROMPTS[arch], BUDGETS)]
    return arch, (cfg, jparams, params), refs


def _drain(sess, outs, n, budget):
    while len(outs) < n:
        for slot, toks in sess.run_segment(drain=True):
            outs[slot] = toks[:budget]
    return outs


def test_dense_paged_parity_frame_refill_fork(smoke):
    """One frame, a plain paged refill and a prefix-cache fork, each
    token-exact against the reference's solo runs (gemma2: prompt and
    budget pass the window, so the local buffer wraps)."""
    _, (cfg, jparams, params), _ = smoke
    eng = ServeEngine(cfg, params, device="cpu", paged=True, **KW)
    jeng = JEngine(cfg, jparams, paged=True, **KW)
    ctx = [5, 6, 7, 2, 3, 4, 1, 2, 9, 9, 3]
    q1, q2 = [4, 4, 1], [7, 8, 2]
    budget = 5
    refs = jeng.generate_reference([ctx + q1, ctx + q2],
                                   gen=JGen(max_new_tokens=budget))
    assert refs == eng.generate_reference([ctx + q1, ctx + q2],
                                          gen=GenerationParams(
                                              max_new_tokens=budget))
    sess = ContinuousSession(eng, GenerationParams(max_new_tokens=budget),
                             seed=7, prefix_cache=4)
    sess.begin_frame([ctx + q1, ctx + q2], [budget, budget])
    outs = _drain(sess, {}, 2, budget)
    assert [outs[s] for s in sorted(outs)] == refs
    sess.refill(0, ctx + q1, budget)
    assert _drain(sess, {}, 1, budget)[0] == refs[0]
    for slot, q in zip(range(2), (q1, q2)):
        assert sess.can_refill(len(ctx + q), budget, prefix_len=len(ctx),
                               prompt=ctx + q)
        sess.refill(slot, ctx + q, budget, prefix_len=len(ctx))
    outs = _drain(sess, {}, 2, budget)
    assert [outs[s] for s in sorted(outs)] == refs
    assert sess.prefix_cache.hits == 1 and sess.prefix_cache.misses == 1
    sess.release()
    assert sess.allocator.available == eng.num_blocks
    assert (sess.allocator.refcount == 0).all()


@pytest.mark.parametrize("paged", [False, True], ids=["nonpaged", "paged"])
def test_dense_standing_stream_parity(smoke, paged):
    """A standing queue fed slot by slot, a request straddling a slot
    boundary mid-decode: the reference's solo greedy tokens."""
    arch, (cfg, _, params), refs = smoke
    eng = ServeEngine(cfg, params, device="cpu", paged=paged, **KW)
    prompts = ARCH_PROMPTS[arch]
    q = ContinuousQueue(eng, GenerationParams(max_new_tokens=8),
                        standing=True)
    r0 = q.submit(prompts[0], BUDGETS[0])
    r1 = q.submit(prompts[1], BUDGETS[1])
    q.run(wait_for=[r0, r1])
    r2 = q.submit(prompts[2], BUDGETS[2])
    r3 = q.submit(prompts[3], BUDGETS[3])
    q.run(wait_for=[r3])
    assert r2 in q.unfinished()
    r4 = q.submit(prompts[4], BUDGETS[4])
    q.run(wait_for=[r2, r4])
    assert q.unfinished() == []
    for rid, ref in zip([r0, r1, r2, r3, r4], refs):
        assert q.result(rid).tokens == ref, (arch, paged, rid)
    if paged:
        assert q.stats.frames == 1
    q.close()
    assert q._session is None


# --------------------------------------------------------------- launcher


def test_serve_main_runs_the_default_arch(capsys):
    """serve.py's default command (gemma2-9b): bucketed waves, and
    ``generate`` agreeing with the per-token loop."""
    got = serve.main(["--smoke", "--device", "cpu", "--batch", "3",
                      "--requests", "7", "--prompt-len", "24",
                      "--new-tokens", "5", "--max-len", "64", "--reference"])
    out = capsys.readouterr().out
    assert "generated 35 tokens for 7 requests" in out
    assert sorted(set(got["buckets"]), reverse=True) == [32, 16, 8]
    assert got["waves"] == 3 and got["slot_utilization"] == 7 / 9
    assert got["loops_agree"] and "tokens agree" in out
    assert all(len(o) == 5 for o in got["outputs"])
    assert serve._parser().parse_args([]).arch == "gemma2-9b"


def test_dense_waves_are_bucketed_as_the_reference():
    """The "local" kind is not recurrent: gemma2 waves are bucketed with
    left pads and a ``kv_cap``, as the reference's."""
    for arch in ARCHS:
        cfg, jparams, params = dense_pair(arch)
        eng = ServeEngine(cfg, params, max_len=64, batch_size=2,
                          device="cpu")
        jeng = JEngine(cfg, jparams, max_len=64, batch_size=2)
        assert eng._exact_length is jeng._exact_length is False
        assert eng.prompt_bucket(9, 4) == jeng.prompt_bucket(9, 4) == 16
