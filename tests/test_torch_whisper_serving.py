"""The serving paths of whisper-base (the f32 smoke model of
``test_torch_whisper.py``; served text-only, on the stub frontend's zero
frames, as the reference serves it) on the CPU: greedy tokens equal the
reference's exactly.

  * against the reference's own engines and queues on the same requests
    (``test_torch_hybrid.py``'s checks): ``generate`` and
    ``generate_reference`` on left-padded waves of lengths that are not
    powers of two (with an EOS stop, and 22 new tokens), the wave
    ``RequestQueue``, the non-paged continuous queue (frames recycled)
    and its standing form, the paged continuous queue with forks of a
    shared prefix (and every scheduler counter), and the paged standing
    queue with forks, a straddling row and a shed round;
  * against the reference's solo ``generate_reference`` run of each
    request, with the reference's power-of-two prompts (a left-padded
    solo wave reads its learned positions at absolute positions, a queue
    at positions counted from the row's first token: they agree when the
    solo bucket adds no pad): a mid-stream refill into a running frame,
    non-paged and paged; a paged frame, a plain refill and a prefix-cache
    fork; the standing queue with a request straddling slots;
  * the reference's own standing stream for whisper
    (``tests/test_standing_engine.py``, whose 4-token prompt the solo run
    pads to 8): the port's standing queue equals the reference's
    standing queue, both parting from the solo run on that prompt only.

``serve --arch whisper-base`` against the reference's launcher is
``test_torch_wave.py::test_serve_unported_arch_raises_before_building``.
"""
import pytest

torch = pytest.importorskip("torch")

import test_torch_hybrid as hybrid_t  # noqa: E402
from test_torch_whisper import whisper_pair  # noqa: E402

from repro.serving import ContinuousQueue as JQueue  # noqa: E402
from repro.serving import GenerationParams as JGen  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402

from repro_torch.serving import (ContinuousQueue, GenerationParams,  # noqa: E402
                                 ServeEngine)
from repro_torch.serving.engine import ContinuousSession  # noqa: E402

# the reference's whisper prompts (tests/test_continuous_batching.py)
POW2 = [[1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16],
        [5] * 8, [7] * 16, [3] * 8]
BUDGETS = [24, 3, 8, 4, 5]                  # row 0 straggles
CTX = [5, 6, 7, 2, 3, 4, 1, 2]              # tests/test_paged_kv.py's
Q1, Q2 = [4, 4, 1, 3, 2, 6, 7, 5], [9, 3, 1, 5, 2, 6, 7, 4]


@pytest.fixture(scope="module")
def bridged():
    return whisper_pair()


@pytest.fixture(scope="module")
def solo(bridged):
    """The reference's solo ``generate_reference`` tokens of a prompt at a
    budget (max_len 64), memoised."""
    cfg, jparams, _ = bridged
    jeng = JEngine(cfg, jparams, max_len=64, batch_size=1)
    memo = {}

    def run(prompt, budget):
        key = (tuple(prompt), budget)
        if key not in memo:
            memo[key] = jeng.generate_reference(
                [list(prompt)], gen=JGen(max_new_tokens=budget))[0][:budget]
        return memo[key]
    return run


# ------------------------------------------- the reference's own engines


def test_whisper_generate_matches_reference(bridged):
    hybrid_t.check_generate(*bridged)


def test_whisper_wave_queue_matches_reference(bridged):
    hybrid_t.check_wave_queue(*bridged)


def test_whisper_nonpaged_queues_match_reference(bridged):
    hybrid_t.check_nonpaged_queues(*bridged)


def test_whisper_paged_queue_with_forks_matches_reference(bridged):
    hybrid_t.check_paged_queue(*bridged, "forks", "fifo")


def test_whisper_paged_standing_queue_matches_reference(bridged):
    hybrid_t.check_standing_queue(*bridged)


# ------------------------------------- solo runs, power-of-two prompts


@pytest.mark.parametrize("paged", [False, True], ids=["nonpaged", "paged"])
def test_whisper_midstream_refill_matches_solo(bridged, solo, paged):
    cfg, _, params = bridged
    kw = dict(paged=True, block_size=8) if paged else {}
    eng = ServeEngine(cfg, params, max_len=64, batch_size=2,
                      prefill_chunk=8, device="cpu", **kw)
    q = ContinuousQueue(eng, GenerationParams(max_new_tokens=24))
    rids = q.submit_all(POW2, BUDGETS)
    outs = q.run()
    for rid, p, b in zip(rids, POW2, BUDGETS):
        assert outs[rid] == solo(p, b), (p, b)
    assert q.stats.refills >= 2 and q.stats.frames == 1


def _drain(sess, outs, n):
    while len(outs) < n:
        for slot, toks in sess.run_segment(drain=True):
            outs[slot] = toks
    return outs


def test_whisper_paged_frame_refill_fork_match_solo(bridged, solo):
    """``tests/test_paged_kv.py``'s whisper case through the port's
    session: a frame, a plain refill, then a prefix miss and a fork."""
    cfg, _, params = bridged
    eng = ServeEngine(cfg, params, max_len=64, batch_size=2, prefill_chunk=8,
                      paged=True, block_size=16, device="cpu")
    budget = 5
    refs = [solo(CTX + q, budget) for q in (Q1, Q2)]
    sess = ContinuousSession(eng, GenerationParams(max_new_tokens=budget),
                             prefix_cache=4)
    sess.begin_frame([CTX + Q1, CTX + Q2], [budget, budget])
    outs = _drain(sess, {}, 2)
    assert [outs[s] for s in sorted(outs)] == refs
    sess.refill(0, CTX + Q1, budget)
    assert _drain(sess, {}, 1)[0] == refs[0]
    for slot, q in enumerate((Q1, Q2)):
        assert sess.can_refill(len(CTX + q), budget, prefix_len=len(CTX),
                               prompt=CTX + q)
        sess.refill(slot, CTX + q, budget, prefix_len=len(CTX))
    outs = _drain(sess, {}, 2)
    assert [outs[s] for s in sorted(outs)] == refs
    assert (sess.prefix_cache.hits, sess.prefix_cache.misses) == (1, 1)
    sess.release()
    assert sess.allocator.available == eng.num_blocks


def _standing(q, prompts, budgets):
    """``tests/test_standing_engine.py``'s stream: two requests, then two
    more waiting for the second only (the first straddles the slot),
    then the last; returns the tokens and whether a request
    straddled."""
    r = [q.submit(prompts[0], budgets[0]), q.submit(prompts[1], budgets[1])]
    q.run(wait_for=r)
    r += [q.submit(prompts[2], budgets[2]), q.submit(prompts[3], budgets[3])]
    q.run(wait_for=[r[3]])
    straddled = r[2] in q.unfinished()
    r.append(q.submit(prompts[4], budgets[4]))
    q.run(wait_for=[r[2], r[4]])
    assert q.unfinished() == []
    q.close()
    return [q.result(i).tokens for i in r], straddled


STANDING_BUDGETS = [6, 2, 8, 4, 5]
# the reference's stream for whisper; its second prompt has 4 tokens
REF_STANDING = [[1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 11, 12], [5] * 8,
                [7] * 8, [3] * 8]


@pytest.mark.parametrize("paged", [False, True], ids=["nonpaged", "paged"])
def test_whisper_standing_matches_solo(bridged, solo, paged):
    """Power-of-two prompts (the reference's, its 4-token prompt
    replaced by 8 tokens): every request equals its solo run."""
    cfg, _, params = bridged
    prompts = [REF_STANDING[0], [9, 10, 11, 12, 13, 14, 15, 16]] \
        + REF_STANDING[2:]
    kw = dict(paged=True, block_size=16) if paged else {}
    eng = ServeEngine(cfg, params, max_len=96, batch_size=2, prefill_chunk=8,
                      device="cpu", **kw)
    got, straddled = _standing(ContinuousQueue(
        eng, GenerationParams(max_new_tokens=8), standing=True), prompts,
        STANDING_BUDGETS)
    assert straddled
    assert got == [solo(p, b) for p, b in zip(prompts, STANDING_BUDGETS)]


@pytest.mark.parametrize("paged", [False, True], ids=["nonpaged", "paged"])
def test_whisper_reference_standing_stream(bridged, solo, paged):
    """The reference's standing stream for whisper, which its own test
    holds to the solo run: the solo wave pads the 4-token prompt to the
    8-token bucket, so its learned positions start at 4 where the queue's
    start at 0.  The port's standing queue gives the reference's
    standing queue's tokens; both part from the solo run on that request
    only."""
    cfg, jparams, params = bridged
    kw = dict(max_len=96, batch_size=2, prefill_chunk=8)
    if paged:
        kw.update(paged=True, block_size=16)
    ours, straddled = _standing(ContinuousQueue(
        ServeEngine(cfg, params, device="cpu", **kw),
        GenerationParams(max_new_tokens=8), standing=True), REF_STANDING,
        STANDING_BUDGETS)
    theirs, _ = _standing(JQueue(JEngine(cfg, jparams, **kw),
                                 JGen(max_new_tokens=8), standing=True),
                          REF_STANDING, STANDING_BUDGETS)
    assert straddled and ours == theirs
    refs = [solo(p, b) for p, b in zip(REF_STANDING, STANDING_BUDGETS)]
    assert [o == r for o, r in zip(ours, refs)] == [True, False, True, True,
                                                    True]
