"""The serving paths of qwen3-moe-30b-a3b (qk-norm, routed experts) and
qwen2-vl-72b (M-RoPE; served text-only, as the reference serves it) on
the CPU at the smoke config (d 64, vocab 48): each request's greedy
tokens equal the reference's solo ``generate_reference`` run.

  * ``generate`` and ``generate_reference`` on a left-padded wave (also
    with an EOS stop), the wave ``RequestQueue``, the non-paged
    continuous queue (refills) and the paged continuous queue with a
    prefix fork of a shared context (hits and copy-on-write forks);
  * ``serve.main --arch <arch> --smoke`` on ``--device cpu``.

The reference's engines broadcast 2-D positions to [3, B, L] for M-RoPE;
the port's pass them as they are, which the model treats as equal t/h/w
positions (``models/model.py``): the tokens below hold that to be the
same function.  The reference runs each request alone, once an arch
(its queues compile a program a shape, and these tests hold the port's
batching to the solo result the reference's own parity tests use).
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from test_torch_qwen import ARCHS, qwen_pair  # noqa: E402

from repro.serving import GenerationParams as JGen  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402

from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import (ContinuousQueue, GenerationParams,  # noqa: E402
                                 RequestQueue, ServeEngine)

BUDGET = 6
CTX = [5, 6, 7, 2, 3, 4, 1, 2, 9, 9, 3]      # 11 tokens: a mid-block tail
# (prompt, prefix_len): three requests share CTX, the rest differ in length
REQUESTS = [(CTX + [14, 4, 1], len(CTX)), ([8, 30, 2, 19, 7], 0),
            (CTX + [7, 8, 2, 40], len(CTX)),
            ([21, 3, 3, 17, 5, 6, 29, 11, 13, 40, 2, 2, 9], 0),
            (CTX + [9, 1, 5], len(CTX)), ([12, 33, 6], 0)]
PROMPTS = [p for p, _ in REQUESTS]


@pytest.fixture(scope="module", params=ARCHS)
def solo(request):
    """(cfg, port params, the reference's solo greedy tokens of each of
    PROMPTS at BUDGET)."""
    cfg, jparams, params = qwen_pair(request.param)
    jeng = JEngine(cfg, jparams, max_len=64, batch_size=1)
    refs = [jeng.generate_reference([p], gen=JGen(max_new_tokens=BUDGET))[0]
            for p in PROMPTS]
    assert all(len(r) == BUDGET for r in refs)
    return cfg, params, refs


def _queue_run(queue, requests):
    rids = [queue.submit(p, prefix_len=pl) for p, pl in requests]
    outs = queue.run()
    return [outs[r] for r in rids]


def test_qwen_generate_matches_reference(solo):
    """A left-padded wave of four, without and with an EOS stop (each
    row ends at its first EOS, inclusive)."""
    cfg, params, refs = solo
    eng = ServeEngine(cfg, params, max_len=64, batch_size=4, device="cpu")
    gp = GenerationParams(max_new_tokens=BUDGET)
    assert eng.generate(PROMPTS[:4], gen=gp) == refs[:4] \
        == eng.generate_reference(PROMPTS[:4], gen=gp)
    eos = refs[1][2]
    gp = GenerationParams(max_new_tokens=BUDGET, eos_id=eos)
    want = [r[:r.index(eos) + 1] if eos in r else r for r in refs[:4]]
    assert eng.generate(PROMPTS[:4], gen=gp) == want \
        == eng.generate_reference(PROMPTS[:4], gen=gp)
    assert want[1][-1] == eos and len(want[1]) <= 3


def test_qwen_wave_queue_matches_reference(solo):
    cfg, params, refs = solo
    eng = ServeEngine(cfg, params, max_len=64, batch_size=3, device="cpu")
    q = RequestQueue(eng, GenerationParams(max_new_tokens=BUDGET))
    rids = q.submit_all(PROMPTS)
    outs = q.run()
    assert [outs[r] for r in rids] == refs
    assert q.stats.waves >= 2


def test_qwen_continuous_queue_matches_reference(solo):
    """The non-paged continuous queue, batch 2, chunks of 8: rows that
    finish are refilled."""
    cfg, params, refs = solo
    eng = ServeEngine(cfg, params, max_len=64, batch_size=2,
                      prefill_chunk=8, device="cpu")
    q = ContinuousQueue(eng, GenerationParams(max_new_tokens=BUDGET))
    assert _queue_run(q, [(p, 0) for p in PROMPTS]) == refs
    assert q.stats.refills >= 2


def test_qwen_paged_queue_with_prefix_fork_matches_reference(solo):
    """The paged continuous queue with the prefix cache: the shared
    context is cached once and forked into later requests."""
    cfg, params, refs = solo
    eng = ServeEngine(cfg, params, max_len=64, batch_size=2,
                      prefill_chunk=8, paged=True, block_size=8,
                      device="cpu")
    q = ContinuousQueue(eng, GenerationParams(max_new_tokens=BUDGET))
    assert _queue_run(q, REQUESTS) == refs
    st = q.stats
    assert st.prefix_hits >= 1 and st.cow_forks >= 1 and st.refills >= 2


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_qwen(arch, capsys):
    got = serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated 128 tokens for 8 requests" in out
    assert got["tokens"] == 128 and got["waves"] == 3
    assert all(len(o) == 16 for o in got["outputs"])
