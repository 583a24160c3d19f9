"""The port's paged ContinuousQueue against the reference's on the same
bridged smoke model (f32; olmo-1b, and xlstm-350m, whose forks resume
from a recurrent-state snapshot) and the same request stream, under
FIFO and SJF admission.  Two streams, both at batch 2 with more
requests than rows (refills) and an EOS stop: "mixed" has mixed prompt
lengths and a shared retrieved-context prefix (a miss, then forks with
a copy-on-write tail); "forks" forks one prefix into four rows, so a
snapshot that a fork wrote through would change every later fork.
Greedy tokens must be equal, and so must the scheduler's counters:
prefix hits, misses and evictions, forks, refills, frames, decode
segments, admission skips, pool exhaustions and tokens out.

The greedy comparison is only meaningful away from near-ties: the test
recomputes the reference's logits at every generated position and checks
that the top-1/top-2 gap exceeds 10x the 1e-4 logit tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serving import ContinuousQueue as JQueue  # noqa: E402
from repro.serving import GenerationParams as JGen  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.serving import sampling as jsampling  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.serving import (ContinuousQueue, GenerationParams,  # noqa: E402
                                 ServeEngine)
from repro_torch.serving import sampling  # noqa: E402

LOGIT_TOL = 1e-4
VOCAB = 48
BUDGET = 6
CTX = [5, 6, 7, 2, 3, 4, 1, 2, 9, 9, 3]          # 11 tokens: mid-block tail
REQUESTS = [                                      # (prompt, prefix_len)
    (CTX + [14, 4, 1], len(CTX)),
    ([8, 30, 2, 19, 7], 0),
    (CTX + [7, 8, 2, 40], len(CTX)),
    ([21, 3, 3, 17, 5, 6, 29, 11, 13, 40, 2, 2, 9, 44, 18, 1, 27], 0),
    (CTX + [9, 1, 5], len(CTX)),
    ([12, 33, 6, 7, 9, 10, 3, 8, 45], 0),
]
FORKS = [
    ([8, 30, 2, 19, 7], 0),
    ([21, 3, 3, 17, 5, 6, 29], 0),
    (CTX + [14, 4, 1], len(CTX)),
    (CTX + [7, 8, 2, 40], len(CTX)),
    (CTX + [9, 1, 5], len(CTX)),
    (CTX + [14, 4, 1], len(CTX)),
]
STREAMS = {"mixed": REQUESTS, "forks": FORKS}
COUNTERS = ("prefix_hits", "prefix_misses", "prefix_evictions", "cow_forks",
            "refills", "frames", "segments", "admission_skips",
            "kv_exhaustions", "tokens_out")


@pytest.fixture(scope="module", params=["olmo-1b", "xlstm-350m"])
def bridged(request):
    cfg = get_smoke_config(request.param, max_d_model=64, vocab=VOCAB)
    jparams = JModel(cfg).init_params(jax.random.PRNGKey(3))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return cfg, jparams, params


def _run(queue, requests):
    rids = [queue.submit(p, prefix_len=pl) for p, pl in requests]
    outs = queue.run()
    return [outs[r] for r in rids], queue.stats


def _port_run(cfg, params, eos, policy, requests):
    eng = ServeEngine(cfg, params, max_len=64, batch_size=2, prefill_chunk=8,
                      paged=True, block_size=8, device="cpu")
    return _run(ContinuousQueue(eng, GenerationParams(max_new_tokens=BUDGET,
                                                      eos_id=eos),
                                policy=policy), requests)


def _min_greedy_gap(cfg, jparams, outs, requests):
    """Smallest top-1/top-2 logit gap of the reference model at every
    generated position (teacher-forced full forward, relative positions
    from each prompt's first token; right padding cannot leak backwards
    under the causal mask)."""
    seqs = [p + o for (p, _), o in zip(requests, outs)]
    L = max(len(s) for s in seqs)
    toks = np.zeros((len(seqs), L), np.int32)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), toks.shape).copy()
    logits, _ = jax.jit(JModel(cfg).forward)(
        jparams, {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)})
    logits = np.asarray(logits)
    gaps = []
    for i, ((p, _), o) in enumerate(zip(requests, outs)):
        for j, tok in enumerate(o):
            row = logits[i, len(p) - 1 + j]
            assert row.argmax() == tok          # greedy = the forward argmax
            top2 = np.sort(row)[-2:]
            gaps.append(top2[1] - top2[0])
    return min(gaps)


@pytest.mark.parametrize("policy", ["fifo", "sjf"])
@pytest.mark.parametrize("stream", list(STREAMS))
def test_continuous_queue_matches_reference(bridged, stream, policy):
    cfg, jparams, params = bridged
    requests = STREAMS[stream]
    # EOS: a token the model really emits early (the 2nd request's 3rd)
    free_run, _ = _port_run(cfg, params, None, policy, requests)
    eos = free_run[1][2]
    ours, ours_stats = _port_run(cfg, params, eos, policy, requests)

    jeng = JEngine(cfg, jparams, max_len=64, batch_size=2, prefill_chunk=8,
                   paged=True, block_size=8)
    theirs, theirs_stats = _run(JQueue(jeng, JGen(max_new_tokens=BUDGET,
                                                  eos_id=eos),
                                       key=jax.random.PRNGKey(0),
                                       policy=policy), requests)

    assert ours == theirs
    assert any(len(o) < BUDGET and o[-1] == eos for o in ours)   # EOS stop
    for name in COUNTERS:
        assert getattr(ours_stats, name) == getattr(theirs_stats, name), name
    assert theirs_stats.refills >= 4 and theirs_stats.prefix_hits >= 1
    assert theirs_stats.cow_forks >= 1
    if stream == "forks":
        assert theirs_stats.prefix_hits >= 3
    assert _min_greedy_gap(cfg, jparams, theirs, requests) > 10 * LOGIT_TOL


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.7), (7, 0.5),
                                         (0, 0.0)])
def test_sampling_filters_match_reference(top_k, top_p):
    """The top-k / top-p filters keep the reference's token sets (kept
    logits exactly, the rest at -1e30); greedy takes the first index of
    a tie; sampled tokens (a torch.Generator stream, which matches the
    reference only in distribution) fall inside the kept set."""
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((3, 40)) * 3).astype(np.float32)
    logits[1, 5] = logits[1, 9] = logits[1].max() + 1.0     # top-1 tie
    gp = GenerationParams(temperature=0.8, top_k=top_k, top_p=top_p)
    lg = torch.from_numpy(logits) / gp.temperature
    jl = jnp.asarray(logits) / gp.temperature
    if top_k:
        lg, jl = sampling.apply_top_k(lg, top_k), jsampling.apply_top_k(
            jl, top_k)
    if top_p < 1.0:
        lg, jl = sampling.apply_top_p(lg, top_p), jsampling.apply_top_p(
            jl, top_p)
    np.testing.assert_array_equal(lg.numpy(), np.asarray(jl))
    greedy = sampling.sample_token(torch.from_numpy(logits),
                                   GenerationParams())
    jgreedy = jsampling.sample_token(jnp.asarray(logits), JGen(),
                                     jax.random.PRNGKey(0), 0)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jgreedy))
    assert greedy[1, 0] == 5
    gen = torch.Generator().manual_seed(0)
    draws = torch.cat([sampling.sample_token(torch.from_numpy(logits), gp,
                                             gen) for _ in range(64)], 1)
    kept = np.asarray(jl) > -1e29
    assert kept[np.arange(3)[:, None], draws.numpy()].all()
