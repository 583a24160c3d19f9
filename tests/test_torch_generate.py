"""The port's non-paged serving engine against the reference on the CPU,
over the same bridged smoke weights (f32; olmo-1b, and xlstm-350m,
whose waves pad to the batch's exact longest prompt and whose recurrent
state absorbs the pads in ``generate``):

  * the contiguous cache (``write_seq`` / ``write_token`` at the shared
    position, a wrapping segment, the ``extract_row`` / ``insert_row``
    round trip) and ``layers.decode_attention`` (the flash wrapper at
    Sq 1; its plain version on the CPU) against the reference's, within
    1e-5 (f32 softmax summed in another order);
  * ``Model.prefill`` and the absolute and relative ``decode_step`` with
    and without ``kv_cap``: logits within 1e-4, the K/V buffers and the
    recurrent state within 1e-5;
  * greedy ``generate`` and ``generate_reference`` tokens equal to the
    reference's, on prompts that straddle buckets (3, 9 and 17 tokens:
    buckets 8, 16 and 32), with and without an EOS stop; empty prompts,
    left truncation with its warning, and the ``max_new_tokens >=
    max_len`` error;
  * ``generate == generate_reference`` under sampling for one seed, and
    ``retrieval/chunker.py`` against the reference's chunks.

The greedy comparison is only meaningful away from near-ties: the test
recomputes the reference's logits at every generated position and checks
that the top-1/top-2 gap exceeds 10x the 1e-4 logit tolerance."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.retrieval.chunker import chunk_text as j_chunk_text  # noqa: E402
from repro.serving import GenerationParams as JGen  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.retrieval.chunker import chunk_text  # noqa: E402
from repro_torch.serving import GenerationParams, ServeEngine  # noqa: E402

LOGIT_TOL = 1e-4
STATE_TOL = dict(atol=1e-5, rtol=1e-4)
VOCAB = 48
MAX_LEN = 64
BUDGET = 6
PROMPTS = [
    [21, 3, 3, 17, 5, 6, 29, 11, 13, 40, 2, 2, 9, 44, 18, 1, 27],   # 17
    [8, 30, 2],                                                      # 3
    [12, 33, 6, 7, 9, 10, 3, 8, 45],                                 # 9
]


@pytest.fixture(scope="module", params=["olmo-1b", "xlstm-350m"])
def bridged(request):
    cfg = get_smoke_config(request.param, max_d_model=64, vocab=VOCAB)
    jparams = JModel(cfg).init_params(jax.random.PRNGKey(3))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return cfg, jparams, params


def _engines(cfg, jparams, params, batch=4):
    return (ServeEngine(cfg, params, max_len=MAX_LEN, batch_size=batch,
                        device="cpu"),
            JEngine(cfg, jparams, max_len=MAX_LEN, batch_size=batch))


def _min_greedy_gap(cfg, jparams, prompts, outs, bucket_of):
    """Smallest top-1/top-2 logit gap of the reference model at every
    generated position, teacher-forced with ``generate``'s positions: the
    prompt left-padded to its wave's bucket at absolute positions, the
    pads masked (-1).  Recurrent models also absorb the pads' embeddings,
    as ``generate`` does."""
    gaps = []
    L = bucket_of
    for p, o in zip(prompts, outs):
        seq = [0] * (L - len(p)) + p + o
        pos = np.arange(len(seq), dtype=np.int32)
        pos[:L - len(p)] = -1
        logits, _ = JModel(cfg).forward(
            jparams, {"tokens": jnp.asarray([seq], jnp.int32),
                      "positions": jnp.asarray(pos[None])})
        logits = np.asarray(logits)[0]
        for j, tok in enumerate(o):
            row = logits[L - 1 + j]
            assert row.argmax() == tok       # greedy = the forward argmax
            top2 = np.sort(row)[-2:]
            gaps.append(top2[1] - top2[0])
    return min(gaps)


# ------------------------------------------------------------ layers / cache


@pytest.mark.parametrize("case", ["gqa", "softcap", "window", "empty-row"])
def test_decode_attention_matches_reference(case):
    rng = np.random.default_rng(0)
    B, S, H, KV, hd = 3, 40, 4, 2 if case == "gqa" else 4, 16
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    kv_pos = np.where(np.arange(S)[None] < np.array([[30], [12], [40]]),
                      np.arange(S)[None], -1).astype(np.int32)
    kv_pos[1, :4] = -1                    # left pads
    q_pos = np.array([29, 11, 35], np.int32)
    if case == "empty-row":
        kv_pos[2] = -1                    # no valid slot: unspecified row
    kw = {"softcap": 5.0} if case == "softcap" else \
        {"window": 7} if case == "window" else {}
    want = np.asarray(jlayers.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(kv_pos), **kw))
    got = layers.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(q_pos), torch.from_numpy(kv_pos), **kw).numpy()
    rows = slice(0, 2) if case == "empty-row" else slice(None)
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-5, rtol=1e-5)
    assert np.isfinite(got).all()


def test_cache_writes_and_row_moves(bridged):
    cfg, _, _ = bridged
    rng = np.random.default_rng(1)
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    c = cache_lib.init_cache(cfg, 2, 16, torch.float32, "cpu")
    jc = jcache.init_cache(cfg, 2, 16, jnp.float32)
    writes = ((0, 5), (5, 1), (6, 3), (14, 6), (3, 20)) \
        if "attn" in cfg.layer_pattern else ()   # xlstm: no K/V buffers
    for start, S in writes:
        k = rng.standard_normal((2, S, KV, hd)).astype(np.float32)
        v = rng.standard_normal((2, S, KV, hd)).astype(np.float32)
        name = "s0_attn"
        if S == 1:
            cache_lib.write_token(c.k[0], c.v[0], torch.from_numpy(k),
                                  torch.from_numpy(v), start)
            jc["slots"][name] = jcache.write_token(
                jc["slots"][name], jnp.asarray(k), jnp.asarray(v),
                jnp.int32(start), jnp.int32(0))
        else:
            cache_lib.write_seq(c.k[0], c.v[0], torch.from_numpy(k),
                                torch.from_numpy(v), start)
            jc["slots"][name] = jcache.write_seq(
                jc["slots"][name], jnp.asarray(k), jnp.asarray(v),
                jnp.int32(start), jnp.int32(0))
        np.testing.assert_array_equal(c.k[0].numpy(),
                                      np.asarray(jc["slots"][name]["k"][0]))
        np.testing.assert_array_equal(c.v[0].numpy(),
                                      np.asarray(jc["slots"][name]["v"][0]))
    # a row moves whole: K/V, recurrent state and first
    for st in c.state.values():
        for name in st:
            st[name] = torch.from_numpy(rng.standard_normal(
                tuple(st[name].shape)).astype(np.float32))
    c.first = torch.tensor([3, 7], dtype=torch.int32)
    row = cache_lib.extract_row(c, 1)
    assert row.k.shape[1] == 1 and int(row.first[0]) == 7
    before = cache_lib.extract_row(c, 0), cache_lib.extract_row(c, 1)
    cache_lib.insert_row(c, row, 0)
    for r in (0, 1):
        got = cache_lib.extract_row(c, r)
        assert torch.equal(got.k, before[1].k)
        assert torch.equal(got.v, before[1].v)
        for i, st in got.state.items():
            for name, a in st.items():
                assert torch.equal(a, before[1].state[i][name])
    assert c.first.tolist() == [7, 7]


def _ref_state(cfg, jc):
    """The reference cache's recurrent state as {layer: {name: array}}."""
    out = {}
    for i in range(cfg.num_layers):
        P = len(cfg.layer_pattern)
        kind = cfg.layer_pattern[i % P]
        if kind == "attn":
            continue
        st = jc["slots"][f"s{i % P}_{kind}"]
        out[i] = {n: np.asarray(a[i // P]) for n, a in st.items()}
    return out


@pytest.mark.parametrize("relative,kv_cap", [(False, None), (False, 24),
                                             (True, 24)])
def test_prefill_and_decode_match_reference(bridged, relative, kv_cap):
    """A left-padded batch prefilled at absolute positions, then four
    decode steps of seeded tokens: logits, K/V buffers and recurrent
    state against the reference's."""
    cfg, jparams, params = bridged
    model, jm = Model(cfg), JModel(cfg)
    rng = np.random.default_rng(2)
    B, L = 3, 16
    toks = rng.integers(5, VOCAB, (B, L)).astype(np.int32)
    first = np.array([0, 5, 11], np.int32)
    pos = np.where(np.arange(L)[None] >= first[:, None], np.arange(L)[None],
                   -1).astype(np.int32)
    c = model.init_cache(B, 40, "cpu")
    c.first = torch.from_numpy(first)
    jc = jm.init_cache(B, 40, jnp.float32)
    jc["first"] = jnp.asarray(first)
    got = [model.prefill(params, torch.from_numpy(toks),
                         torch.from_numpy(pos), c)]
    lg, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks),
                                  "positions": jnp.asarray(pos)}, jc)
    want = [np.asarray(lg)]
    for step in range(4):
        tok = rng.integers(5, VOCAB, (B, 1)).astype(np.int32)
        got.append(model.decode_step(params, torch.from_numpy(tok), c,
                                     kv_cap=kv_cap, relative=relative))
        lg, jc = jm.decode_step(jparams, jnp.asarray(tok), jc,
                                kv_cap=kv_cap, relative=relative)
        want.append(np.asarray(lg))
    assert c.length == int(jc["length"]) == L + 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=LOGIT_TOL, rtol=0)
    P = len(cfg.layer_pattern)
    for i, j in model.pool_index.items():
        slot = jc["slots"][f"s{i % P}_attn"]
        np.testing.assert_allclose(c.k[j].numpy(),
                                   np.asarray(slot["k"][i // P]), atol=1e-5)
        np.testing.assert_allclose(c.v[j].numpy(),
                                   np.asarray(slot["v"][i // P]), atol=1e-5)
    for i, st in _ref_state(cfg, jc).items():
        for name, a in st.items():
            np.testing.assert_allclose(c.state[i][name].numpy(), a,
                                       **STATE_TOL)


# ----------------------------------------------------------------- generate


def _gen_cases(eos):
    return GenerationParams(max_new_tokens=BUDGET, eos_id=eos), \
        JGen(max_new_tokens=BUDGET, eos_id=eos)


@pytest.mark.parametrize("stop", ["budget", "eos"])
def test_generate_matches_reference(bridged, stop):
    cfg, jparams, params = bridged
    eng, jeng = _engines(cfg, jparams, params)
    eos = None
    if stop == "eos":
        # a token the model really emits early (the 2nd prompt's 3rd)
        eos = eng.generate(PROMPTS, gen=_gen_cases(None)[0])[1][2]
    gp, jgp = _gen_cases(eos)
    ours = eng.generate(PROMPTS, gen=gp)
    loop = eng.generate_reference(PROMPTS, gen=gp)
    theirs = jeng.generate(PROMPTS, gen=jgp)
    assert ours == loop == theirs
    assert jeng.generate_reference(PROMPTS, gen=jgp) == theirs
    if eos is not None:
        assert any(len(o) < BUDGET and o[-1] == eos for o in ours)
        assert all(eos not in o[:-1] for o in ours)
    # every wave in one bucket: solo runs land in 32, 8 and 16
    buckets = [eng.prompt_bucket(len(p), BUDGET) for p in PROMPTS]
    assert buckets == ([17, 3, 9] if eng._exact_length else [32, 8, 16])
    solo = [eng.generate([p], gen=gp)[0] for p in PROMPTS]
    assert solo == [jeng.generate([p], gen=jgp)[0] for p in PROMPTS]
    gap = min(_min_greedy_gap(cfg, jparams, [p], [o], b)
              for p, o, b in zip(PROMPTS, solo, buckets))
    assert gap > 10 * LOGIT_TOL, gap


def test_generate_edge_cases_match_reference(bridged):
    cfg, jparams, params = bridged
    eng, jeng = _engines(cfg, jparams, params)
    gp, jgp = _gen_cases(None)
    # empty prompts get empty completions; the rest run as a smaller wave
    mixed = [[], PROMPTS[1], []]
    ours = eng.generate(mixed, gen=gp)
    assert ours == eng.generate_reference(mixed, gen=gp) \
        == jeng.generate(mixed, gen=jgp)
    assert ours[0] == ours[2] == [] and len(ours[1]) == BUDGET
    assert eng.generate([[], []], gen=gp) == [[], []]
    assert eng.generate([], gen=gp) == []
    assert eng.generate(PROMPTS, max_new_tokens=0) == [[], [], []]
    # a prompt longer than max_len - budget is truncated left, with a warning
    long = [5 + i % 40 for i in range(MAX_LEN)]
    with pytest.warns(UserWarning, match="truncated-left"):
        ours = eng.generate([long, PROMPTS[2]], gen=gp)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = jeng.generate([long, PROMPTS[2]], gen=jgp)
        loop = eng.generate_reference([long, PROMPTS[2]], gen=gp)
    assert ours == theirs == loop
    assert eng.max_prompt_len(BUDGET) == MAX_LEN - BUDGET
    # a budget the cache cannot hold is refused before anything runs
    for fn in (eng.generate, eng.generate_reference):
        with pytest.raises(ValueError, match="max_new_tokens"):
            fn(PROMPTS, max_new_tokens=MAX_LEN)


@pytest.mark.parametrize("filters", [dict(temperature=1.0),
                                     dict(temperature=0.8, top_k=5,
                                          top_p=0.9)],
                         ids=["plain", "top-k-top-p"])
def test_sampled_generate_equals_reference_loop(bridged, filters):
    """The reference asserts generate == generate_reference under
    sampling for one key; the port does for one seed (its draws cannot
    equal jax.random's)."""
    cfg, jparams, params = bridged
    eng, _ = _engines(cfg, jparams, params)
    gp = GenerationParams(max_new_tokens=8, **filters)
    ours = eng.generate(PROMPTS, gen=gp, seed=7)
    assert ours == eng.generate_reference(PROMPTS, gen=gp, seed=7)
    assert ours == eng.generate(PROMPTS, gen=gp, seed=7)
    assert all(len(o) == 8 for o in ours)
    others = [eng.generate(PROMPTS, gen=gp, seed=s) for s in (8, 9)]
    assert any(o != ours for o in others)


def test_engine_construction():
    cfg = get_smoke_config("olmo-1b", max_d_model=32, vocab=VOCAB)
    params = Model(cfg).init_params(seed=0, device="cpu")
    eng = ServeEngine(cfg, params, max_len=32, device="cpu")
    assert (eng.paged, eng.prefill_chunk) == (False, None)
    assert eng.prompt_bucket(3, 4) == 8 and eng.prompt_bucket(9, 4) == 16
    assert eng.prompt_bucket(20, 4) == 28          # capped by the budget
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServeEngine(cfg, params, paged=True, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        eng.cont_max_prompt_len(4)


@pytest.mark.parametrize("text", [
    "", "one two three",
    " ".join(f"w{i}" for i in range(48)),
    " ".join(f"w{i}" for i in range(49)),
    " ".join(f"Word{i}, x." for i in range(150)),
], ids=["empty", "short", "exact", "one-over", "long"])
def test_chunker_matches_reference(text):
    assert chunk_text(text) == j_chunk_text(text)
    assert chunk_text(text, 10, 4) == j_chunk_text(text, 10, 4)
