"""The port's dense decoders against the reference on the CPU (f32 smoke
weights through the bridge): llama3-8b (GQA, rope theta 5e5, SwiGLU, an
untied head), gemma2-9b ("local" sliding-window layers alternating with
full attention, an attention softcap of 50 and a final one of 30, GeGLU,
the scaled embedding, a tied head) and nemotron-4-15b (LayerNorm with
bias, squared ReLU, an untied head):

  * the MLPs, GELU's tanh form included, within 1e-6 of
    ``repro.models.layers.apply_mlp``; the norms, LayerNorm's bias
    included;
  * the configs: the port's copies equal the reference's, at published
    width and reduced, and the model gate lets all three through;
  * the model at ``get_smoke_config`` (2 layers, 4 query and 4 KV heads
    of dim 16, gemma2's window 16), at the same with 2 KV heads (GQA
    group 2), and gemma2 at ``max_d_model=1024`` (head dim 256): forward,
    contiguous prefill + absolute decode (relative and ``kv_cap``-read
    decode at the smoke config),
    contiguous chunked prefill + relative decode, paged chunked prefill
    with a right-padded row + decode with a frozen row: logits within
    atol 1e-5, rtol 1e-4 (``test_torch_hybrid.py``'s checks, the "local"
    layers' rolling K/V compared with the reference's slots); gemma2's
    local buffer wraps in both caches;
  * gemma2's softcaps where they bind (weights scaled so scores pass 50
    and logits 30) and its embedding factor, sqrt(3584) rounded to bf16
    (59.75), as the reference computes it; the forward's final-normed
    features (``return_features``) and ``head`` at chosen columns.

The serving paths of the three archs are in ``test_torch_dense_serving.py``
and ``test_torch_dense_cache_kinds.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

import test_torch_hybrid as hybrid_t  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402
from repro_torch.models import layers  # noqa: E402

ARCHS = ("llama3-8b", "gemma2-9b", "nemotron-4-15b")
VOCAB = hybrid_t.VOCAB
TOL = dict(atol=1e-5, rtol=1e-4)
# the variants: the smoke config as it is, with 2 KV heads (GQA group 2)
VARIANTS = {"smoke": {}, "gqa2": {"num_kv_heads": 2}}
HD256 = dict(max_d_model=1024)        # gemma2 at head dim 256


def _t(a):
    return torch.from_numpy(np.array(a))


def dense_pair(arch, key=3, smoke=None, **over):
    """(cfg, reference params, port params): the PORT's smoke config of
    ``arch`` (``smoke`` keywords, default d 64 and vocab 48), replaced
    with ``over`` exactly as the reference's, which it must equal."""
    smoke = dict(max_d_model=64, vocab=VOCAB) if smoke is None else smoke
    cfg = dataclasses.replace(get_smoke_config(arch, **smoke), **over)
    jcfg = dataclasses.replace(j_get_smoke_config(arch, **smoke), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = JModel(cfg).init_params(jax.random.PRNGKey(key))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return cfg, jparams, params


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("mlp_type", ["gelu_glu", "gelu", "swiglu", "relu2"])
def test_apply_mlp_matches_reference(mlp_type):
    """GELU is the tanh form (``jax.nn.gelu``'s default): the erf form is
    up to 4.7e-4 away on [-6, 6], the tanh form within 1e-6."""
    cfg = dataclasses.replace(get_smoke_config("gemma2-9b", max_d_model=64),
                              mlp_type=mlp_type)
    jp = jlayers.init_mlp(jax.random.PRNGKey(4), cfg, jnp.float32)
    # outputs of order 1, so f32 rounding stays below the tolerance
    jp["wo"] = jp["wo"] * 0.05
    p = {k: _t(a) for k, a in jp.items()}
    rng = np.random.default_rng(1)
    # pre-activations spread over [-6, 6] and beyond
    x = (rng.standard_normal((3, 7, cfg.d_model)) * 3).astype(np.float32)
    want = np.asarray(jlayers.apply_mlp(jp, jnp.asarray(x), cfg))
    got = layers.apply_mlp(p, _t(x), cfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "llama3-8b"])
def test_norms_match_reference(arch):
    """LayerNorm with a bias (nemotron) and RMSNorm (llama3) on seeded
    scales and biases."""
    cfg = get_smoke_config(arch, max_d_model=64)
    rng = np.random.default_rng(2)
    jp = {k: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32))
          for k, a in jlayers.init_norm(cfg, jnp.float32).items()}
    assert set(jp) == ({"scale", "bias"} if arch == "nemotron-4-15b"
                       else {"scale"})
    x = (rng.standard_normal((2, 5, cfg.d_model)) * 4 + 1).astype(np.float32)
    want = np.asarray(jlayers.apply_norm(jp, jnp.asarray(x), cfg))
    got = layers.apply_norm({k: _t(a) for k, a in jp.items()}, _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """The port's copy equals the reference's config, at published width
    and reduced; its paged layers are the reference's pooled slots, and
    the model gate lets it through."""
    cfg = get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_get_config(arch))
    for kw in ({}, HD256, dict(max_d_model=64, vocab=VOCAB)):
        assert dataclasses.asdict(get_smoke_config(arch, **kw)) == \
            dataclasses.asdict(j_get_smoke_config(arch, **kw))
    P = len(cfg.layer_pattern)
    model = Model(cfg)
    names = {f"s{i % P}_{cfg.pattern_for_layer(i)}"
             for i in model.pool_index}
    assert names == set(jcache.paged_slot_names(cfg))
    want = {"llama3-8b": (("attn",), 500_000.0, False, 4, 128),
            "gemma2-9b": (("local", "attn"), 10_000.0, True, 2, 256),
            "nemotron-4-15b": (("attn",), 10_000.0, False, 6, 128)}[arch]
    assert (cfg.layer_pattern, cfg.rope_theta, cfg.tie_embeddings,
            cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim) == want
    assert model.rolling == ([] if arch != "gemma2-9b"
                             else list(range(0, cfg.num_layers, 2)))


# ------------------------------------------------------------------- model


@pytest.fixture(scope="module",
                params=[(a, v) for a in ARCHS for v in VARIANTS]
                + [("gemma2-9b", "hd256")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def dense(request):
    arch, variant = request.param
    if variant == "hd256":
        return dense_pair(arch, smoke=HD256)
    return dense_pair(arch, **VARIANTS[variant])


def test_dense_forward_matches_reference(dense):
    hybrid_t.check_forward(*dense, tol=TOL)


def test_dense_prefill_and_decode_match_reference(dense):
    """A left-padded batch of 20 prefilled at absolute positions, then 14
    decode steps (gemma2's 16-slot local buffer wraps in prefill and
    again in decode): logits, pools and the local layers' rolling K/V
    against the reference's."""
    hybrid_t.check_prefill_decode(*dense, relative=False, kv_cap=None,
                                  steps=14, tol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("relative,kv_cap", [(True, None), (False, 40)],
                         ids=["relative", "kv-cap"])
def test_dense_relative_and_capped_decode_match_reference(arch, relative,
                                                          kv_cap):
    """The same with relative decode positions, and with the decode read
    capped at ``kv_cap``, at the smoke config."""
    hybrid_t.check_prefill_decode(*dense_pair(arch), relative=relative,
                                  kv_cap=kv_cap, steps=14, tol=TOL)


def test_dense_paged_chunks_and_decode_match_reference(dense):
    hybrid_t.check_paged(*dense, tol=TOL)


def test_dense_contiguous_chunks_and_decode_match_reference(dense):
    """Chunks of 8 into a contiguous cache at one shared length (rows
    starting 0, 5 and 13 tokens in, relative positions, -1 at pads), then
    12 relative decode steps (gemma2's local buffer of 16 wraps): logits,
    buffers and per-row state against the reference's."""
    cfg, jparams, params = dense
    model, jm = Model(cfg), JModel(cfg)
    rng = np.random.default_rng(4)
    B, C, frame, max_len = 3, 8, 24, 48
    first = np.array([0, 5, 13], np.int32)
    toks = rng.integers(5, VOCAB, (B, frame)).astype(np.int32)
    c = model.init_cache(B, max_len, "cpu")
    c.first = _t(first)
    jc = jm.init_cache(B, max_len, jnp.float32)
    jc["first"] = jnp.asarray(first)
    jchunk = jax.jit(jm.prefill_chunk)
    for j in range(frame // C):
        abs_pos = j * C + np.arange(C, dtype=np.int32)[None]
        pos = np.where(abs_pos >= first[:, None], abs_pos - first[:, None],
                       -1).astype(np.int32)
        chunk = toks[:, j * C:(j + 1) * C]
        want, jc = jchunk(jparams, {"tokens": jnp.asarray(chunk),
                                    "positions": jnp.asarray(pos)}, jc)
        got = model.prefill_chunk(params, _t(chunk), _t(pos), c)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jdecode = jax.jit(jm.decode_step, static_argnames=("relative",))
    tok = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    for _ in range(12):
        want, jc = jdecode(jparams, jnp.asarray(tok), jc, relative=True)
        got = model.decode_step(params, _t(tok), c, relative=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    assert c.length == int(jc["length"]) == frame + 12
    P = len(cfg.layer_pattern)
    for i, j in model.pool_index.items():
        slot = jc["slots"][f"s{i % P}_attn"]
        for n in ("k", "v"):
            np.testing.assert_allclose(getattr(c, n)[j].numpy(),
                                       np.asarray(slot[n][i // P]),
                                       atol=1e-5)
    hybrid_t.check_state(cfg, c.state, jc)


def test_gemma2_local_buffer_wraps_in_both_caches():
    """The "local" layers keep ``min(W, max_len)`` slots of per-row state
    (not pooled); after more tokens than the window the buffer holds the
    last W positions by ``p % W``, in the contiguous and the paged cache,
    as the reference's slots do."""
    cfg, jparams, params = dense_pair("gemma2-9b")
    W = cfg.sliding_window
    model = Model(cfg)
    assert model.rolling == [0] and list(model.pool_index) == [1]
    st = cache_lib.init_row_state(cfg, 2, 40, torch.float32, "cpu")
    assert list(st) == [0] and set(st[0]) == {"k", "v"}
    assert st[0]["k"].shape == (2, W, cfg.num_kv_heads,
                                cfg.resolved_head_dim)
    assert cache_lib.rolling_len(cfg, 10) == 10
    # contiguous: a 27-token prompt wraps the buffer in prefill
    rng = np.random.default_rng(3)
    toks = rng.integers(5, VOCAB, (1, 27)).astype(np.int32)
    pos = np.arange(27, dtype=np.int32)[None]
    c = model.init_cache(1, 40, "cpu")
    got = model.prefill(params, _t(toks), _t(pos), c)
    jm = JModel(cfg)
    jc = jm.init_cache(1, 40, jnp.float32)
    want, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks),
                                    "positions": jnp.asarray(pos)}, jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    slot = jc["slots"]["s0_local"]
    assert slot["k"].shape[2] == W
    for n in ("k", "v"):
        np.testing.assert_allclose(c.state[0][n].numpy(),
                                   np.asarray(slot[n][0]), atol=1e-5)
    # slot j holds position 16 + j for j < 11, else j
    held = cache_lib.rolling_kv_positions(27, W).tolist()
    assert held == [16 + j if j < 11 else j for j in range(W)]
    # the paged cache: no pool for the local layer, the buffer in the row
    pc = model.init_paged_cache(2, 64, 8, 20, "cpu")
    assert pc.k.shape[0] == 1 and pc.state[0]["k"].shape[1] == W


def test_gemma2_softcaps_bind_and_match_reference():
    """Query weights scaled so attention scores pass the cap of 50, the
    embedding so logits pass the final cap of 30: the forward against the
    reference's, and the caps held (|logit| < 30)."""
    cfg, jparams, params = dense_pair("gemma2-9b")
    assert (cfg.attn_logit_softcap, cfg.final_logit_softcap) == (50.0, 30.0)
    jparams = jax.tree_util.tree_map(lambda a: a, jparams)
    jparams["embed"] = jparams["embed"] * 400.0
    for blk in jparams["blocks"].values():
        blk["attn"]["wq"] = blk["attn"]["wq"] * 60.0
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(5, VOCAB, (2, 24)).astype(np.int32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    want, _ = JModel(cfg).forward(jparams, {"tokens": jnp.asarray(toks),
                                            "positions": jnp.asarray(pos)})
    got = Model(cfg).forward(params, _t(toks), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert float(got.abs().max()) <= 30.0
    assert float((got.abs() > 25.0).float().mean()) > 0.1   # the cap binds
    # the attention scores of layer 0 pass the cap of 50
    m = Model(cfg)
    h = layers.apply_norm(params["blocks"][0]["ln1"],
                          m._embed(params, _t(toks)), cfg)
    q, k, _ = layers.qkv_project(params["blocks"][0]["attn"], h, cfg,
                                 m._angles(_t(pos)))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / cfg.resolved_head_dim ** 0.5
    assert float(s.abs().max()) > 50.0


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_features_and_head_match_reference(arch):
    """``forward(..., return_features=True)`` gives the reference's
    final-normed features, and ``head`` at some columns the forward's
    logits there (the final softcap included)."""
    cfg, jparams, params = dense_pair(arch)
    rng = np.random.default_rng(7)
    toks = rng.integers(5, VOCAB, (2, 20)).astype(np.int32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
    want, _ = JModel(cfg).forward(jparams, {"tokens": jnp.asarray(toks),
                                            "positions": jnp.asarray(pos)},
                                  return_features=True)
    model = Model(cfg)
    feats = model.forward(params, _t(toks), _t(pos), return_features=True)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want), **TOL)
    logits = model.forward(params, _t(toks), _t(pos))
    cols = [0, 7, 19]
    np.testing.assert_allclose(model.head(params, feats[:, cols]).numpy(),
                               logits[:, cols].numpy(), atol=1e-6, rtol=0)


def test_gemma2_embedding_factor_matches_reference():
    """The scaled embedding multiplies by sqrt(d_model) in the embedding's
    dtype: at bf16 and d 3584 that is 59.75 (not 59.87), as the
    reference computes it; at f32 the two are equal too."""
    full = get_config("gemma2-9b")
    assert full.scale_embedding and full.d_model == 3584
    cfg = dataclasses.replace(get_smoke_config("gemma2-9b", max_d_model=64,
                                               vocab=VOCAB), d_model=3584)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, VOCAB, (2, 5)).astype(np.int32)
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32)):
        table = rng.standard_normal((VOCAB, 3584)).astype(np.float32)
        jtab = jnp.asarray(table).astype(jdt)
        tab = _t(np.asarray(jtab.astype(jnp.float32))).to(dtype)
        want = JModel(cfg)._embed({"embed": jtab}, jnp.asarray(toks),
                                  jnp.zeros((2, 5), jnp.int32))
        got = Model(cfg)._embed({"embed": tab}, _t(toks))
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
        factor = 59.75 if dtype == torch.bfloat16 else 3584 ** 0.5
        assert torch.equal(got, tab[toks] * torch.tensor(factor, dtype=dtype))
