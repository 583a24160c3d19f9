"""The port's whisper-base path against the reference on the CPU (the f32
smoke config: 2 encoder + 2 decoder layers, d 64, 16 encoder frames,
vocab 48, a learned position table of 64 rows; weights through the
bridge, whose round trip is exact):

  * ``layers.sinusoidal_positions`` (sin at even columns, cos at odd
    ones) at the smoke and the published size, within 1e-6 (f32 ``pow``
    and ``sin`` of two libraries);
  * the learned position embedding clamps as the reference does: a pad
    (-1) reads row 0, a position past the table its last row (torch
    indexing would wrap -1 to the last row); sinusoidal rows 0 .. S-1
    whatever the positions;
  * ``Model.encode`` (sinusoidal positions, non-causal attention, MLP,
    final norm) and the cross-attention sublayer at one query (the
    decode read) and at several (non-causal flash);
  * the model with random encoder frames: the forward with a left-padded
    row; a left-padded, non-power-of-two batch prefilled at absolute
    positions (pads read row 0, a row starts at its pad count), then
    decode steps in the absolute and in the relative frame; contiguous
    chunks and paged chunks (non-contiguous block runs, a right-padded
    row) with decode steps, a row frozen half way: logits within 1e-4,
    pooled K/V and each layer's stored cross-attention K/V within 1e-5
    of the reference cache's ``"enc"``.

The serving paths are in ``test_torch_whisper_serving.py``; the gate's
cases (learned, sinusoidal, encoder-decoder on another config) in
``test_torch_model.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402
from repro_torch.models import layers  # noqa: E402

ARCH = "whisper-base"
VOCAB = 48
MAX_SEQ = 64          # rows of the learned position table
LOGIT_TOL = dict(atol=1e-4, rtol=0)
KV_TOL = dict(atol=1e-5, rtol=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def whisper_pair(key=3):
    """(cfg, reference params, port params) of the f32 smoke model."""
    cfg = get_smoke_config(ARCH, max_d_model=64, vocab=VOCAB)
    jparams = JModel(cfg).init_params(jax.random.PRNGKey(key),
                                      max_seq=MAX_SEQ)
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return cfg, jparams, params


@pytest.fixture(scope="module")
def pair():
    return whisper_pair()


def _frames(cfg, B, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model)
                               ).astype(np.float32)


def test_bridge_round_trip_is_exact(pair):
    """The encoder's stacked blocks become a list of per-layer dicts and
    stack back; ``pos_embed`` and the decoder's ``lnx`` / ``xattn``
    pass through; the port's own draw has the same tree."""
    cfg, jparams, params = pair
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    assert len(params["encoder"]["blocks"]) == cfg.num_encoder_layers
    assert params["pos_embed"].shape == (MAX_SEQ, cfg.d_model)
    back = bridge.params_to_numpy(params, cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(np_params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    ours = bridge.params_to_numpy(
        Model(cfg).init_params(seed=0, device="cpu", max_seq=MAX_SEQ), cfg)
    assert [(p, a.shape) for p, a in jax.tree_util.tree_leaves_with_path(
        ours)] == [(p, a.shape) for p, a in flat_a]


# ----------------------------------------------------------- positions


@pytest.mark.parametrize("n,d", [(16, 64), (37, 30), (1500, 512)])
def test_sinusoidal_positions_match_reference(n, d):
    got = layers.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jlayers.sinusoidal_positions(n, d)),
                               atol=1e-6, rtol=0)
    assert float(got[0, 0]) == 0.0 and float(got[0, 1]) == 1.0


def test_learned_positions_clamp_as_the_reference(pair):
    """Pads (-1) read row 0 and positions past the table its last row,
    in both packages; torch's own indexing would read row -1."""
    cfg, jparams, params = pair
    pos = np.array([[-1, 0, 5, MAX_SEQ - 1, MAX_SEQ, MAX_SEQ + 7]],
                   np.int32)
    toks = np.array([[7, 8, 9, 10, 11, 12]], np.int32)
    got = Model(cfg)._embed(params, _t(toks), _t(pos))
    want = JModel(cfg)._embed(jparams, jnp.asarray(toks), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0, rtol=0)
    tbl, emb = params["pos_embed"], params["embed"]
    assert torch.equal(got[0, 0], emb[7] + tbl[0])
    assert not torch.equal(got[0, 0], emb[7] + tbl[-1])
    assert torch.equal(got[0, 5], emb[12] + tbl[-1])


def test_sinusoidal_embedding_ignores_positions():
    cfg = dataclasses.replace(
        get_smoke_config("olmo-1b", max_d_model=64, vocab=VOCAB),
        pos_embedding="sinusoidal")
    jparams = JModel(cfg).init_params(jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    toks = np.array([[3, 4, 5, 6], [7, 8, 9, 10]], np.int32)
    pos = np.array([[-1, -1, 0, 1], [9, 10, 11, 12]], np.int32)
    got = Model(cfg)._embed(params, _t(toks), _t(pos))
    want = JModel(cfg)._embed(jparams, jnp.asarray(toks), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    rows = layers.sinusoidal_positions(4, cfg.d_model)
    np.testing.assert_allclose((got - params["embed"][_t(toks).long()])
                               .numpy(), rows[None].expand(2, 4, -1).numpy(),
                               atol=1e-6)


# -------------------------------------------------- encoder, cross-attn


def test_encode_matches_reference(pair):
    cfg, jparams, params = pair
    frames = _frames(cfg, 2)
    got = Model(cfg).encode(params, _t(frames))
    want = JModel(cfg).encode(jparams, jnp.asarray(frames))
    assert got.shape == (2, cfg.encoder_seq_len, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("Sq", [1, 5])
def test_cross_sublayer_matches_reference(pair, Sq):
    """One query reads through ``decode_attention``, more through
    non-causal flash; with a row state the K/V are stored, and a
    decode-style call (no encoder output) reads them back."""
    cfg, jparams, params = pair
    rng = np.random.default_rng(Sq)
    B = 3
    x = rng.standard_normal((B, Sq, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model)
                              ).astype(np.float32)
    jm, model = JModel(cfg), Model(cfg)
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["blocks"]["s0_attn"])
    dx, jkv = jm._cross_sublayer(jp, jnp.asarray(x), jnp.asarray(enc), None,
                                 "decode" if Sq == 1 else "chunk")
    st = cache_lib.init_row_state(cfg, B, 32, torch.float32, "cpu")[1]
    got = model._cross(params["blocks"][1], _t(x), _t(enc), st)
    np.testing.assert_allclose(got.numpy(), x + np.asarray(dx), **KV_TOL)
    np.testing.assert_allclose(st["xk"].numpy(), np.asarray(jkv["k"]),
                               **KV_TOL)
    np.testing.assert_allclose(st["xv"].numpy(), np.asarray(jkv["v"]),
                               **KV_TOL)
    again = model._cross(params["blocks"][1], _t(x), None, st)
    np.testing.assert_allclose(again.numpy(), got.numpy(), **KV_TOL)


# ---------------------------------------------------------------- model


def _check_enc_state(cfg, state, jc):
    """Each layer's stored cross-attention K/V against the reference
    cache's ``"enc"`` stack."""
    for i in range(cfg.num_layers):
        for ours, theirs in (("xk", "k"), ("xv", "v")):
            np.testing.assert_allclose(state[i][ours].numpy(),
                                       np.asarray(jc["enc"][theirs][i]),
                                       **KV_TOL)


def test_forward_matches_reference(pair):
    cfg, jparams, params = pair
    rng = np.random.default_rng(0)
    toks = rng.integers(5, VOCAB, (2, 13)).astype(np.int32)
    pos = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13)).copy()
    pos[1, :4] = -1                                  # a left-padded row
    frames = _frames(cfg, 2)
    want, _ = JModel(cfg).forward(jparams, {
        "tokens": jnp.asarray(toks), "positions": jnp.asarray(pos),
        "encoder_frames": jnp.asarray(frames)})
    got = Model(cfg).forward(params, _t(toks), _t(pos),
                             encoder_frames=_t(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    with pytest.raises(ValueError, match="encoder_frames"):
        Model(cfg).forward(params, _t(toks), _t(pos))


@pytest.mark.parametrize("relative", [False, True],
                         ids=["absolute", "relative"])
def test_prefill_and_decode_match_reference(pair, relative):
    """A left-padded batch of 20, 15 and 9 tokens (not powers of two)
    prefilled at absolute positions, so rows 1 and 2 start at positions 5
    and 11 and their pads read row 0; then decode steps at the shared
    absolute position (``first`` masked) or in the relative frame, which
    reads other rows of the learned table."""
    cfg, jparams, params = pair
    model, jm = Model(cfg), JModel(cfg)
    rng = np.random.default_rng(2)
    B, L, max_len, steps = 3, 20, 40, 6
    toks = rng.integers(5, VOCAB, (B, L)).astype(np.int32)
    first = np.array([0, 5, 11], np.int32)
    pos = np.where(np.arange(L)[None] >= first[:, None], np.arange(L)[None],
                   -1).astype(np.int32)
    frames = _frames(cfg, B, seed=4)
    c = model.init_cache(B, max_len, "cpu")
    c.first = _t(first)
    jc = jm.init_cache(B, max_len, jnp.float32)
    jc["first"] = jnp.asarray(first)
    got = [model.prefill(params, _t(toks), _t(pos), c,
                         encoder_frames=_t(frames))]
    lg, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks),
                                  "positions": jnp.asarray(pos),
                                  "encoder_frames": jnp.asarray(frames)}, jc)
    want = [lg]
    _check_enc_state(cfg, c.state, jc)
    step = jax.jit(jm.decode_step, static_argnames=("kv_cap", "relative"))
    for _ in range(steps):
        tok = rng.integers(5, VOCAB, (B, 1)).astype(np.int32)
        got.append(model.decode_step(params, _t(tok), c, kv_cap=32,
                                     relative=relative))
        lg, jc = step(jparams, jnp.asarray(tok), jc, kv_cap=32,
                      relative=relative)
        want.append(lg)
    assert c.length == int(jc["length"]) == L + steps
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGIT_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(getattr(c, n).numpy(),
                                   np.asarray(jc["slots"]["s0_attn"][n]),
                                   **KV_TOL)
    _check_enc_state(cfg, c.state, jc)


def _chunk_pos(length, first, l_end, C):
    abs_pos = length[:, None] + np.arange(C, dtype=np.int32)[None]
    valid = (abs_pos >= first[:, None]) & (abs_pos < l_end[:, None])
    pos = np.where(valid, abs_pos - first[:, None], -1).astype(np.int32)
    last_col = np.clip(l_end - 1 - length, 0, C - 1).astype(np.int32)
    return pos, last_col


def test_contiguous_chunks_and_decode_match_reference(pair):
    """Two chunks of 8 into a contiguous cache (rows of 13 and 7 tokens,
    left-padded to 16), then relative decode steps."""
    cfg, jparams, params = pair
    model, jm = Model(cfg), JModel(cfg)
    rng = np.random.default_rng(5)
    B, C, frame, max_len = 2, 8, 16, 40
    first = np.array([3, 9], np.int32)
    toks = rng.integers(5, VOCAB, (B, frame)).astype(np.int32)
    frames = _frames(cfg, B, seed=6)
    c = model.init_cache(B, max_len, "cpu")
    c.first = _t(first)
    jc = jm.init_cache(B, max_len, jnp.float32)
    jc["first"] = jnp.asarray(first)
    jchunk = jax.jit(jm.prefill_chunk)
    for j in range(frame // C):
        pos, _ = _chunk_pos(np.full(B, j * C, np.int32), first,
                            np.full(B, frame, np.int32), C)
        chunk = toks[:, j * C:(j + 1) * C]
        want, jc = jchunk(jparams, {"tokens": jnp.asarray(chunk),
                                    "positions": jnp.asarray(pos),
                                    "encoder_frames": jnp.asarray(frames)},
                          jc)
        got = model.prefill_chunk(params, _t(chunk), _t(pos), c,
                                  encoder_frames=_t(frames))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
    _check_enc_state(cfg, c.state, jc)
    step = jax.jit(jm.decode_step, static_argnames=("kv_cap", "relative"))
    tok = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    for _ in range(5):
        want, jc = step(jparams, jnp.asarray(tok), jc, relative=True)
        got = model.decode_step(params, _t(tok), c, relative=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
        tok = np.asarray(want).argmax(-1).astype(np.int32)[:, None]


def test_paged_chunks_and_decode_match_reference(pair):
    """Paged chunked prefill of a 27-token left-padded row and a
    right-padded 7-token row (pads at both ends read row 0) over
    non-contiguous block runs, then decode steps with row 1 frozen half
    way: logits, per-row lengths, pools and stored cross-attention
    K/V."""
    cfg, jparams, params = pair
    model, jm = Model(cfg), JModel(cfg)
    B, C, bs, max_len, P, frame, dec = 2, 8, 8, 64, 20, 32, 8
    rng = np.random.default_rng(7)
    first = np.asarray([frame - 27, 0], np.int32)
    l_end = np.array([frame, 7], np.int32)
    toks = np.zeros((B, frame), np.int32)
    toks[0, first[0]:] = rng.integers(5, VOCAB, 27)
    toks[1, :7] = rng.integers(5, VOCAB, 7)
    tables = np.full((B, cache_lib.num_row_blocks(max_len, bs)), -1,
                     np.int32)
    tables[0, :7] = [5, 1, 7, 3, 4, 6, 8]
    tables[1, :4] = [2, 9, 0, 10]
    frames = _frames(cfg, B, seed=8)
    jc = jcache.init_paged_cache(cfg, B, max_len, bs, P, jnp.float32)
    jc.update(first=jnp.asarray(first), block_tables=jnp.asarray(tables))
    tc = model.init_paged_cache(B, max_len, bs, P, device="cpu")
    tc.first, tc.block_tables = _t(first), _t(tables)
    jchunk = jax.jit(jm.prefill_chunk)
    for j in range(frame // C):
        pos, last_col = _chunk_pos(np.full(B, j * C, np.int32), first, l_end,
                                   C)
        chunk = toks[:, j * C:(j + 1) * C]
        want, jc = jchunk(jparams, {"tokens": jnp.asarray(chunk),
                                    "positions": jnp.asarray(pos),
                                    "last_col": jnp.asarray(last_col),
                                    "encoder_frames": jnp.asarray(frames)},
                          jc)
        got = model.prefill_chunk(params, _t(chunk), _t(pos), tc,
                                  last_col=_t(last_col),
                                  encoder_frames=_t(frames))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
    tc.length = _t(l_end)
    jc["length"] = jnp.asarray(l_end)
    _check_enc_state(cfg, tc.state, jc)
    jdecode = jax.jit(jm.decode_step, static_argnames=("relative", "nb_cap"))
    tok = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    for s in range(dec):
        active = np.asarray([True, s < dec // 2])
        want, jc = jdecode(jparams, jnp.asarray(tok), jc, relative=True,
                           nb_cap=8, active=jnp.asarray(active))
        got = model.decode_step(params, _t(tok), tc, nb_cap=8,
                                active=_t(active))
        np.testing.assert_allclose(got.numpy()[active],
                                   np.asarray(want)[active], **LOGIT_TOL)
        tok = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    assert tc.length.tolist() == np.asarray(jc["length"]).tolist() \
        == [frame + dec, 7 + dec // 2]
    for n in ("k", "v"):
        np.testing.assert_allclose(getattr(tc, n)[0].numpy(),
                                   np.asarray(jc["slots"]["s0_attn"][n][0]),
                                   **KV_TOL)
    _check_enc_state(cfg, tc.state, jc)


def test_row_state_carries_cross_kv(pair):
    """The cross-attention K/V are row state: zeros of [B, Se, KV, hd] in
    the model's dtype, moved by ``extract_row`` / ``insert_row``."""
    cfg = pair[0]
    st = cache_lib.init_row_state(cfg, 3, 32, torch.bfloat16, "cpu")
    assert sorted(st) == list(range(cfg.num_layers))
    for layer in st.values():
        assert sorted(layer) == ["xk", "xv"]
        assert layer["xk"].shape == (3, cfg.encoder_seq_len,
                                     cfg.num_kv_heads, cfg.resolved_head_dim)
        assert layer["xk"].dtype == torch.bfloat16
    src = cache_lib.init_row_state(cfg, 1, 32, torch.bfloat16, "cpu")
    src[1]["xv"].fill_(2.0)
    cache_lib.insert_row(st, src, 2)
    assert float(st[1]["xv"][2].min()) == 2.0 and float(st[1]["xv"][:2]
                                                        .abs().max()) == 0.0
    assert torch.equal(cache_lib.extract_row(st, 2)[1]["xv"], src[1]["xv"])
