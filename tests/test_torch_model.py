"""The port's model against the reference on bridged olmo-1b (dense
attention) and xlstm-350m (alternating mLSTM/sLSTM, 4 layers so that
the pattern cycles twice) smoke models (f32): parameter round trip,
full forward, and paged chunked prefill + decode with a frozen row,
logits, pool contents and recurrent state step by step; and the gate's
learned, sinusoidal and encoder-decoder cases on olmo-1b's smoke config.

Tolerances: logits 1e-4 absolute (a few f32 matmuls and softmaxes summed
in another order), pool K/V 1e-5, recurrent state atol 1e-5 rtol 1e-4;
parameters round-trip exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import cache as jcache  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402

LOGIT_TOL = 1e-4
KV_TOL = 1e-5
STATE_TOL = dict(atol=1e-5, rtol=1e-4)
SMOKE = {"olmo-1b": {}, "xlstm-350m": {"num_layers": 4}}


@pytest.fixture(scope="module", params=list(SMOKE))
def models(request):
    cfg = get_smoke_config(request.param, max_d_model=64, vocab=96,
                           **SMOKE[request.param])
    jm = JModel(cfg)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    params = bridge.params_from_numpy(np_params, cfg, device="cpu")
    return cfg, jm, jparams, np_params, Model(cfg), params


def test_bridge_round_trip_is_exact(models):
    cfg, _, _, np_params, _, params = models
    assert len(params["blocks"]) == cfg.num_layers
    back = bridge.params_to_numpy(params, cfg)
    flat_a = jax.tree_util.tree_leaves_with_path(np_params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_forward_logits_match(models):
    _, jm, jparams, _, model, params = models
    rng = np.random.default_rng(0)
    toks = rng.integers(5, 96, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    want, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks),
                                   "positions": jnp.asarray(pos)})
    got = model.forward(params, torch.from_numpy(toks), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)


def _chunk_batch(length, first, l_end, C):
    abs_pos = length[:, None] + np.arange(C, dtype=np.int32)[None]
    valid = (abs_pos >= first[:, None]) & (abs_pos < l_end)
    pos = np.where(valid, abs_pos - first[:, None], -1).astype(np.int32)
    last_col = np.clip(l_end - 1 - length, 0, C - 1).astype(np.int32)
    return pos, last_col


def test_paged_prefill_and_decode_match(models):
    cfg, jm, jparams, _, model, params = models
    B, C, bs, max_len, P = 2, 8, 8, 48, 12
    prompts = [list(range(7, 20)), [31, 5, 77, 12, 9, 40, 41]]   # 13, 7
    frame = 16
    first = np.asarray([frame - len(p) for p in prompts], np.int32)
    toks = np.zeros((B, frame), np.int32)
    for i, p in enumerate(prompts):
        toks[i, first[i]:] = p
    tables = np.full((B, cache_lib.num_row_blocks(max_len, bs)), -1,
                     np.int32)
    tables[0, :3] = [5, 1, 7]                # non-contiguous block runs
    tables[1, :3] = [2, 9, 0]

    jc = jcache.init_paged_cache(cfg, B, max_len, bs, P, jnp.float32)
    jc.update(first=jnp.asarray(first), block_tables=jnp.asarray(tables))
    tc = model.init_paged_cache(B, max_len, bs, P, device="cpu")
    tc.first = torch.from_numpy(first.copy())
    tc.block_tables = torch.from_numpy(tables.copy())

    jchunk = jax.jit(jm.prefill_chunk)
    length = np.zeros(B, np.int32)
    for j in range(frame // C):
        pos, last_col = _chunk_batch(length, first, frame, C)
        tc_ = toks[:, j * C:(j + 1) * C]
        want, jc = jchunk(jparams, {"tokens": jnp.asarray(tc_),
                                    "positions": jnp.asarray(pos),
                                    "last_col": jnp.asarray(last_col)}, jc)
        got = model.prefill_chunk(params, torch.from_numpy(tc_),
                                  torch.from_numpy(pos), tc,
                                  last_col=torch.from_numpy(last_col))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_TOL)
        _check_cache(cfg, tc, jc)
        length += C

    jdecode = jax.jit(jm.decode_step, static_argnames=("relative", "nb_cap"))
    tok = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    for step in range(4):
        active = np.asarray([True, step < 2])          # row 1 freezes
        want, jc = jdecode(jparams, jnp.asarray(tok), jc, relative=True,
                           nb_cap=3, active=jnp.asarray(active))
        got = model.decode_step(params, torch.from_numpy(tok), tc, nb_cap=3,
                                active=torch.from_numpy(active))
        np.testing.assert_allclose(got.numpy()[active],
                                   np.asarray(want)[active], rtol=0,
                                   atol=LOGIT_TOL)
        np.testing.assert_array_equal(tc.length.numpy(),
                                      np.asarray(jc["length"]))
        tok = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
        _check_cache(cfg, tc, jc)
    assert tc.length.tolist() == [frame + 4, frame + 2]


def _check_cache(cfg, tc, jc):
    """Pool K/V of the "attn" layers and the recurrent state of the
    others against the reference's cycle-stacked slots (every row: the
    reference steps a frozen row's recurrent state too)."""
    P = len(cfg.layer_pattern)
    pooled = 0
    for i in range(cfg.num_layers):
        kind = cfg.pattern_for_layer(i)
        slot = jc["slots"][f"s{i % P}_{kind}"]
        if kind == "attn":
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    getattr(tc, name)[pooled].numpy(),
                    np.asarray(slot[name][i // P]), rtol=0, atol=KV_TOL)
            pooled += 1
            continue
        assert sorted(tc.state[i]) == sorted(slot)
        for name, a in tc.state[i].items():
            np.testing.assert_allclose(a.numpy(),
                                       np.asarray(slot[name][i // P]),
                                       **STATE_TOL)
    assert tc.k.shape[0] == pooled


def test_block_allocator_contract():
    a = cache_lib.BlockAllocator(3)
    assert a.alloc(2) == [0, 1]                 # low ids first
    assert not a.can_alloc(2) and a.exhaustions == 1
    with pytest.raises(MemoryError):
        a.alloc(2)
    shared = a.fork([1])
    assert a.forks == 1 and a.refcount[1] == 2
    a.free([0, 1])
    a.free(shared)
    with pytest.raises(ValueError, match="double free"):
        a.free([0])
    with pytest.raises(ValueError, match="fork of free"):
        a.fork([1])
    assert a.available == 3 and a.high_watermark == 2
    with pytest.raises(ValueError):
        cache_lib.BlockAllocator(0)


@pytest.mark.parametrize("change", [
    {"pos_embedding": "sinusoidal"},
    {"is_encoder_decoder": True, "num_encoder_layers": 2,
     "encoder_seq_len": 16},
    {"pos_embedding": "learned"},
], ids=["sinusoidal-pos", "enc-dec", "learned-pos"])
def test_kinds_not_ported_raise(change):
    """The gate's three cases, which raised before the port served them
    (hence the name), now held to the reference on olmo-1b's smoke config
    changed as each case says: ``forward`` and a contiguous ``prefill``
    of a left-padded batch (pads read a learned table's row 0) within
    LOGIT_TOL, and the encoder-decoder with its encoder over seeded
    frames.  What is still not served raises: chunked prefill at
    sinusoidal positions (in both packages) and cross-attention beside
    recurrent layers."""
    cfg = dataclasses.replace(
        get_smoke_config("olmo-1b", max_d_model=32, vocab=96), **change)
    jm, model = JModel(cfg), Model(cfg)
    jparams = jm.init_params(jax.random.PRNGKey(1), max_seq=32)
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(3)
    B, L = 2, 12
    toks = rng.integers(5, 96, (B, L)).astype(np.int32)
    first = np.array([0, 5], np.int32)
    pos = np.where(np.arange(L)[None] >= first[:, None], np.arange(L)[None],
                   -1).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}
    kw = {}
    if cfg.is_encoder_decoder:
        frames = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
        batch["encoder_frames"] = jnp.asarray(frames)
        kw["encoder_frames"] = torch.from_numpy(frames)
    want, _ = jm.forward(jparams, batch)
    got = model.forward(params, torch.from_numpy(toks), torch.from_numpy(pos),
                        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)
    jc = jm.init_cache(B, 24, jnp.float32)
    jc["first"] = jnp.asarray(first)
    want, jc = jm.prefill(jparams, batch, jc)
    c = model.init_cache(B, 24, "cpu")
    c.first = torch.from_numpy(first)
    got = model.prefill(params, torch.from_numpy(toks), torch.from_numpy(pos),
                        c, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)
    if cfg.pos_embedding == "sinusoidal":
        chunk = {"tokens": batch["tokens"][:, :8],
                 "positions": batch["positions"][:, :8]}
        with pytest.raises(NotImplementedError, match="sinusoidal"):
            jm.prefill_chunk(jparams, chunk, jm.init_cache(B, 24))
        with pytest.raises(NotImplementedError, match="sinusoidal"):
            model.prefill_chunk(params, torch.from_numpy(toks[:, :8]),
                                torch.from_numpy(pos[:, :8]),
                                model.init_cache(B, 24, "cpu"))
    if cfg.is_encoder_decoder:
        with pytest.raises(NotImplementedError, match="cross-attention"):
            Model(dataclasses.replace(port_smoke("xlstm-350m"), **change))
