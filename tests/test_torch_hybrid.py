"""The port's hymba-1.5b path against the reference on the CPU (f32 smoke
weights through the bridge), and the serving checks both new node archs
share (``check_*``, run for qwen2-moe-a2.7b by ``test_torch_moe.py``):

  * Mamba: ``mamba_forward`` from zero state and from a state, with a
    left-pad mask and on a right-padded suffix chunk (whose conv history
    must end at the last valid column), and ``mamba_step``: outputs and
    state within atol 1e-5, rtol 1e-4 (f32 scans summed in another
    order); a bf16 model keeps ``A_log``, ``D`` and ``h`` in f32;
  * the rolling cache: ``rolling_kv_positions`` (shared and per-row),
    the per-row ``rolling_write_plan`` + ``rolling_write`` (a row with
    more than W valid tokens keeps its last W), ``rolling_write_token``
    with a frozen row and the shared wrapping ``write_seq``: exactly the
    reference's;
  * the hymba model (window 16 at the smoke config, and a variant with
    10 heads over 2 KV heads of dim 64, so GQA group 5 and head dim 64
    run): forward, contiguous prefill + absolute and relative decode
    past the window, paged chunked prefill with a right-padded row +
    decode with a frozen row: logits within 1e-4, rolling K/V within
    1e-5, Mamba state within atol 1e-5, rtol 1e-4;
  * greedy tokens equal the reference's exactly: ``generate`` and
    ``generate_reference`` (with an EOS stop, and the reference's
    wraparound case: decoding past the window), the paged continuous
    queue with forks of a shared prefix under FIFO and SJF (and every
    scheduler counter), the wave ``RequestQueue``, the non-paged and the
    standing queue, and federated ``LiveEdgeNode``s of both archs;
  * the launchers: ``serve.main --arch hymba-1.5b`` and
    ``cluster_serve.main --nodes 4`` on ``--device cpu``.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_serving as serving_t  # noqa: E402
import test_torch_standing as standing_t  # noqa: E402
import test_torch_wave as wave_t  # noqa: E402
from test_torch_cluster import SLO, _nodes, _slots, world  # noqa: E402,F401

from repro.configs import get_smoke_config  # noqa: E402
from repro.core.cluster import Query as JQuery  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serving import ContinuousQueue as JQueue  # noqa: E402
from repro.serving import GenerationParams as JGen  # noqa: E402
from repro.serving import RequestQueue as JRequestQueue  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.core.cluster import Query  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import cluster_serve, serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousQueue, GenerationParams, RequestQueue, ServeEngine)

ARCH = "hymba-1.5b"
LOGIT_TOL = 1e-4
KV_TOL = 1e-5
STATE_TOL = dict(atol=1e-5, rtol=1e-4)
VOCAB = 48


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def bridged_pair(arch, key=3, **over):
    """(cfg, reference params, port params) of ``arch``'s f32 smoke model,
    the config ``dataclasses.replace``d with ``over``."""
    cfg = dataclasses.replace(
        get_smoke_config(arch, max_d_model=64, vocab=VOCAB), **over)
    jparams = JModel(cfg).init_params(jax.random.PRNGKey(key))
    params = bridge.params_from_numpy(_np_tree(jparams), cfg, device="cpu")
    return cfg, jparams, params


# ----------------------------------------------------------------- Mamba


@pytest.fixture(scope="module")
def mamba():
    cfg = get_smoke_config(ARCH, max_d_model=64)
    jp = jssm.init_mamba(jax.random.PRNGKey(1), cfg, jnp.float32)
    p = {k: _t(a) for k, a in _np_tree(jp).items()}
    rng = np.random.default_rng(0)
    inner = ssm.mamba_inner_dim(cfg)
    state = {"h": rng.standard_normal((2, inner, cfg.ssm.state_size)
                                      ).astype(np.float32) * 0.3,
             "conv": rng.standard_normal((2, cfg.ssm.conv_width - 1, inner)
                                         ).astype(np.float32)}
    return cfg, jp, p, state, rng


def _check_state(got, want):
    for name in ("h", "conv"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   **STATE_TOL)


@pytest.mark.parametrize("case", ["zero-state", "state", "left-pad",
                                  "right-pad"])
def test_mamba_forward_matches_reference(mamba, case):
    cfg, jp, p, state, rng = mamba
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    mask = None
    if case == "left-pad":
        mask = np.ones((2, 12), bool)
        mask[1, :5] = False
    elif case == "right-pad":            # a prefix fork's suffix chunk
        mask = np.ones((2, 12), bool)
        mask[0, 9:] = False
        mask[1, 4:] = False
    st = None if case == "zero-state" else state
    y, s = jssm.mamba_forward(jp, jnp.asarray(x), cfg,
                              None if st is None else
                              {k: jnp.asarray(a) for k, a in st.items()},
                              mask=None if mask is None else
                              jnp.asarray(mask))
    ty, ts = ssm.mamba_forward(p, _t(x), cfg,
                               None if st is None else
                               {k: _t(a) for k, a in st.items()},
                               mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **STATE_TOL)
    _check_state(ts, s)
    if case == "right-pad":
        # the history ends at the last valid column, not the pad tail
        xi = (x @ np.asarray(jp["in_proj"]))[..., :ts["conv"].shape[-1]]
        np.testing.assert_allclose(ts["conv"][0].numpy(), xi[0, 6:9],
                                   atol=1e-5)


def test_mamba_step_matches_reference(mamba):
    cfg, jp, p, state, rng = mamba
    js = {k: jnp.asarray(a) for k, a in state.items()}
    ts = {k: _t(a) for k, a in state.items()}
    for _ in range(5):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        y, js = jssm.mamba_step(jp, jnp.asarray(x), cfg, js)
        ty, ts = ssm.mamba_step(p, _t(x), cfg, ts)
        np.testing.assert_allclose(ty.numpy(), np.asarray(y), **STATE_TOL)
        _check_state(ts, js)


def test_bf16_model_keeps_f32_mamba_leaves():
    """Mamba's ``A_log`` and ``D`` stay f32 in a bf16 tree: drawn so by
    ``init_params``, carried so by the bridge from the reference's bf16
    tree; ``h`` is f32 and the conv history and rolling K/V bf16."""
    cfg = dataclasses.replace(get_smoke_config(ARCH, max_d_model=32),
                              dtype="bfloat16")
    m = Model(cfg).init_params(seed=0, device="cpu")["blocks"][0]["mamba"]
    assert m["A_log"].dtype == m["D"].dtype == torch.float32
    assert m["in_proj"].dtype == m["conv_w"].dtype == torch.bfloat16
    jparams = _np_tree(JModel(cfg).init_params(jax.random.PRNGKey(0)))
    params = bridge.params_from_numpy(jparams, cfg, device="cpu")
    for blk in params["blocks"]:
        assert blk["mamba"]["A_log"].dtype == torch.float32
        assert blk["mamba"]["D"].dtype == torch.float32
        assert blk["mamba"]["x_proj"].dtype == torch.bfloat16
        assert blk["attn"]["wq"].dtype == blk["bn_a"]["scale"].dtype \
            == torch.bfloat16
    back = bridge.params_to_numpy(params, cfg)["blocks"]["s0_hymba"]
    want = jparams["blocks"]["s0_hymba"]
    np.testing.assert_array_equal(back["mamba"]["A_log"],
                                  want["mamba"]["A_log"])
    np.testing.assert_array_equal(back["mamba"]["in_proj"],
                                  want["mamba"]["in_proj"].astype(np.float32))
    st = cache_lib.init_row_state(cfg, 2, 40, torch.bfloat16, "cpu")[0]
    assert st["h"].dtype == torch.float32
    assert st["conv"].dtype == st["k"].dtype == torch.bfloat16
    assert st["k"].shape == (2, 16, cfg.num_kv_heads, cfg.resolved_head_dim)


# --------------------------------------------------------- rolling cache


def test_rolling_positions_match_reference():
    W = 8
    for length in (0, 3, 8, 9, 21):
        np.testing.assert_array_equal(
            cache_lib.rolling_kv_positions(length, W).numpy(),
            np.asarray(jcache.rolling_kv_positions(jnp.int32(length), W)))
    per_row = np.array([[0], [5], [8], [13], [30]], np.int32)
    np.testing.assert_array_equal(
        cache_lib.rolling_kv_positions(_t(per_row), W).numpy(),
        np.asarray(jcache.rolling_kv_positions(jnp.asarray(per_row), W)))


@pytest.mark.parametrize("arch", ["olmo-1b", "xlstm-350m", ARCH,
                                  "qwen2-moe-a2.7b"])
def test_paged_layers_match_reference_slots(arch):
    """The pooled layers are the reference's ``paged_slot_names``: full
    attention only, never a hymba layer's rolling K/V."""
    cfg = get_smoke_config(arch, max_d_model=32, num_layers=4)
    P = len(cfg.layer_pattern)
    names = {f"s{i % P}_{cfg.pattern_for_layer(i)}"
             for i in cache_lib.paged_layers(cfg)}
    assert names == set(jcache.paged_slot_names(cfg))
    assert list(Model(cfg).pool_index) == cache_lib.paged_layers(cfg)


def _kv(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rolling_writes_match_reference():
    rng = np.random.default_rng(4)
    B, W, KV, hd, S = 3, 6, 2, 4, 9
    buf = {n: _kv(rng, (1, B, W, KV, hd)) for n in ("k", "v")}
    k, v = _kv(rng, (B, S, KV, hd)), _kv(rng, (B, S, KV, hd))
    # row 0: 9 valid (more than W), row 1: left and right pads, row 2 none
    pos = np.array([np.arange(20, 29), [-1, -1, 3, 4, 5, 6, -1, -1, -1],
                    [-1] * 9], np.int32)
    want = jcache.rolling_write_seq({n: jnp.asarray(a) for n, a in
                                     buf.items()}, jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(pos),
                                    jnp.int32(0))
    got = {n: _t(a[0]) for n, a in buf.items()}
    plan = cache_lib.rolling_write_plan(_t(pos), W)
    cache_lib.rolling_write(got["k"], got["v"], _t(k), _t(v), plan)
    for n in ("k", "v"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n][0]))
    # one token per row, row 1 frozen
    tk, tv = _kv(rng, (B, 1, KV, hd)), _kv(rng, (B, 1, KV, hd))
    tpos, active = np.array([29, 7, 0], np.int32), np.array([1, 0, 1], bool)
    want = jcache.rolling_write_token(want, jnp.asarray(tk), jnp.asarray(tv),
                                      jnp.asarray(tpos), jnp.int32(0),
                                      jnp.asarray(active))
    cache_lib.rolling_write_token(got["k"], got["v"], _t(tk), _t(tv),
                                  _t(tpos), _t(active))
    for n in ("k", "v"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n][0]))
    # the shared-position write: a wrapping segment, a longer one
    for start, S in ((4, 5), (11, 14), (3, 1)):
        k, v = _kv(rng, (B, S, KV, hd)), _kv(rng, (B, S, KV, hd))
        if S == 1:
            want = jcache.write_token(want, jnp.asarray(k), jnp.asarray(v),
                                      jnp.int32(start), jnp.int32(0))
            cache_lib.write_token(got["k"], got["v"], _t(k), _t(v),
                                          start)
        else:
            want = jcache.write_seq(want, jnp.asarray(k), jnp.asarray(v),
                                    jnp.int32(start), jnp.int32(0))
            cache_lib.write_seq(got["k"], got["v"], _t(k), _t(v),
                                        start)
        for n in ("k", "v"):
            np.testing.assert_array_equal(got[n].numpy(),
                                          np.asarray(want[n][0]))


# ------------------------------------------------------------------ model


GQA5 = dict(num_heads=10, num_kv_heads=2, head_dim=64)


@pytest.fixture(scope="module", params=["smoke", "gqa5-hd64"])
def hymba(request):
    return bridged_pair(ARCH, **(GQA5 if request.param != "smoke" else {}))


def check_state(cfg, state, jc):
    """Per-row state against the reference cache's slots: a hymba
    layer's rolling K/V and Mamba state, recurrent cells' state."""
    P = len(cfg.layer_pattern)
    for i, st in state.items():
        kind = cfg.pattern_for_layer(i)
        slot = jc["slots"][f"s{i % P}_{kind}"]
        if kind == "hymba":
            for n in ("k", "v"):
                np.testing.assert_allclose(st[n].numpy(),
                                           np.asarray(slot[n][i // P]),
                                           atol=KV_TOL, rtol=0)
            slot = slot["mamba"]
        for n in ("h", "conv") if kind == "hymba" else st:
            np.testing.assert_allclose(st[n].numpy(),
                                       np.asarray(slot[n][i // P]),
                                       **STATE_TOL)


def check_forward(cfg, jparams, params, tol=None):
    """The full forward's logits within ``tol`` (default atol
    LOGIT_TOL)."""
    tol = tol or dict(atol=LOGIT_TOL, rtol=0)
    rng = np.random.default_rng(0)
    toks = rng.integers(5, VOCAB, (2, 24)).astype(np.int32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    want, _ = JModel(cfg).forward(jparams, {"tokens": jnp.asarray(toks),
                                            "positions": jnp.asarray(pos)})
    got = Model(cfg).forward(params, _t(toks), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def check_prefill_decode(cfg, jparams, params, relative, kv_cap, steps,
                         tol=None):
    """A left-padded batch prefilled at absolute positions, then decode
    steps of seeded tokens (past the window on hymba): logits (within
    ``tol``, default atol LOGIT_TOL), pools and per-row state against the
    reference's."""
    tol = tol or dict(atol=LOGIT_TOL, rtol=0)
    model, jm = Model(cfg), JModel(cfg)
    rng = np.random.default_rng(2)
    B, L, max_len = 3, 20, 48
    toks = rng.integers(5, VOCAB, (B, L)).astype(np.int32)
    first = np.array([0, 5, 11], np.int32)
    pos = np.where(np.arange(L)[None] >= first[:, None], np.arange(L)[None],
                   -1).astype(np.int32)
    c = model.init_cache(B, max_len, "cpu")
    c.first = _t(first)
    jc = jm.init_cache(B, max_len, jnp.float32)
    jc["first"] = jnp.asarray(first)
    got = [model.prefill(params, _t(toks), _t(pos), c)]
    lg, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks),
                                  "positions": jnp.asarray(pos)}, jc)
    want = [lg]
    step = jax.jit(jm.decode_step, static_argnames=("kv_cap", "relative"))
    for _ in range(steps):
        tok = rng.integers(5, VOCAB, (B, 1)).astype(np.int32)
        got.append(model.decode_step(params, _t(tok), c, kv_cap=kv_cap,
                                     relative=relative))
        lg, jc = step(jparams, jnp.asarray(tok), jc, kv_cap=kv_cap,
                      relative=relative)
        want.append(lg)
    assert c.length == int(jc["length"]) == L + steps
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    P = len(cfg.layer_pattern)
    for i, j in model.pool_index.items():
        slot = jc["slots"][f"s{i % P}_attn"]
        for n in ("k", "v"):
            np.testing.assert_allclose(getattr(c, n)[j].numpy(),
                                       np.asarray(slot[n][i // P]),
                                       atol=KV_TOL)
    check_state(cfg, c.state, jc)


def check_paged(cfg, jparams, params, dec=12, tol=None):
    """Paged chunked prefill of a 27-token and a right-padded 7-token row
    over non-contiguous block runs, then decode with row 1 frozen half
    way: logits (within ``tol``, default atol LOGIT_TOL), per-row lengths
    and state against the reference's."""
    tol = tol or dict(atol=LOGIT_TOL, rtol=0)
    model, jm = Model(cfg), JModel(cfg)
    B, C, bs, max_len, P, frame = 2, 8, 8, 64, 20, 32
    prompts = [[5 + (3 * i) % (VOCAB - 5) for i in range(27)],
               [31, 5, 17, 12, 9, 40, 41]]
    first = np.asarray([frame - 27, 0], np.int32)
    l_end = np.array([frame, 7], np.int32)          # row 1 right-padded
    toks = np.zeros((B, frame), np.int32)
    toks[0, first[0]:] = prompts[0]
    toks[1, :7] = prompts[1]
    tables = np.full((B, cache_lib.num_row_blocks(max_len, bs)), -1,
                     np.int32)
    tables[0, :7] = [5, 1, 7, 3, 4, 6, 8]
    tables[1, :4] = [2, 9, 0, 10]
    jc = jcache.init_paged_cache(cfg, B, max_len, bs, P, jnp.float32)
    jc.update(first=jnp.asarray(first), block_tables=jnp.asarray(tables))
    tc = model.init_paged_cache(B, max_len, bs, P, device="cpu")
    tc.first, tc.block_tables = _t(first), _t(tables)
    jchunk = jax.jit(jm.prefill_chunk)
    for j in range(frame // C):
        length = np.full(B, j * C, np.int32)
        abs_pos = length[:, None] + np.arange(C, dtype=np.int32)[None]
        valid = (abs_pos >= first[:, None]) & (abs_pos < l_end[:, None])
        pos = np.where(valid, abs_pos - first[:, None], -1).astype(np.int32)
        last_col = np.clip(l_end - 1 - length, 0, C - 1).astype(np.int32)
        chunk = toks[:, j * C:(j + 1) * C]
        want, jc = jchunk(jparams, {"tokens": jnp.asarray(chunk),
                                    "positions": jnp.asarray(pos),
                                    "last_col": jnp.asarray(last_col)}, jc)
        got = model.prefill_chunk(params, _t(chunk), _t(pos), tc,
                                  last_col=_t(last_col))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    # the right-padded row ends at its prompt (as a fork's suffix does)
    tc.length = _t(l_end)
    jc["length"] = jnp.asarray(l_end)
    check_state(cfg, tc.state, jc)
    jdecode = jax.jit(jm.decode_step, static_argnames=("relative", "nb_cap"))
    tok = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    for step in range(dec):
        active = np.asarray([True, step < dec // 2])
        want, jc = jdecode(jparams, jnp.asarray(tok), jc, relative=True,
                           nb_cap=8, active=jnp.asarray(active))
        got = model.decode_step(params, _t(tok), tc, nb_cap=8,
                                active=_t(active))
        np.testing.assert_allclose(got.numpy()[active],
                                   np.asarray(want)[active], **tol)
        tok = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
    assert tc.length.tolist() == np.asarray(jc["length"]).tolist() \
        == [frame + dec, 7 + dec // 2]


def test_hymba_forward_matches_reference(hymba):
    check_forward(*hymba)


@pytest.mark.parametrize("relative", [False, True])
def test_hymba_prefill_and_decode_match_reference(hymba, relative):
    check_prefill_decode(*hymba, relative=relative, kv_cap=None, steps=14)


def test_hymba_paged_chunks_and_decode_match_reference(hymba):
    cfg = hymba[0]
    assert cfg.sliding_window == 16 and cfg.layer_pattern == ("hymba",)
    check_paged(*hymba)


def test_hymba_prefill_does_not_depend_on_dead_attention_rows(monkeypatch):
    """The flash kernel leaves a pad query's row unspecified; hymba's
    unmasked prefill feeds the pad columns to the next layer's Mamba
    branch, so it sets those rows to the plain version's value
    (``layers.fill_pad_queries``): the logits and state after a
    left-padded prefill and a decode step are the same whatever the
    attention returns there."""
    cfg, _, params = bridged_pair(ARCH)
    model = Model(cfg)
    rng = np.random.default_rng(8)
    toks = rng.integers(5, VOCAB, (2, 12)).astype(np.int32)
    first = np.array([0, 5], np.int32)
    pos = np.where(np.arange(12)[None] >= first[:, None],
                   np.arange(12)[None], -1).astype(np.int32)
    tok = rng.integers(5, VOCAB, (2, 1)).astype(np.int32)

    def run():
        c = model.init_cache(2, 32, "cpu")
        c.first = _t(first)
        out = [model.prefill(params, _t(toks), _t(pos), c)]
        out.append(model.decode_step(params, _t(tok), c))
        return out, c.state

    want, want_state = run()
    plain = ops.flash_attention

    def unspecified(q, k, v, qp, kvp, **kw):
        out = plain(q, k, v, qp, kvp, **kw)
        return torch.where((qp < 0)[:, :, None, None],
                           torch.full_like(out, 7.0), out)

    monkeypatch.setattr(ops, "flash_attention", unspecified)
    got, got_state = run()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for i, st in got_state.items():
        for n, a in st.items():
            assert torch.equal(a, want_state[i][n]), (i, n)


@pytest.mark.parametrize("S,pads", [(300, (0, 40)), (600, (0, 60)),
                                    (600, (20, 540)), (1100, (0, 700))])
def test_fill_pad_queries_follows_the_reference_blocks(S, pads):
    """A pad query's row is the reference's: a uniform softmax over the
    key blocks of 512 its query block visits (``causal_skip`` drops a key
    block whose smallest position over the batch exceeds the query
    block's largest), zero V at the block padding.  At 1100 keys query
    block 0 skips key block 1; at <= 512 keys it is the mean of V."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    rng = np.random.default_rng(S + sum(pads))
    B, H, KV, hd = 2, 4, 2, 8
    first = np.asarray(pads, np.int32)
    pos = np.where(np.arange(S)[None] >= first[:, None],
                   np.arange(S)[None], -1).astype(np.int32)
    q, k, v = (rng.standard_normal((B, S, h, hd)).astype(np.float32)
               for h in (H, KV, KV))
    want = np.asarray(jlayers.flash_attention(
        *map(jnp.asarray, (q, k, v, pos, pos)), causal=True, window=16,
        q_block=min(512, S), kv_block=min(512, S)))
    plain = ops.flash_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                                causal=True, window=16)
    got = layers.fill_pad_queries(plain, _t(v), _t(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    if S == 1100:        # the skip matters: not the mean over every key
        mean = v.mean(axis=1)[:, None].repeat(2, axis=2)
        assert np.abs(got[1, :512] - mean[1]).max() > 1e-3


@pytest.mark.parametrize("lens", [(600, 540), (600, 60)])
def test_hymba_long_left_padded_wave_matches_reference(lens):
    """A left-padded ``generate`` wave of 600 tokens (max_len 704): the
    prefill runs the reference's 512-query blocks, so a pad column's
    attention row, which the next layer's Mamba branch absorbs, follows
    them.  Tokens equal the reference's, and the state after a prefill
    with 540 left pads is within atol 1e-6."""
    cfg, jparams, params = bridged_pair(ARCH)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(5, VOCAB, n).tolist() for n in lens]
    gp, jgp = GenerationParams(max_new_tokens=8), JGen(max_new_tokens=8)
    eng = ServeEngine(cfg, params, max_len=704, batch_size=2, device="cpu")
    jeng = JEngine(cfg, jparams, max_len=704, batch_size=2)
    ours = eng.generate(prompts, gen=gp)
    assert ours == eng.generate_reference(prompts, gen=gp) \
        == jeng.generate(prompts, gen=jgp)
    if lens[1] > 100:
        return
    toks = np.zeros((2, 600), np.int32)
    first = np.array([0, 600 - lens[1]], np.int32)
    for i, p in enumerate(prompts):
        toks[i, first[i]:] = p
    pos = np.where(np.arange(600)[None] >= first[:, None],
                   np.arange(600)[None], -1).astype(np.int32)
    model, jm = Model(cfg), JModel(cfg)
    c = model.init_cache(2, 704, "cpu")
    c.first = _t(first)
    jc = jm.init_cache(2, 704, jnp.float32)
    jc["first"] = jnp.asarray(first)
    model.prefill(params, _t(toks), _t(pos), c)
    _, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks),
                                 "positions": jnp.asarray(pos)}, jc)
    slot = jc["slots"]["s0_hymba"]["mamba"]
    for i, st in c.state.items():
        np.testing.assert_allclose(st["h"].numpy(), np.asarray(slot["h"][i]),
                                   atol=1e-6, rtol=0)


# ---------------------------------------------------------------- serving


PROMPTS = [[21, 3, 3, 17, 5, 6, 29, 11, 13, 40, 2, 2, 9, 44, 18, 1, 27],
           [8, 30, 2], [12, 33, 6, 7, 9, 10, 3, 8, 45]]


def check_generate(cfg, jparams, params):
    """generate / generate_reference against the reference's, with and
    without an EOS stop, and on a wave that decodes past the window."""
    eng = ServeEngine(cfg, params, max_len=64, batch_size=4, device="cpu")
    jeng = JEngine(cfg, jparams, max_len=64, batch_size=4)
    assert eng.model.moe_cf == jeng.model.moe_cf
    assert eng._exact_length == jeng._exact_length
    free = eng.generate(PROMPTS, max_new_tokens=6)
    for eos in (None, free[1][2]):
        gp, jgp = (GenerationParams(max_new_tokens=6, eos_id=eos),
                   JGen(max_new_tokens=6, eos_id=eos))
        ours = eng.generate(PROMPTS, gen=gp)
        assert ours == eng.generate_reference(PROMPTS, gen=gp) \
            == jeng.generate(PROMPTS, gen=jgp)
    assert any(len(o) < 6 and o[-1] == free[1][2] for o in ours)
    # the reference's wraparound case (tests/test_serving_engine.py):
    # prompt 4 + W + 6 new tokens, past a rolling window of W
    new = (cfg.sliding_window or 16) + 6
    wrap = [[1, 2, 3, 4], [5, 6, 7, 8]]
    gp, jgp = GenerationParams(max_new_tokens=new), JGen(max_new_tokens=new)
    ours = eng.generate(wrap, gen=gp)
    assert ours == eng.generate_reference(wrap, gen=gp) \
        == jeng.generate_reference(wrap, gen=jgp)
    assert all(len(o) == new for o in ours)


def check_paged_queue(cfg, jparams, params, stream, policy):
    """The paged continuous queue with forks of a shared prefix: tokens
    and every scheduler counter equal the reference's."""
    requests = serving_t.STREAMS[stream]
    free_run, _ = serving_t._port_run(cfg, params, None, policy, requests)
    eos = free_run[1][2]
    ours, ours_stats = serving_t._port_run(cfg, params, eos, policy,
                                           requests)
    jeng = JEngine(cfg, jparams, max_len=64, batch_size=2, prefill_chunk=8,
                   paged=True, block_size=8)
    theirs, theirs_stats = serving_t._run(
        JQueue(jeng, JGen(max_new_tokens=serving_t.BUDGET, eos_id=eos),
               key=jax.random.PRNGKey(0), policy=policy), requests)
    assert ours == theirs
    for name in serving_t.COUNTERS:
        assert getattr(ours_stats, name) == getattr(theirs_stats, name), name
    assert theirs_stats.refills >= 4 and theirs_stats.cow_forks >= 1
    assert theirs_stats.prefix_hits >= (3 if stream == "forks" else 1)


def check_wave_queue(cfg, jparams, params):
    eng = ServeEngine(cfg, params, max_len=64, batch_size=3, device="cpu")
    jeng = JEngine(cfg, jparams, max_len=64, batch_size=3)
    gp, jgp = GenerationParams(max_new_tokens=5), JGen(max_new_tokens=5)
    lengths = [3, 17, 9, 4, 12, 5, 30, 2]
    prompts = [wave_t._prompt(n, i) for i, n in enumerate(lengths)]
    ours = wave_t._wave_run(RequestQueue(eng, gp), prompts)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = wave_t._wave_run(JRequestQueue(jeng, jgp), prompts)
    assert ours == theirs
    assert ours[3][0] >= 3                       # several waves


def check_nonpaged_queues(cfg, jparams, params):
    """The non-paged continuous queue (frames recycled) and the same
    queue standing, round by round."""
    kw = dict(max_len=56, batch_size=2, prefill_chunk=8)
    eng, jeng = (ServeEngine(cfg, params, device="cpu", **kw),
                 JEngine(cfg, jparams, **kw))
    ours = wave_t._cont_run(ContinuousQueue(
        eng, GenerationParams(max_new_tokens=12)), wave_t.STREAM)
    theirs = wave_t._cont_run(JQueue(jeng, JGen(max_new_tokens=12)),
                              wave_t.STREAM)
    assert ours == theirs
    assert ours[1]["frames"] >= 2 and ours[1]["refills"] >= 2
    kw["max_len"] = 96
    eng, jeng = (ServeEngine(cfg, params, device="cpu", **kw),
                 JEngine(cfg, jparams, **kw))
    ours = wave_t._stream(ContinuousQueue(
        eng, GenerationParams(max_new_tokens=8), standing=True))
    theirs = wave_t._stream(JQueue(jeng, JGen(max_new_tokens=8),
                                   standing=True))
    assert ours == theirs


def check_standing_queue(cfg, jparams, params):
    """The paged standing queue with forks, a straddling row and a shed
    round (test_torch_standing.py's stream)."""
    kw = standing_t.KW
    eng, jeng = (ServeEngine(cfg, params, device="cpu", **kw),
                 JEngine(cfg, jparams, **kw))
    ours = standing_t._stream(ContinuousQueue(
        eng, GenerationParams(max_new_tokens=8), standing=True))
    theirs = standing_t._stream(JQueue(jeng, JGen(max_new_tokens=8),
                                       standing=True))
    assert ours == theirs
    assert ours[2]["frames"] == 1 and ours[2]["prefix_hits"] >= 2


def check_live_nodes(world, archs):
    """Two federated IVF nodes of ``archs`` with semantic caches, slot
    for slot: answers, qualities, contexts, sources and counters equal
    the reference's."""
    slots, emb = _slots(world)
    runs = {}
    for port in (True, False):
        nodes = _nodes(world, port, archs)
        Q = Query if port else JQuery
        out = []
        for j in range(2):
            for n, node in enumerate(nodes):
                qs = [Q(qa.domain, emb[qa.question], qid, qa.question,
                        qa.answer) for qid, qa in slots[n][j]]
                res = node.process_slot(qs, SLO)
                out.append(([(r.qid, r.node, r.model, r.answer, r.quality,
                              r.dropped) for r in res],
                            node.last_contexts, node.last_sources))
        stats = [{k: getattr(nd.stats, k) for k in wave_t.NODE_COUNTERS}
                 for nd in nodes]
        for nd in nodes:
            nd.close()
        runs[port] = (out, stats)
    assert runs[True] == runs[False]
    for st in runs[True][1]:
        assert st["queries"] == 9 and st["drops"] == 0
    return runs[True][1]


@pytest.fixture(scope="module")
def bridged():
    return bridged_pair(ARCH)


def test_hymba_generate_matches_reference(bridged):
    check_generate(*bridged)


@pytest.mark.parametrize("policy", ["fifo", "sjf"])
def test_hymba_paged_queue_with_forks_matches_reference(bridged, policy):
    check_paged_queue(*bridged, "forks", policy)


def test_hymba_wave_queue_matches_reference(bridged):
    check_wave_queue(*bridged)


def test_hymba_nonpaged_queues_match_reference(bridged):
    check_nonpaged_queues(*bridged)


def test_hymba_standing_queue_matches_reference(bridged):
    check_standing_queue(*bridged)


def test_live_nodes_of_both_archs_match_reference(world):
    """A hymba node beside a qwen2-moe node, paged, with prefix forks."""
    stats = check_live_nodes(world, ("hymba-1.5b", "qwen2-moe-a2.7b"))
    assert all(st["prefix_hits"] >= 1 for st in stats)


# -------------------------------------------------------------- launchers


def test_serve_main_runs_hymba(capsys):
    got = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "3", "--requests", "7", "--prompt-len",
                      "24", "--new-tokens", "5", "--max-len", "64",
                      "--reference"])
    assert "generated 35 tokens for 7 requests" in capsys.readouterr().out
    assert sorted(set(got["buckets"]), reverse=True) == [24, 12, 8]
    assert got["waves"] == 3 and got["generate_tok_s"] > 0


def test_cluster_serve_main_runs_four_nodes(capsys):
    """--nodes 4 cycles the reference's node archs (olmo-1b, xlstm-350m,
    hymba-1.5b, qwen2-moe-a2.7b) and serves through the paged standing
    queues."""
    cluster_serve.main(["--smoke", "--nodes", "4", "--slots", "2",
                        "--per-slot", "8", "--paged", "--standing",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "summary:" in out and "replaying 2 slots" in out
    for arch in cluster_serve.NODE_ARCHS:
        assert f"[{arch}]" in out
    assert "standing: 0 request(s) unfinished at exit" in out
