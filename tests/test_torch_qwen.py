"""The port's qwen3-moe-30b-a3b and qwen2-vl-72b paths against the
reference on the CPU (f32 smoke weights through the bridge unless noted):

  * qwen3's qk-norm: ``layers.qkv_project`` with per-head RMS on q and k
    (seeded scales) before RoPE, in f32 (atol 1e-5) and bf16 (within one
    bf16 ulp); the bridge carries ``q_norm`` / ``k_norm``;
  * qwen2-vl's M-RoPE: ``rope_angles`` / ``apply_rope`` with t/h/w
    positions [3, B, S] that differ, at the smoke sections (2, 3, 3) and
    the published 16/24/24 at head dim 128 (within 1e-6); equal t/h/w
    positions give RoPE exactly;
  * the MoE at qwen3's routing, 128 experts top-8 with no shared expert
    (d 64): a decode of 1, 2 and 4 rows (8, 16 and 32 assignments, so
    both of ``models/moe.py``'s routes) and a chunk at capacity factor
    1.25 that drops assignments, within 1e-5;
  * the model gate lets both archs through;
  * the model: forward and contiguous prefill + 4 decode steps with an
    8-patch vision prefix at positions whose t/h/w differ (qwen2-vl),
    two contiguous chunks at [3, B, C] positions + decode, forward,
    prefill + decode and paged chunked prefill + decode with a frozen row
    (``test_torch_hybrid.py``'s checks) for both archs and for qwen3 at
    128 experts top-8: logits within 1e-4.

The serving paths are in ``test_torch_qwen_serving.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

import test_torch_hybrid as hybrid_t  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import moe  # noqa: E402

QWEN3, VL = "qwen3-moe-30b-a3b", "qwen2-vl-72b"
ARCHS = (QWEN3, VL)
VOCAB = hybrid_t.VOCAB
LOGIT_TOL = dict(atol=1e-4, rtol=0)
MOE_TOL = 1e-5
# the reference's MoE, compiled once a shape (eager, each call retraces)
J_APPLY_MOE = jax.jit(jmoe.apply_moe, static_argnames=("cfg",
                                                       "capacity_factor"))


def _t(a):
    return torch.from_numpy(np.array(a))


def k8(cfg):
    """qwen3's published routing, 128 experts top-8, on a smoke config."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=128, num_experts_per_tok=8))


@functools.lru_cache(maxsize=None)
def qwen_pair(arch, key=3, variant="smoke"):
    """(cfg, reference params, port params) at the smoke config (d 64,
    vocab 48), or qwen3's with 128 experts top-8 (``variant`` "k8")."""
    cfg = get_smoke_config(arch, max_d_model=64, vocab=VOCAB)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        j_get_smoke_config(arch, max_d_model=64, vocab=VOCAB))
    if variant == "k8":
        cfg = k8(cfg)
    jparams = JModel(cfg).init_params(jax.random.PRNGKey(key))
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return cfg, jparams, params


def mrope_positions(B, Nv, S, grid_w=4):
    """[3, B, Nv + S] t/h/w positions: t counts every column; a patch's h
    and w are its row and column in a grid ``grid_w`` wide, a text
    token's equal t (Qwen2-VL's layout with a monotone t axis, so masks
    and cache slots follow the columns)."""
    t = np.arange(Nv + S)
    h, w = t.copy(), t.copy()
    h[:Nv], w[:Nv] = t[:Nv] // grid_w, t[:Nv] % grid_w
    return np.broadcast_to(np.stack([t, h, w])[:, None],
                           (3, B, Nv + S)).astype(np.int32).copy()


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_project_with_qk_norm_matches_reference(dtype):
    """Per-head RMS on q and k (eps 1e-6 in f32, the scale lifted to f32,
    cast back), then RoPE; v untouched."""
    cfg = get_smoke_config(QWEN3, max_d_model=64)
    assert cfg.qk_norm
    jp = jlayers.init_attention(jax.random.PRNGKey(5), cfg, jnp.float32)
    assert jp["q_norm"].shape == (cfg.resolved_head_dim,)
    rng = np.random.default_rng(3)
    for name in ("q_norm", "k_norm"):      # scales away from 1
        jp[name] = jnp.asarray(rng.uniform(0.5, 2.0, jp[name].shape)
                               .astype(np.float32))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    jp = {k: a.astype(jdt) for k, a in jp.items()}
    p = {k: _t(np.asarray(a, np.float32)).to(tdt) for k, a in jp.items()}
    x = (rng.standard_normal((2, 7, cfg.d_model)) * 2).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7)).copy()
    jang = jlayers.rope_angles(jnp.asarray(pos), cfg.resolved_head_dim,
                               cfg.rope_theta)
    want = jlayers.qkv_project(jp, jnp.asarray(x).astype(jdt), cfg, jang)
    ang = layers.rope_angles(_t(pos), cfg.resolved_head_dim, cfg.rope_theta)
    got = layers.qkv_project(p, _t(x).to(tdt), cfg, ang)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        w = np.asarray(w.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)
        else:       # one bf16 ulp of each value (8 bits of mantissa)
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w),
                                                      2.0 ** -126))) - 7)
            assert (np.abs(g.float().numpy() - w) <= ulp).all()
    # the norm binds: without it q differs
    plain = dataclasses.replace(cfg, qk_norm=False)
    assert not torch.allclose(layers.qkv_project(p, _t(x).to(tdt), plain,
                                                 ang)[0].float(),
                              got[0].float(), atol=1e-2)


@pytest.mark.parametrize("case", ["smoke", "published"])
def test_mrope_angles_and_rotation_match_reference(case):
    """M-RoPE with t/h/w positions that differ: the smoke sections of
    qwen2-vl (hd 16) and the published 16/24/24 (hd 128)."""
    cfg = get_smoke_config(VL, max_d_model=64) if case == "smoke" \
        else get_config(VL)
    hd, secs = cfg.resolved_head_dim, cfg.mrope_sections
    assert (hd, secs) == {"smoke": (16, (2, 3, 3)),
                          "published": (128, (16, 24, 24))}[case]
    B, Nv, S = 2, 8, 5
    pos = mrope_positions(B, Nv, S)
    pos[:, 1, :3] = -1           # a left-padded row
    want = jlayers.rope_angles(jnp.asarray(pos), hd, cfg.rope_theta, secs)
    got = layers.rope_angles(_t(pos), hd, cfg.rope_theta, secs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    x = np.random.default_rng(4).standard_normal(
        (B, Nv + S, 3, hd)).astype(np.float32)
    np.testing.assert_allclose(
        layers.apply_rope(_t(x), got).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), want)), atol=1e-6,
        rtol=0)
    # distinct h/w move the angles; equal t/h/w give RoPE of axis 0
    flat = layers.rope_angles(_t(pos[0]), hd, cfg.rope_theta)
    assert not torch.equal(got, flat)
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    assert torch.equal(layers.rope_angles(_t(same), hd, cfg.rope_theta,
                                          secs), flat)


# --------------------------------------------------------------------- MoE


@pytest.fixture(scope="module")
def moe_k8():
    """One MoE layer at qwen3's routing: 128 experts, top-8, no shared
    expert, d 64."""
    cfg = k8(get_smoke_config(QWEN3, max_d_model=64))
    m = cfg.moe
    assert (m.num_experts, m.num_experts_per_tok, m.num_shared_experts) \
        == (128, 8, 0)
    jp = jmoe.init_moe(jax.random.PRNGKey(2), cfg, jnp.float32)
    assert "shared" not in jp
    p = bridge._to_torch(jax.tree_util.tree_map(np.asarray, jp),
                         torch.device("cpu"))
    return cfg, jp, p


@pytest.mark.parametrize("B,S,cf", [(1, 1, None), (2, 1, None),
                                    (4, 1, None), (2, 12, 1.25)],
                         ids=["decode1", "decode2", "decode4", "chunk"])
def test_apply_moe_top8_of_128_matches_reference(moe_k8, B, S, cf):
    """Decodes of 8 and 16 assignments gather weights, 32 go to the
    sorted-rows route, as does the chunk, whose capacity (1 slot an
    expert at cf 1.25) drops assignments."""
    cfg, jp, p = moe_k8
    E, k = cfg.moe.num_experts, cfg.moe.num_experts_per_tok
    cf = cf or float(E)
    x = np.random.default_rng(B * 10 + S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    assert (B * S * k <= moe.MOE_GATHER_MAX) == (B * S <= 2)
    want, _ = J_APPLY_MOE(jp, jnp.asarray(x), cfg=cfg, capacity_factor=cf)
    got = moe.apply_moe(p, _t(x), cfg, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOE_TOL,
                               rtol=0)
    idx, _ = moe.route(p, _t(x), k)
    keep = moe.capacity_keep(idx, E, moe.capacity(S, k, E, cf))
    assert bool(keep.all()) == (S == 1)


# ----------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", ARCHS)
def test_model_gate_lets_both_archs_through(arch):
    """The published and smoke configs build a model of "attn" layers
    only, every one pooled (their equality with the reference's is
    ``test_torch_imports.py``'s)."""
    cfg, smoke = get_config(arch), get_smoke_config(arch)
    want = {QWEN3: (True, False, 8, 128, 4),
            VL: (False, True, 8, 128, 8)}[arch]
    assert (cfg.qk_norm, cfg.use_mrope, cfg.num_heads // cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.num_kv_heads) == want
    for c in (cfg, smoke):
        model = Model(c)
        assert model.kinds == ["attn"] * c.num_layers
        assert len(model.pool_index) == c.num_layers and not model.rolling


# ------------------------------------------------------------------- model


@pytest.fixture(scope="module",
                params=[QWEN3, VL, QWEN3 + "-k8"])
def pair(request):
    arch = request.param.replace("-k8", "")
    return qwen_pair(arch, variant="k8" if request.param.endswith("-k8")
                     else "smoke")


def test_qwen_forward_matches_reference(pair):
    hybrid_t.check_forward(*pair)


@pytest.mark.parametrize("arch", ARCHS)
def test_qwen_prefill_and_decode_match_reference(arch):
    hybrid_t.check_prefill_decode(*qwen_pair(arch), relative=False,
                                  kv_cap=None, steps=4)


def test_qwen_paged_chunks_and_decode_match_reference(pair):
    hybrid_t.check_paged(*pair, dec=6)


@pytest.fixture
def vl():
    return qwen_pair(VL)


def _vision(cfg, B, seed=8):
    return (np.random.default_rng(seed).standard_normal(
        (B, cfg.num_vision_tokens, cfg.d_model)) * 0.5).astype(np.float32)


def test_vl_forward_with_vision_prefix_matches_reference(vl):
    """An 8-patch prefix before 12 tokens at t/h/w positions that differ:
    logits of every column; the positions' h/w change them."""
    cfg, jparams, params = vl
    B, S, Nv = 2, 12, cfg.num_vision_tokens
    assert Nv == 8
    toks = np.random.default_rng(1).integers(5, VOCAB, (B, S)).astype(
        np.int32)
    ve, pos = _vision(cfg, B), mrope_positions(B, Nv, S)
    want, _ = JModel(cfg).forward(jparams, {
        "tokens": jnp.asarray(toks), "positions": jnp.asarray(pos),
        "vision_embeds": jnp.asarray(ve)})
    model = Model(cfg)
    got = model.forward(params, _t(toks), _t(pos), vision_embeds=_t(ve))
    assert got.shape == (B, Nv + S, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    flat = model.forward(params, _t(toks), _t(pos[0]), vision_embeds=_t(ve))
    assert (flat - got).abs().max() > 1e-3


def test_vl_prefill_with_vision_prefix_and_decode_match_reference(vl):
    """prefill of an 8-patch prefix and 12 tokens at [3, B, S] positions
    (length advances by 20), then 4 decode steps: logits and the K/V
    buffers against the reference's."""
    cfg, jparams, params = vl
    model, jm = Model(cfg), JModel(cfg)
    B, S, Nv, max_len, steps = 2, 12, cfg.num_vision_tokens, 32, 4
    rng = np.random.default_rng(2)
    toks = rng.integers(5, VOCAB, (B, S)).astype(np.int32)
    ve, pos = _vision(cfg, B), mrope_positions(B, Nv, S)
    c = model.init_cache(B, max_len, "cpu")
    jc = jm.init_cache(B, max_len, jnp.float32)
    got = [model.prefill(params, _t(toks), _t(pos), c, vision_embeds=_t(ve))]
    lg, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks),
                                  "positions": jnp.asarray(pos),
                                  "vision_embeds": jnp.asarray(ve)}, jc)
    want = [lg]
    assert c.length == int(jc["length"]) == Nv + S
    for _ in range(steps):
        tok = rng.integers(5, VOCAB, (B, 1)).astype(np.int32)
        got.append(model.decode_step(params, _t(tok), c))
        lg, jc = jm.decode_step(jparams, jnp.asarray(tok), jc)
        want.append(lg)
    assert c.length == int(jc["length"]) == Nv + S + steps
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOGIT_TOL)
    for j in range(cfg.num_layers):
        slot = jc["slots"]["s0_attn"]
        for n in ("k", "v"):
            np.testing.assert_allclose(getattr(c, n)[j].numpy(),
                                       np.asarray(slot[n][j]),
                                       atol=hybrid_t.KV_TOL, rtol=0)


def test_vl_chunks_at_mrope_positions_match_reference(vl):
    """Two contiguous chunks of 8 at relative [3, B, C] positions whose
    h/w differ (a left-padded row), then 3 relative decode steps."""
    cfg, jparams, params = vl
    model, jm = Model(cfg), JModel(cfg)
    B, C, max_len = 2, 8, 32
    rng = np.random.default_rng(6)
    first = np.array([0, 3], np.int32)
    pos = np.empty((3, B, 2 * C), np.int32)
    for b in range(B):
        pos[:, b] = mrope_positions(1, 6, 2 * C - 6)[:, 0] - first[b]
    pos[:, 1, :first[1]] = -1
    toks = rng.integers(5, VOCAB, (B, 2 * C)).astype(np.int32)
    c = model.init_cache(B, max_len, "cpu")
    c.first = _t(first)
    jc = jm.init_cache(B, max_len, jnp.float32)
    jc["first"] = jnp.asarray(first)
    for j in range(2):
        cols = slice(j * C, (j + 1) * C)
        lg, jc = jm.prefill_chunk(jparams, {
            "tokens": jnp.asarray(toks[:, cols]),
            "positions": jnp.asarray(pos[:, :, cols])}, jc)
        got = model.prefill_chunk(params, _t(toks[:, cols]),
                                  _t(pos[:, :, cols]), c)
        np.testing.assert_allclose(got.numpy(), np.asarray(lg), **LOGIT_TOL)
    for _ in range(3):
        tok = rng.integers(5, VOCAB, (B, 1)).astype(np.int32)
        lg, jc = jm.decode_step(jparams, jnp.asarray(tok), jc, relative=True)
        got = model.decode_step(params, _t(tok), c, relative=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(lg), **LOGIT_TOL)


def test_qk_norm_leaves_cross_the_bridge():
    """``q_norm`` / ``k_norm`` [hd] per layer, both ways exactly, and a
    port model draws them as ones."""
    cfg, jparams, params = qwen_pair(QWEN3, key=4)
    rng = np.random.default_rng(0)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    slot = np_params["blocks"]["s0_attn"]["attn"]
    assert slot["q_norm"].shape == (cfg.num_layers, cfg.resolved_head_dim)
    for name in ("q_norm", "k_norm"):
        slot[name] = rng.uniform(0.5, 2.0, slot[name].shape).astype(
            np.float32)
    ours = bridge.params_from_numpy(np_params, cfg, device="cpu")
    for i, blk in enumerate(ours["blocks"]):
        for name in ("q_norm", "k_norm"):
            assert np.array_equal(blk["attn"][name].numpy(),
                                  slot[name][i])
    back = bridge.params_to_numpy(ours, cfg)["blocks"]["s0_attn"]["attn"]
    for name in ("q_norm", "k_norm"):
        assert np.array_equal(back[name], slot[name])
    drawn = Model(cfg).init_params(seed=0, device="cpu")["blocks"][1]["attn"]
    assert torch.equal(drawn["k_norm"], torch.ones(cfg.resolved_head_dim))
