"""The port's qwen2-moe-a2.7b path against the reference on the CPU (f32
smoke weights through the bridge):

  * the MoE function (``models/moe.py``) against ``repro.models.moe``:
    routing (ties go to the lower expert id, as ``lax.top_k``), the
    per-row capacity drops against the reference's sort-based dispatch,
    and ``apply_moe`` at capacity factor 1.25 on a batch that drops
    assignments and at cf = E (dropless), through both of the port's
    routes (gathered weights at decode sizes, per-expert products in a
    chunk): within 1e-5 (the same f32 products; the combine adds each
    token's contributions in increasing expert id, the order the
    reference's sorted scatter-add visits them);
  * the bridge carries the [E, d_in, d_out] expert stacks, the router
    and the shared expert both ways exactly;
  * the model: forward (cf 1.25, with drops), contiguous prefill +
    decode, paged chunked prefill + decode with a frozen row (the
    engine's cf = E): logits within 1e-4, pools within 1e-5;
  * greedy tokens of ``generate`` / ``generate_reference``, the paged
    continuous queue with forks under FIFO and SJF, the wave
    ``RequestQueue`` and the non-paged and the standing queues equal the
    reference's exactly (``test_torch_hybrid.py``'s checks; the live
    node pair of both archs is there);
  * ``serve.main --arch qwen2-moe-a2.7b`` on ``--device cpu``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_hybrid as hybrid_t  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402

ARCH = "qwen2-moe-a2.7b"
MOE_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def layer():
    """One MoE layer of the smoke config with 6 experts, top 2."""
    cfg = get_smoke_config(ARCH, max_d_model=64, max_experts=6)
    jp = jmoe.init_moe(jax.random.PRNGKey(2), cfg, jnp.float32)
    p = bridge._to_torch(jax.tree_util.tree_map(np.asarray, jp),
                         torch.device("cpu"))
    return cfg, jp, p


def test_route_breaks_ties_to_the_lower_expert(layer):
    cfg, _, p = layer
    k = cfg.moe.num_experts_per_tok
    logits = np.array([[[1.0, 3.0, 3.0, 0.5, 3.0, 2.0],
                        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(logits), k)
    # the router as the identity: x @ router == logits
    eye = {"router": torch.eye(6)}
    idx, gates = moe.route(eye, _t(logits), k)
    assert idx.tolist() == np.asarray(want).tolist() == [[[1, 2], [0, 1]]]
    np.testing.assert_allclose(gates.numpy(), 0.5, atol=1e-7)


@pytest.mark.parametrize("S,cf", [(16, 1.25), (16, 0.5), (3, 1.0)])
def test_capacity_keep_matches_reference_dispatch(layer, S, cf):
    cfg, jp, p = layer
    E, k = cfg.moe.num_experts, cfg.moe.num_experts_per_tok
    rng = np.random.default_rng(S)
    idx = np.stack([np.stack([rng.choice(E, k, replace=False)
                              for _ in range(S)]) for _ in range(2)])
    C = moe.capacity(S, k, E, cf)
    assert C == min(S * k, max(1, int(np.ceil(S * k / E * cf))))
    keep = moe.capacity_keep(_t(idx), E, C).numpy()
    for b in range(2):
        x = jnp.zeros((S, 4))
        _, _, jkeep, tok, _ = jmoe._dispatch_group(
            x, jnp.asarray(idx[b]), jnp.ones((S, k)), E, C)
        order = np.argsort(idx[b].reshape(-1), kind="stable")
        want = np.zeros(S * k, bool)
        want[order] = np.asarray(jkeep)
        np.testing.assert_array_equal(keep[b].reshape(-1), want)
        assert list(np.asarray(tok)) == list(order // k)
    if cf < 1:
        assert not keep.all()


@pytest.mark.parametrize("S", [1, 12], ids=["gathered", "grouped"])
@pytest.mark.parametrize("cf", [1.25, None], ids=["cf1.25", "cfE"])
def test_apply_moe_matches_reference(layer, S, cf):
    cfg, jp, p = layer
    E, k = cfg.moe.num_experts, cfg.moe.num_experts_per_tok
    cf = cf or float(E)
    B = 3 if S > 1 else 4
    x = np.random.default_rng(7).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    assert (B * S * k <= moe.MOE_GATHER_MAX) == (S == 1)
    want, _ = jmoe.apply_moe(jp, jnp.asarray(x), cfg, capacity_factor=cf)
    got = moe.apply_moe(p, _t(x), cfg, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOE_TOL,
                               rtol=0)
    idx, _ = moe.route(p, _t(x), k)
    keep = moe.capacity_keep(idx, E, moe.capacity(S, k, E, cf))
    # the chunk at cf 1.25 drops assignments; cf = E and decode never do
    assert bool(keep.all()) == (cf == E or S == 1)


def test_moe_params_bridge_round_trip():
    cfg = get_smoke_config(ARCH, max_d_model=64)
    params = Model(cfg).init_params(seed=1, device="cpu")
    blk = params["blocks"][0]["moe"]
    E, f = cfg.moe.num_experts, cfg.moe.expert_d_ff
    assert blk["wg"].shape == (E, cfg.d_model, f)
    assert blk["wo"].shape == (E, f, cfg.d_model)
    assert blk["shared"]["gate"].shape == (cfg.d_model, 1)
    back = bridge.params_to_numpy(params, cfg)
    assert back["blocks"]["s0_attn"]["moe"]["wi"].shape == \
        (cfg.num_layers, E, cfg.d_model, f)
    again = bridge.params_from_numpy(back, cfg, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(again)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ model


@pytest.fixture(scope="module")
def bridged():
    return hybrid_t.bridged_pair(ARCH)


def test_moe_forward_matches_reference(bridged):
    """Model's default capacity factor (1.25): the forward drops."""
    hybrid_t.check_forward(*bridged)


@pytest.mark.parametrize("relative,kv_cap", [(False, None), (True, 32)])
def test_moe_prefill_and_decode_match_reference(bridged, relative, kv_cap):
    hybrid_t.check_prefill_decode(*bridged, relative=relative,
                                  kv_cap=kv_cap, steps=4)


def test_moe_paged_chunks_and_decode_match_reference(bridged):
    hybrid_t.check_paged(*bridged, dec=6)


# ---------------------------------------------------------------- serving


def test_engine_serves_dropless(bridged):
    cfg, _, params = bridged
    eng = ServeEngine(cfg, params, max_len=32, device="cpu")
    assert eng.model.moe_cf == float(cfg.moe.num_experts)
    assert Model(cfg).moe_cf == 1.25
    assert not eng._exact_length


def test_moe_generate_matches_reference(bridged):
    hybrid_t.check_generate(*bridged)


@pytest.mark.parametrize("policy", ["fifo", "sjf"])
def test_moe_paged_queue_with_forks_matches_reference(bridged, policy):
    hybrid_t.check_paged_queue(*bridged, "mixed", policy)


def test_moe_wave_queue_matches_reference(bridged):
    hybrid_t.check_wave_queue(*bridged)


def test_moe_nonpaged_queues_match_reference(bridged):
    hybrid_t.check_nonpaged_queues(*bridged)


def test_moe_standing_queue_matches_reference(bridged):
    hybrid_t.check_standing_queue(*bridged)


def test_serve_main_runs_qwen2_moe(capsys):
    got = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "3", "--requests", "7", "--prompt-len",
                      "24", "--new-tokens", "5", "--max-len", "64",
                      "--reference"])
    assert "generated 35 tokens for 7 requests" in capsys.readouterr().out
    assert sorted(set(got["buckets"]), reverse=True) == [32, 16, 8]
    assert got["waves"] == 3 and got["generate_tok_s"] > 0
