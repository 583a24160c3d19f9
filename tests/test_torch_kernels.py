"""The port's plain kernel versions (what its wrappers run for CPU tensors)
against the reference's Pallas kernels in interpret mode and its jnp
oracles, on the reference's own test cases.

Tolerance: 1e-5 absolute in f32 for attention outputs and retrieval
scores (the same math summed in another order); doc ids exactly."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.paged_attention import \
    paged_decode_attention_pallas  # noqa: E402
from repro.kernels.topk_retrieval import topk_pallas  # noqa: E402
from repro.models.layers import flash_attention as jnp_flash  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402

TOL = 1e-5


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _paged_inputs():
    """The cases of tests/test_paged_kv.py: GQA, -1 table entries,
    per-row first/last windows."""
    rng = np.random.default_rng(0)
    B, H, KV, hd, bs, P = 3, 4, 2, 16, 8, 10
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = rng.standard_normal((P, bs, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((P, bs, KV, hd)).astype(np.float32)
    tables = np.asarray([[0, 1, 2, -1], [3, 4, -1, -1], [5, 6, 7, 8]],
                        np.int32)
    first = np.asarray([2, 0, 5], np.int32)
    last = np.asarray([20, 9, 30], np.int32)
    return q, kp, vp, tables, first, last


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_paged_attention_matches_pallas_and_oracle(softcap):
    args = _paged_inputs()
    got = ops.paged_decode_attention(*map(t, args), softcap=softcap)
    jargs = [jnp.asarray(a) for a in args]
    pallas = paged_decode_attention_pallas(*jargs, softcap=softcap,
                                           interpret=True)
    oracle = jref.paged_attention_ref(*jargs, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=0,
                               atol=TOL)


def test_paged_attention_all_unallocated_row_is_finite():
    B, H, KV, hd, bs, P = 2, 2, 1, 8, 4, 4
    q = np.ones((B, H, hd), np.float32)
    kp = np.ones((P, bs, KV, hd), np.float32)
    vp = np.ones((P, bs, KV, hd), np.float32)
    tables = np.asarray([[0, 1], [-1, -1]], np.int32)
    first = np.asarray([0, 0], np.int32)
    last = np.asarray([5, 0], np.int32)
    got = ops.paged_decode_attention(*map(t, (q, kp, vp, tables, first,
                                              last)))
    assert torch.isfinite(got).all()
    pallas = paged_decode_attention_pallas(
        *map(jnp.asarray, (q, kp, vp, tables, first, last)), interpret=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(pallas[0]), rtol=0,
                               atol=TOL)


FLASH_CASES = [
    # B, H, KV, Sq, Sk, hd, causal, window, softcap (tests/test_kernels.py)
    (2, 4, 2, 64, 64, 32, True, None, None),
    (1, 8, 8, 96, 96, 64, True, None, 50.0),
    (2, 4, 1, 128, 128, 16, True, 32, None),
    (1, 2, 2, 17, 33, 8, False, None, None),
    (1, 4, 2, 40, 72, 32, True, 16, 30.0),
    (1, 1, 1, 8, 8, 128, True, None, None),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_aligned_matches_pallas(case):
    B, H, KV, Sq, Sk, hd, causal, window, cap = case
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, H, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, Sk, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, Sk, hd)).astype(np.float32)
    got = ops.flash_attention_aligned(t(q), t(k), t(v), causal=causal,
                                      window=window, softcap=cap)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, softcap=cap, q_block=32,
                                  kv_block=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("kw", [{}, {"softcap": 30.0}, {"window": 6}],
                         ids=["plain", "softcap", "window"])
def test_flash_positions_match_layers_flash(kw):
    """Chunked-prefill shaped inputs: invalid (-1) kv slots in the
    gathered buffer, pad queries at position -1.  Valid rows match the
    reference's jnp flash; every row is finite."""
    rng = np.random.default_rng(2)
    B, Sq, Sk, H, KV, hd = 2, 8, 24, 4, 2, 16
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    kv_pos = np.full((B, Sk), -1, np.int32)
    q_pos = np.full((B, Sq), -1, np.int32)
    past, pads = [9, 0], [0, 3]
    for b in range(B):
        kv_pos[b, :past[b]] = np.arange(past[b])
        real = np.arange(past[b], past[b] + Sq - pads[b])
        q_pos[b, pads[b]:] = real
        kv_pos[b, Sk - Sq + pads[b]:] = real
    got = ops.flash_attention(t(q), t(k), t(v), t(q_pos), t(kv_pos),
                              causal=True, **kw)
    want = jnp_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=True,
                     q_block=8, kv_block=8, **kw)
    assert torch.isfinite(got).all()
    rows = q_pos >= 0
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                               rtol=0, atol=TOL)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _topk_vs_pallas(q, docs, k, qb=16, db=64):
    s, i = ops.retrieval_topk(t(q), t(docs), k)
    s2, i2 = topk_pallas(jnp.asarray(q), jnp.asarray(docs), k, q_block=qb,
                         d_block=db, interpret=True)
    assert s.shape == (q.shape[0], k) and i.dtype == torch.int32
    np.testing.assert_allclose(s.numpy(), np.asarray(s2), rtol=0, atol=TOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i2))
    return s.numpy(), i.numpy()


@pytest.mark.parametrize("nq,nd,d,k,qb,db", [
    (5, 37, 16, 4, 16, 64),      # doc count far off the block multiple
    (7, 130, 24, 3, 4, 32),      # both axes ragged, odd feature dim
    (3, 65, 8, 5, 8, 64),        # one doc past a block boundary
    (1, 9, 128, 2, 16, 8),       # single query, docs < one block
])
def test_topk_matches_pallas_ragged(nq, nd, d, k, qb, db):
    rng = np.random.default_rng(nd)
    _topk_vs_pallas(_unit(rng, nq, d), _unit(rng, nd, d), k, qb, db)


def test_topk_ties_go_to_lowest_id():
    rng = np.random.default_rng(4)
    base = _unit(rng, 6, 16)
    docs = np.concatenate([base, base, base])      # ids i, i+6, i+12 tie
    s, i = _topk_vs_pallas(base[:4] * 2.0, docs, 4, qb=4, db=8)
    assert (i[:, 0] == np.arange(4)).all()
    assert (i[:, 1] == np.arange(4) + 6).all()
    assert np.abs(s[:, 0] - s[:, 1]).max() < TOL   # real ties


def test_topk_k_exceeds_corpus_fills():
    rng = np.random.default_rng(5)
    q, docs = _unit(rng, 4, 8), _unit(rng, 3, 8)
    s, i = _topk_vs_pallas(q, docs, 5)
    assert (i[:, 3:] == -1).all() and (s[:, 3:] <= -1e29).all()


def test_wrappers_take_plain_path_on_cpu_and_count_nothing():
    ops.reset_launches()
    args = _paged_inputs()
    ops.paged_decode_attention(*map(t, args))
    x = torch.randn(1, 4, 2, 8)
    pos = torch.arange(4, dtype=torch.int32)[None]
    ops.flash_attention(x, x, x, pos, pos)
    ops.flash_attention_bwd(x, x, x, pos, pos, x, x, torch.zeros(1, 2, 4))
    ops.retrieval_topk(torch.randn(2, 8), torch.randn(5, 8), 2)
    ops.ivf_retrieval_topk(torch.randn(2, 8), torch.randn(3, 4, 8),
                           torch.arange(12, dtype=torch.int32).view(3, 4),
                           torch.zeros(2, 1, dtype=torch.int32), 2)
    assert ops.launches == {"paged_decode_attention": 0,
                            "flash_attention": 0,
                            "flash_attention_bwd": 0, "retrieval_topk": 0,
                            "ivf_retrieval_topk": 0,
                            "retrieval_topk_list": 0,
                            "retrieval_topk_select": 0,
                            "ivf_retrieval_topk_select": 0}


def test_wrappers_reject_other_devices():
    m = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.retrieval_topk(m, m, 1)
    with pytest.raises(ValueError, match="different devices"):
        ops.retrieval_topk(torch.randn(2, 8), m, 1)

