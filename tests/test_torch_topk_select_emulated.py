"""``csrc/topk_select.cu`` built with g++ against ``tests/cuda_emu.h``
(``test_torch_topk_select.py``'s ``emulated`` fixture, which also builds
``csrc/topk_list.cu`` and ``csrc/topk.cu``), on the cases that run the
emulation longest: the reference's Pallas kernel in interpret mode,
integer ties at the k-th across select chunks, sort runs and query
chunks, a -0.0 / +0.0 pair, an unaligned pointer, equal doc rows across
scan splits and select chunks, and the first 6176 of k 6177 bitwise
``topk_list.cu``'s k 6176 and the first 32 ``topk.cu``'s k 32.  They sit
in a file of their own, which ``--dist loadfile`` gives a worker of its
own.  Tolerances as in ``test_torch_topk_select.py``."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.kernels.topk_retrieval import topk_pallas  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from test_torch_topk_select import (  # noqa: E402,F401  (emulated: fixture)
    LIMIT, TOL, _ids_agree, _plain, _run_select, _unit, emulated)


def test_cuda_source_emulated_matches_pallas(emulated):
    rng = np.random.default_rng(11)
    q, d = _unit(rng, 3, 8), _unit(rng, 1300, 8)
    s, i = _run_select(emulated, torch.from_numpy(q), torch.from_numpy(d),
                       1100)
    s_p, i_p = topk_pallas(jnp.asarray(q), jnp.asarray(d), 1100,
                           interpret=True)
    np.testing.assert_allclose(s, np.asarray(s_p), rtol=0, atol=TOL)
    assert _ids_agree(np.asarray(s_p), i, np.asarray(i_p))


@pytest.mark.parametrize("k,chunk_q", [(700, None), (1500, None),
                                       (2500, 3)])
def test_cuda_source_emulated_integer_ties_at_the_kth(emulated, k, chunk_q):
    """Exact scores with hundreds of ties at the k-th, across select
    chunks (3 of 5336 docs) and sort runs, and at k 2500 in query chunks
    of 3: ids and scores equal exactly."""
    rng = np.random.default_rng(k)
    d = torch.from_numpy(rng.integers(-2, 3, (16000, 6)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-2, 3, (4, 6)).astype(np.float32))
    s, i = _run_select(emulated, q, d, k, chunk_q)
    s_r, i_r = _plain(q, d, k)
    np.testing.assert_array_equal(s, s_r)
    np.testing.assert_array_equal(i, i_r)
    kth = s_r[:, -1:]
    assert (((q @ d.T).numpy() == kth).sum(1) > 100).all()


def test_cuda_source_emulated_negative_zero(emulated):
    """fmaf(1e-30, -1e-20, 0) underflows to -0.0 (doc 2), and +1e-20 to
    +0.0 (doc 5): the two tie at the k-th, and the lower id, doc 2, is
    taken although +0.0 > -0.0 as bits.  D 32, one ring chunk: the
    chunk's zero-filled dims would add +0.0 (0 * 0 + -0.0 is +0.0), so
    doc 2's other dims are -0.0 (0 * -0.0 + -0.0 stays -0.0)."""
    rng = np.random.default_rng(2)
    d = np.zeros((300, 32), np.float32)
    d[:, 0] = rng.uniform(-1, 1, 300)
    d[2] = -0.0
    d[2, 0], d[5, 0] = -1e-20, 1e-20
    q = np.zeros((1, 32), np.float32)
    q[0, 0] = 1e-30
    k = int((d[:, 0] > 1e-6).sum()) + 1
    s, i = _run_select(emulated, torch.from_numpy(q), torch.from_numpy(d), k)
    assert i[0, -1] == 2 and s[0, -1] == 0 and np.signbit(s[0, -1])
    s, i = _run_select(emulated, torch.from_numpy(q), torch.from_numpy(d),
                       k + 1)
    assert list(i[0, -2:]) == [2, 5]
    _, i_r = _plain(torch.from_numpy(q), torch.from_numpy(d), k + 1)
    np.testing.assert_array_equal(i, i_r)


def test_cuda_source_emulated_unaligned_pointer(emulated):
    rng = np.random.default_rng(7)
    flat = torch.from_numpy(_unit(rng, 1, 301 * 64 + 1)).view(-1)[1:]
    q, d = flat[:64].view(1, 64), flat[64:].view(300, 64)
    assert q.data_ptr() % 16 != 0
    s, i = _run_select(emulated, q, d, 280)
    s_r, i_r = _plain(q, d, 280)
    np.testing.assert_allclose(s, s_r, rtol=0, atol=TOL)
    assert _ids_agree(s_r, i, i_r)


def test_cuda_source_emulated_ties_across_splits_and_chunks(emulated):
    """Equal doc rows across scan tiles, splits and select chunks: ids
    lowest first, and the cut falls inside the tied group."""
    rng = np.random.default_rng(4)
    d = _unit(rng, 9000, 8)
    # scan splits of 1152 docs, select chunks of 4500 (the plan at 4 SMs)
    assert ops.retrieval_topk_select_plan(1, 9000, 5, 4)[2:] == \
        (8, 1152, 2, 4500)
    ties = [3, 127, 128, 1151, 1152, 4499, 4500, 6000, 8999]
    for j in ties[1:]:
        d[j] = d[3]
    q = 2.0 * d[3:4]
    for k in (5, len(ties) + 300):
        s, i = _run_select(emulated, torch.from_numpy(q),
                           torch.from_numpy(d), k)
        n = min(k, len(ties))
        assert list(i[0, :n]) == ties[:n]
        assert (s[0, :n] == s[0, 0]).all()


def test_cuda_source_emulated_bitwise_equal_list_and_narrow(emulated):
    """One fmaf chain per (query, doc) in all three kernels: the first
    6176 of k 6177 are bitwise csrc/topk_list.cu's k 6176, the first 32
    csrc/topk.cu's k 32; two calls are bitwise equal."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(_unit(rng, 2, 8))
    d = torch.from_numpy(_unit(rng, 6300, 8))
    s, i = _run_select(emulated, q, d, LIMIT + 1)
    s2, i2 = _run_select(emulated, q, d, LIMIT + 1)
    np.testing.assert_array_equal(s, s2)
    np.testing.assert_array_equal(i, i2)
    group, _, n_splits, per = ops.retrieval_topk_wide_plan(2, 6300, LIMIT, 4)
    out = [torch.empty(2, LIMIT), torch.empty(2, LIMIT, dtype=torch.int32)]
    fan_in = ops.topk_merge_fan_in(LIMIT)
    m = -(-n_splits // fan_in)
    scratch = [torch.empty(2, n_splits, LIMIT),
               torch.empty(2, n_splits, LIMIT, dtype=torch.int32),
               torch.empty(2, m, LIMIT), torch.empty(2, m, LIMIT,
                                                     dtype=torch.int32)]
    assert emulated["retrieval_topk_list"](
        *map(ops._ptr, (q, d, *scratch, *out)), 2, 6300, 8, LIMIT, group,
        per, n_splits, fan_in if n_splits > 1 else 0, None) == 0
    np.testing.assert_array_equal(s[:, :LIMIT], out[0].numpy())
    np.testing.assert_array_equal(i[:, :LIMIT], out[1].numpy())
    narrow = [torch.empty(2, 32), torch.empty(2, 32, dtype=torch.int32)]
    assert emulated["retrieval_topk"](
        ops._ptr(q), ops._ptr(d), None, None, *map(ops._ptr, narrow), 2,
        6300, 8, 32, 6400, 1, None) == 0
    np.testing.assert_array_equal(s[:, :32], narrow[0].numpy())
    np.testing.assert_array_equal(i[:, :32], narrow[1].numpy())
