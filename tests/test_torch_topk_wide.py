"""Top-k for any k >= 1: the k > 32 routes of both retrieval wrappers, on
the CPU.  On CUDA the IVF probe's is ``csrc/ivf_select.cu``, whose own
tests are in ``tests/test_torch_ivf_select.py``; the exact function's are
``csrc/topk_list.cu`` and ``csrc/topk_select.cu`` by ``ops.topk_route``,
whose own tests are in ``tests/test_torch_topk_wide_plan.py`` and
``tests/test_torch_topk_select.py``.

- The CPU wrappers at k 33, 64 and above the candidates against the
  reference's Pallas kernels in interpret mode (``topk_pallas``,
  ``ivf_topk_pallas``), with exact ties, IVF padding and a list probed
  twice.
- The route choice (``ops.ivf_route``, ``ops.topk_route``) and the
  limit k >= 1.

Tolerance: scores within 1e-5 absolute (the same f32 dot products summed
in another order); ids equal, except where the plain scores of two slots
lie within 2e-5 of each other (another order may swap a near-tie)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.kernels.topk_retrieval import ivf_topk_pallas, topk_pallas  # noqa: E402

from repro_torch.kernels import build, ops  # noqa: E402

TOL = 1e-5


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _ids_agree(s_plain, i, i_plain, tol=TOL):
    same = i == i_plain
    k = s_plain.shape[1]
    gap = np.abs(s_plain[:, :, None] - s_plain[:, None, :])
    near = ((gap <= 2 * tol) & ~np.eye(k, dtype=bool)).any(-1)
    return bool((same | near).all())


def _lists(rng, sizes, L, D, holes=()):
    """Unit rows; list l live in its first sizes[l] slots (minus the
    (l, slot) ``holes``, which become -1), unique global ids."""
    emb = rng.standard_normal((len(sizes), L, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    ids = np.full((len(sizes), L), -1, np.int32)
    nxt = 0
    for l, n in enumerate(sizes):
        ids[l, :n] = np.arange(nxt, nxt + n)
        nxt += n
    for l, slot in holes:
        ids[l, slot] = -1
    return emb, ids


# ------------------------------------------------------- route and limit


# (function, its arguments, the route): the IVF probe by k, the exact
# top-k by (Nq, Nd, k), each side of the measured crossings (PERF.md)
ROUTES = [
    ("ivf_route", (15,), "ivf_retrieval_topk"),
    ("ivf_route", (16,), "ivf_retrieval_topk_select"),
    ("ivf_route", (33,), "ivf_retrieval_topk_select"),
    ("ivf_route", (10 ** 6,), "ivf_retrieval_topk_select"),
    ("topk_route", (8, 240, 32), "retrieval_topk"),
    ("topk_route", (8, 240, 33), "retrieval_topk_list"),
    ("topk_route", (8, 240, 6176), "retrieval_topk_list"),
    ("topk_route", (8, 240, 6177), "retrieval_topk_select"),
    ("topk_route", (32, 10 ** 6, 64), "retrieval_topk_select"),
    ("topk_route", (1, 10 ** 6, 64), "retrieval_topk_list"),
]


@pytest.mark.parametrize("fn,shape,route", ROUTES, ids=lambda x: str(x))
def test_route_choice(fn, shape, route):
    assert ops.TOPK_NARROW_MAX == 32
    assert getattr(ops, fn)(*shape) == route
    assert route in ops.launches


@pytest.mark.parametrize("k", [0, -1])
@pytest.mark.parametrize("fn", ["retrieval_topk", "ivf_retrieval_topk"])
def test_k_below_one_raises(fn, k):
    q, d = torch.ones(2, 4), torch.ones(3, 4)
    emb, ids = torch.ones(2, 3, 4), torch.zeros(2, 3, dtype=torch.int32)
    probe = torch.zeros(2, 1, dtype=torch.int32)
    args = (q, d) if "ivf" not in fn else (q, emb, ids, probe)
    with pytest.raises(ValueError, match="at least 1"):
        getattr(ops, fn)(*args, k)


def test_launch_counts_name_each_route():
    assert {"retrieval_topk", "ivf_retrieval_topk", "retrieval_topk_list",
            "retrieval_topk_select", "ivf_retrieval_topk_select"} == \
        set(ops.launches) - {"paged_decode_attention", "flash_attention",
                             "flash_attention_bwd"}
    ops.launches["retrieval_topk_select"] = 3
    ops.launches["retrieval_topk_list"] = 4
    ops.launches["ivf_retrieval_topk_select"] = 2
    ops.reset_launches()
    assert set(ops.launches.values()) == {0}
    assert ("topk_list", "retrieval_topk_list") in ops._SIGNATURES
    assert ("topk_select", "retrieval_topk_select") in ops._SIGNATURES
    assert ("ivf_select", "ivf_retrieval_topk_select") in ops._SIGNATURES
    assert build.SOURCES["topk_list"] == "topk_list.cu"
    assert build.SOURCES["ivf_select"] == "ivf_select.cu"
    assert "topk_wide" not in build.SOURCES


# ------------------------------------------- CPU wrappers against Pallas


@pytest.mark.parametrize("Nq,Nd,D,k", [
    (5, 300, 32, 33), (5, 300, 32, 64), (3, 40, 16, 49), (2, 1100, 8, 257),
], ids=["k33", "k64", "k>Nd", "k257"])
def test_exact_cpu_wrapper_matches_pallas(Nq, Nd, D, k):
    rng = np.random.default_rng(Nd + k)
    q, d = _unit(rng, Nq, D), _unit(rng, Nd, D)
    d[Nd // 2] = d[Nd - 1] = d[1]             # exact ties go to the lower id
    q[0] = 2.0 * d[1]
    s, i = (t.numpy() for t in ops.retrieval_topk(torch.from_numpy(q),
                                                  torch.from_numpy(d), k))
    s_p, i_p = topk_pallas(jnp.asarray(q), jnp.asarray(d), k,
                           interpret=True)
    s_p, i_p = np.asarray(s_p), np.asarray(i_p)
    assert s.shape == i.shape == (Nq, k)
    np.testing.assert_allclose(s, s_p, rtol=0, atol=TOL)
    assert _ids_agree(s, i, i_p)
    assert list(i[0, :3]) == [1, Nd // 2, Nd - 1]
    if k > Nd:
        assert (i[:, Nd:] == -1).all() and (s[:, Nd:] <= -1e29).all()


@pytest.mark.parametrize("k", [33, 64, 200], ids=["k33", "k64", "k>cand"])
def test_ivf_cpu_wrapper_matches_pallas(k):
    rng = np.random.default_rng(k)
    emb, ids = _lists(rng, [30, 22, 0, 40], 40, 16,
                      holes=[(0, 3), (3, 17), (3, 39)])
    emb[1, 5] = emb[0, 2]                     # a tie across lists
    q = _unit(rng, 4, 16)
    q[0] = 2.0 * emb[0, 2]
    probe = np.array([[1, 0, 3], [0, 0, 2], [3, 2, 1], [2, 1, 0]], np.int32)
    s, i = (t.numpy() for t in ops.ivf_retrieval_topk(
        *map(torch.from_numpy, (q, emb, ids, probe)), k))
    s_p, i_p = ivf_topk_pallas(jnp.asarray(q), jnp.asarray(emb),
                               jnp.asarray(ids), jnp.asarray(probe), k,
                               interpret=True)
    s_p, i_p = np.asarray(s_p), np.asarray(i_p)
    np.testing.assert_allclose(s, s_p, rtol=0, atol=TOL)
    assert _ids_agree(s, i, i_p)
    # probe order decides the tie: list 1's copy, then list 0's
    assert list(i[0, :2]) == [ids[1, 5], ids[0, 2]]
    live = [(ids[p] >= 0).sum() for p in probe[1]]
    n1 = int(sum(live))                       # list 0 twice, list 2 empty
    assert (i[1, n1:] == -1).all() and (i[1, :n1] >= 0).all()
    assert (i[0, :min(k, 88)] >= 0).all()     # row 0's lists hold 88
