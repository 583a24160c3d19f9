"""Top-k for any k >= 1: the k > 32 routes of both retrieval wrappers, on
the CPU.  On CUDA the IVF probe's is ``csrc/topk_wide.cu``; the exact
function's are ``csrc/topk_list.cu`` up to ``ops.TOPK_LIST_MAX`` and
``csrc/topk_select.cu`` above, whose own tests are in
``tests/test_torch_topk_wide_plan.py`` and
``tests/test_torch_topk_select.py``.

- The CPU wrappers at k 33, 64 and above the candidates against the
  reference's Pallas kernels in interpret mode (``topk_pallas``,
  ``ivf_topk_pallas``), with exact ties, IVF padding and a list probed
  twice.
- The route choice (``ops.wide_route``, ``ops.topk_route``) and the
  limit k >= 1.
- The kernel's algorithm (tiles of candidates keyed by doc id or by
  probe rank * L + slot, each sorted best first and merged with the
  carried list by ranks) emulated in torch at small tiles.
- ``csrc/topk_wide.cu`` itself (the IVF probe), compiled with g++
  against ``tests/cuda_emu.h`` (threads and a barrier for a block), which
  runs its ranks, merges and barriers as written.

Tolerance: scores within 1e-5 absolute (the same f32 dot products summed
in another order); ids equal, except where the plain scores of two slots
lie within 2e-5 of each other (another order may swap a near-tie).
Where both sides sum in the same order (the emulations against the
plain version on exact integer data) ids are equal exactly."""
import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.topk_retrieval import ivf_topk_pallas, topk_pallas  # noqa: E402

from repro_torch.kernels import build, ops, ref  # noqa: E402

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


def test_route_choice():
    assert ops.TOPK_NARROW_MAX == 32
    assert [ops.wide_route(k) for k in (1, 5, 31, 32)] == [False] * 4
    assert [ops.wide_route(k) for k in (33, 64, 257, 10 ** 6)] == [True] * 4
    # the exact function has a third route: csrc/topk_list.cu between the
    # narrow kernel and csrc/topk_select.cu
    limit = ops.TOPK_LIST_MAX
    assert [ops.topk_route(k) for k in (1, 5, 31, 32)] == \
        ["retrieval_topk"] * 4
    assert [ops.topk_route(k) for k in (33, 64, 257, limit)] == \
        ["retrieval_topk_list"] * 4
    assert [ops.topk_route(k) for k in (limit + 1, 10 ** 6)] == \
        ["retrieval_topk_select"] * 2


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
            "retrieval_topk_select", "ivf_retrieval_topk_wide"} <= \
        set(ops.launches)
    ops.launches["retrieval_topk_select"] = 3
    ops.launches["retrieval_topk_list"] = 4
    ops.launches["ivf_retrieval_topk"] = 2
    ops.reset_launches()
    assert set(ops.launches.values()) == {0}
    assert ("topk_list", "retrieval_topk_list") in ops._SIGNATURES
    assert ("topk_select", "retrieval_topk_select") in ops._SIGNATURES
    assert ("topk_wide", "ivf_retrieval_topk_wide") in ops._SIGNATURES
    assert build.SOURCES["topk_list"] == "topk_list.cu"
    assert build.SOURCES["topk_wide"] == "topk_wide.cu"


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


# ------------------------------------------------ the kernel's algorithm


def _better(s1, i1, s2, i2):
    if s1 != s2:
        return s1 > s2
    return (i1 & 0xFFFFFFFF) < (i2 & 0xFFFFFFFF)


def _rank(xs, s, i, or_equal):
    lo, hi = 0, len(xs)
    while lo < hi:
        mid = (lo + hi) // 2
        before = (not _better(s, i, *xs[mid])) if or_equal \
            else _better(*xs[mid], s, i)
        lo, hi = (mid + 1, hi) if before else (lo, mid)
    return lo


def _emulate(scores, k, tile):
    """The kernel's per-query walk over candidate scores (one row, -inf
    where a candidate does not exist): tiles sorted best first, merged
    with the carried list by ranks when the tile's best beats the
    carried k-th; -> the final (score, key) list."""
    carried = [(-np.inf, -2 ** 31 + j) for j in range(k)]
    for base in range(0, len(scores), tile):
        t = [(float(scores[c]) if c < len(scores) else -np.inf, c)
             for c in range(base, base + tile)]
        t.sort(key=lambda e: (-e[0], e[1] & 0xFFFFFFFF))
        if not _better(*t[0], *carried[-1]):
            continue
        m = min(tile, k)
        out = [None] * k
        for j, (s, i) in enumerate(carried):
            pos = j + _rank(t[:m], s, i, False)
            if pos < k:
                out[pos] = (s, i)
        for j, (s, i) in enumerate(t[:m]):
            pos = j + _rank(carried, s, i, True)
            if pos < k:
                out[pos] = (s, i)
        assert None not in out
        carried = out
    return carried


@pytest.mark.parametrize("tile", [4, 8, 64])
@pytest.mark.parametrize("k", [1, 5, 33, 70])
def test_merge_emulation_matches_plain_exact(tile, k):
    """Integer-valued rows (exact in any order) with many exact ties."""
    rng = np.random.default_rng(tile * 100 + k)
    d = rng.integers(-2, 3, (50, 6)).astype(np.float32)
    q = rng.integers(-2, 3, (3, 6)).astype(np.float32)
    s_r, i_r = ref.topk_ref(torch.from_numpy(q), torch.from_numpy(d), k)
    for row in range(3):
        got = _emulate(q[row] @ d.T, k, tile)
        ids = [i if s != -np.inf else -1 for s, i in got]
        assert ids == i_r[row].tolist()
        assert [s if s != -np.inf else -1e30 for s, _ in got] == \
            pytest.approx(s_r[row].tolist())


@pytest.mark.parametrize("tile", [4, 16])
def test_merge_emulation_matches_plain_ivf(tile):
    """Keys probe rank * L + slot: ties by probe, then slot; padding,
    a list probed twice and a probe outside the lists score -inf."""
    rng = np.random.default_rng(tile)
    L = 7
    emb = rng.integers(-2, 3, (3, L, 4)).astype(np.float32)
    ids = np.arange(3 * L, dtype=np.int32).reshape(3, L)
    ids[0, [2, 6]] = -1
    ids[2, 4:] = -1
    q = rng.integers(-2, 3, (1, 4)).astype(np.float32)
    probe = np.array([[2, 0, 0, 5]], np.int32)      # 5 is outside
    cand = []
    for p in probe[0]:
        for slot in range(L):
            ok = 0 <= p < 3 and ids[p, slot] >= 0
            cand.append(float(emb[p, slot] @ q[0]) if ok else -np.inf)
    plain_probe = torch.from_numpy(np.where(probe < 3, probe, 3))
    emb_e = torch.from_numpy(np.concatenate([emb, np.zeros((1, L, 4),
                                                           np.float32)]))
    ids_e = torch.from_numpy(np.concatenate([ids, np.full((1, L), -1,
                                                          np.int32)]))
    for k in (3, 20, 40):
        got = _emulate(np.array(cand), k, tile)
        want_s, want_i = ref.ivf_topk_ref(torch.from_numpy(q), emb_e, ids_e,
                                          plain_probe, k)
        out = [-1 if s == -np.inf else int(ids[probe[0, c // L], c % L])
               for s, c in got]
        assert out == want_i[0].tolist()


# --------------------------------------- the CUDA source, emulated on CPU


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/topk_wide.cu (the IVF probe) compiled with g++ against
    tests/cuda_emu.h."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the CUDA source cannot be "
                    "emulated on the CPU")
    src = (build.CSRC / "topk_wide.cu").read_text()
    src = src.replace('#include "common.cuh"', '#include "cuda_emu.h"')
    src, n = re.subn(r"(topk_wide_kernel)<<<([^,]+),\s*([^,]+),.*?>>>\(",
                     r"emu_launch(\2, \3, \1, ", src)
    assert n == 1
    tmp = tmp_path_factory.mktemp("topk_wide_emu")
    (tmp / "emu.cpp").write_text(src)
    lib = tmp / "libemu.so"
    here = build.CSRC.parents[3] / "tests"
    subprocess.run([gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
                    f"-I{here}", "-o", str(lib), str(tmp / "emu.cpp")],
                   check=True, capture_output=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    so.ivf_retrieval_topk_wide.argtypes = ops._SIGNATURES[
        ("topk_wide", "ivf_retrieval_topk_wide")]
    so.ivf_retrieval_topk_wide.restype = ctypes.c_int
    return so


def _run_ivf(so, q, emb, ids, probe, k):
    t = [torch.from_numpy(a) for a in (q, emb, ids, probe)]
    out_s, out_i, buf_s, buf_i = ops._wide_buffers(q.shape[0], k, "cpu")
    rc = so.ivf_retrieval_topk_wide(
        *map(ops._ptr, (*t, buf_s, buf_i, out_s, out_i)), q.shape[0],
        emb.shape[0], emb.shape[1], q.shape[1], probe.shape[1], k, None)
    assert rc == 0
    return out_s.numpy(), out_i.numpy()


@pytest.mark.parametrize("k", [33, 300, 2100])
def test_cuda_source_emulated_matches_plain_ivf(emulated, k):
    rng = np.random.default_rng(k)
    emb, ids = _lists(rng, [400, 0, 380, 200, 90], 400, 8,
                      holes=[(0, 7), (2, 100), (2, 379)])
    emb[3, 5] = emb[0, 2]
    q = _unit(rng, 3, 8)
    q[0] = 2.0 * emb[0, 2]
    probe = np.array([[3, 0, 2, 4, 1], [0, 0, 2, 1, 3], [4, 3, 2, 1, 0]],
                     np.int32)
    s, i = _run_ivf(emulated, q, emb, ids, probe, k)
    s_r, i_r = (t.numpy() for t in ref.ivf_topk_ref(
        *map(torch.from_numpy, (q, emb, ids, probe)), k))
    np.testing.assert_allclose(s, s_r, rtol=0, atol=TOL)
    assert _ids_agree(s_r, i, i_r)
    assert list(i[0, :2]) == [ids[3, 5], ids[0, 2]]
    # probe ids outside the lists probe an empty list (list 1 here)
    out = probe.copy()
    out[1, 3], out[2, 0] = -1, 9
    s2, i2 = _run_ivf(emulated, q, emb, ids, out, k)
    s_r, i_r = (t.numpy() for t in ref.ivf_topk_ref(
        *map(torch.from_numpy, (q, emb, ids, np.where(
            (out < 0) | (out >= 5), 1, out).astype(np.int32))), k))
    np.testing.assert_allclose(s2, s_r, rtol=0, atol=TOL)
    assert _ids_agree(s_r, i2, i_r)
