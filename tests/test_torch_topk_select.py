"""The exact top-k route above ``ops.TOPK_LIST_MAX`` (``csrc/topk_select.cu``
on CUDA): its plan, its design and its CUDA source, on the CPU.

- ``ops.retrieval_topk_select_plan``: every doc in exactly one scan split
  and one select chunk, query chunks whose scratch stays under
  ``ops.SELECT_BYTES``, the route boundaries at 6176/6177.
- The design emulated with numpy on the plain version's own scores:
  32-bit keys, a radix select of each query's k-th key in digits of 11,
  11 and 10 bits from per-chunk histograms, the gather's slots (keys
  above the k-th by chunk prefix and rank in the chunk, ties at the k-th
  by the same in doc order), and the sort as runs and pairwise rank
  merges at small run lengths.  Held to ``ref.topk_ref`` and to the
  reference's Pallas kernel in interpret mode at k 6177, k > Nd, Nd 0,
  integer data with many ties at the k-th, and a -0.0 / +0.0 pair.
- ``csrc/topk_select.cu`` itself, compiled with g++ against
  ``tests/cuda_emu.h`` with sort runs of 256 entries (2048 on the card),
  so that the merge levels run on small inputs too; its
  layout constants against ``ops``'; and (in
  ``test_torch_topk_select_emulated.py``, with the source's other long
  cases) the first 6176 of k 6177 bitwise equal to
  ``csrc/topk_list.cu``'s k 6176, the first 32 to ``csrc/topk.cu``'s k
  32 (one fmaf chain per pair in all three).

Tolerance: scores within 1e-5 absolute (the same f32 dot products summed
in another order); ids equal, except where the plain scores of two slots
lie within 2e-5 of each other (another order may swap a near-tie).  The
emulation of the design selects on the plain version's own scores, so
there ids and scores are equal exactly; so are they on integer-valued
data."""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.kernels.topk_retrieval import topk_pallas  # noqa: E402

from repro_torch.kernels import build, ops, ref  # noqa: E402
from test_torch_topk_wide_plan import _emulated_source  # noqa: E402

TOL = 1e-5
LIMIT = ops.TOPK_LIST_MAX
EMU_RUN = 256     # the emulated build's sort run (the card's: 2048)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _ids_agree(s_plain, i, i_plain, tol=TOL):
    same = i == i_plain
    k = s_plain.shape[1]
    gap = np.abs(s_plain[:, :, None] - s_plain[:, None, :])
    near = ((gap <= 2 * tol) & ~np.eye(k, dtype=bool)).any(-1)
    return bool((same | near).all())


def _spans(n, count, per):
    return [(j * per, min(n, (j + 1) * per)) for j in range(count)]


def _covered_once(n, spans):
    cov = np.zeros(n, np.int64)
    for a, b in spans:
        assert a < b or n == 0, f"empty span {a}:{b}"
        cov[a:b] += 1
    return bool((cov == 1).all()) and (n == 0 or spans[-1][1] == n)


# ------------------------------------------------------------- the plan


@pytest.mark.parametrize("Nq,Nd,k,sms", [
    (32, 1_000_000, 6177, 132), (8, 8192, 6177, 132), (1, 1_000_000, 6177,
                                                        132),
    (32, 1_000_000, 65536, 132), (33, 100, 7000, 132), (1000, 1_000_000,
                                                        6177, 132),
    (2, 0, 7000, 132), (5, 4097, 7000, 4), (70, 12_345, 6177, 8),
    (3, 3, 6177, 1),
])
def test_select_plan_covers_every_doc_once(Nq, Nd, k, sms):
    chunk_q, q_chunks, n_splits, per, n_sel, sel_per = \
        ops.retrieval_topk_select_plan(Nq, Nd, k, sms)
    assert 1 <= chunk_q <= min(Nq, 65535)
    assert q_chunks == -(-Nq // chunk_q)
    assert per % ops.TOPK_TILE == 0 and n_splits <= 65535
    assert _covered_once(Nd, _spans(Nd, n_splits, per))
    assert sel_per % 4 == 0 and 1 <= n_sel <= ops.SELECT_MAX_CHUNKS
    assert _covered_once(Nd, _spans(Nd, n_sel, sel_per))
    if n_sel > 1:
        assert sel_per >= ops.SELECT_MIN_CHUNK


@pytest.mark.parametrize("Nq,Nd,k", [
    (32, 1_000_000, 6177), (1000, 1_000_000, 6177), (5000, 200_000, 50_000),
    (100, 3_000_000, 7000), (4, 300_000_000, 6177), (40, 10, 7000),
])
def test_select_plan_query_chunks_under_the_byte_limit(Nq, Nd, k):
    """A chunk's scratch stays within ops.SELECT_BYTES (unless one query
    alone needs more), all queries form one chunk when they fit, and a
    cut chunk is whole scan groups when it holds one or more."""
    chunk_q = ops.retrieval_topk_select_plan(Nq, Nd, k, 132)[0]
    n_sel = ops.retrieval_topk_select_plan(Nq, Nd, k, 132)[4]
    nbytes = ops.topk_select_bytes(chunk_q, Nd, k, n_sel)
    assert nbytes <= ops.SELECT_BYTES or chunk_q == 1
    whole = ops.topk_select_bytes(Nq, Nd, k, ops.SELECT_MAX_CHUNKS)
    if whole <= ops.SELECT_BYTES:
        assert chunk_q == Nq
    elif chunk_q >= ops.TOPK_GROUP:
        assert chunk_q % ops.TOPK_GROUP == 0
    # one more group would not have fitted
    more = chunk_q + (ops.TOPK_GROUP if chunk_q >= ops.TOPK_GROUP else 1)
    if chunk_q < Nq:
        assert ops.topk_select_bytes(more, Nd, k, ops.SELECT_MAX_CHUNKS) \
            > ops.SELECT_BYTES


def test_select_plan_1m_docs_is_one_chunk_and_fills_the_card():
    chunk_q, q_chunks, n_splits, _, n_sel, _ = \
        ops.retrieval_topk_select_plan(32, 1_000_000, 6177, 132)
    assert (chunk_q, q_chunks) == (32, 1)
    assert n_splits >= 132                     # one group, the scan's grid
    assert n_sel * chunk_q >= 4 * 132          # the select passes' grid
    # S [32, 1M] f32 is 128 MB of the byte limit
    assert ops.topk_select_scratch(32, 1_000_000, 6177, n_sel)[0] == \
        32 * 1_000_000
    _, _, n_splits, _, n_sel, _ = ops.retrieval_topk_select_plan(
        1, 1_000_000, 6177, 132)
    assert n_splits >= 132 and n_sel == ops.SELECT_MAX_CHUNKS


@pytest.mark.parametrize("shape,route", [
    ((8, 240, LIMIT), "retrieval_topk_list"),
    ((8, 240, LIMIT + 1), "retrieval_topk_select"),
    ((1, 240, LIMIT), "retrieval_topk_select"),
    ((8, 8192, LIMIT), "retrieval_topk_select"),
    ((32, 1_000_000, LIMIT), "retrieval_topk_select"),
    ((32, 1_000_000, 16384), "retrieval_topk_select"),
    ((1, 1_000_000, 65536), "retrieval_topk_select"),
    ((3, 100, 10 ** 7), "retrieval_topk_select"),
], ids=lambda x: str(x))
def test_route_boundaries_6176_6177(shape, route):
    """Above the limit every shape is the select kernel's; at it, the list
    kernel keeps only a small corpus with more than one query (the
    measured grid, PERF.md)."""
    assert LIMIT == 6176
    assert ops.topk_route(*shape) == route
    assert "retrieval_topk_select" in ops.launches
    assert "retrieval_topk_wide" not in ops.launches
    assert "ivf_retrieval_topk_wide" not in ops.launches
    assert ("topk_select", "retrieval_topk_select") in ops._SIGNATURES
    assert build.SOURCES["topk_select"] == "topk_select.cu"


# --------------------------------------------------- the design, emulated

DIGITS = ((21, 11), (10, 11), (0, 10))   # (shift, bits), top digit first


def _key(s):
    """uint32 keys whose unsigned order is the score order; -0.0 keys as
    +0.0 (the two compare equal)."""
    s = np.where(s == 0, np.float32(0), np.asarray(s, np.float32))
    b = s.astype(np.float32).view(np.uint32)
    return np.where(b >> 31 == 1, ~b, b | np.uint32(0x80000000)).astype(
        np.uint32)


def _order(s, i):
    """uint64 keys whose ascending order is (score desc, id asc)."""
    return ((~_key(s)).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(i, np.int64).astype(np.uint64)


def _select(keys, k_eff, chunks):
    """The radix select of one query: (tau, rem, above per chunk, ties per
    chunk), from per-chunk histograms of the digit among the keys that
    carry the prefix found so far."""
    prefix, rem = 0, k_eff
    above = np.zeros(len(chunks), np.int64)
    for r, (shift, bits) in enumerate(DIGITS):
        nb = 1 << bits
        hist = []
        for a, b in chunks:
            kc = keys[a:b]
            if r:
                kc = kc[(kc >> np.uint32(shift + bits)) == prefix]
            hist.append(np.bincount((kc >> np.uint32(shift)) & (nb - 1),
                                    minlength=nb))
        hist = np.array(hist).reshape(len(chunks), nb)
        desc = hist.sum(0)[::-1]               # the highest bin first
        j = int(np.searchsorted(np.cumsum(desc), rem))
        digit = nb - 1 - j
        rem -= int(desc[:j].sum())
        above += hist[:, digit + 1:].sum(1)
        prefix = (prefix << bits) | digit
    ties = np.array([(keys[a:b] == prefix).sum() for a, b in chunks])
    return np.uint32(prefix), rem, above, ties


def _rank_merge(a, b):
    """Sorted order keys A and B into one list by ranks (ties to A);
    checks that the positions are a bijection."""
    pa = np.arange(len(a)) + np.searchsorted(b, a, side="left")
    pb = np.arange(len(b)) + np.searchsorted(a, b, side="right")
    out = np.zeros(len(a) + len(b), np.uint64)
    seen = np.zeros(len(out), np.int64)
    for p, x in ((pa, a), (pb, b)):
        out[p] = x
        np.add.at(seen, p, 1)
    assert (seen == 1).all()
    return out


def _emulate(S, k, n_sel, run):
    """The design on a score matrix S [Nq, Nd]: select chunks of a
    multiple of 4 docs, the select, the gather's slots (each written
    exactly once), runs of ``run`` sorted and merged pairwise by ranks.
    -> (scores [Nq, k], ids [Nq, k])."""
    Nq, Nd = S.shape
    k_eff = min(k, Nd)
    per = max(4, -(-(-(-Nd // n_sel)) // 4) * 4)
    chunks = _spans(Nd, max(1, -(-Nd // per)), per)
    out_s = np.full((Nq, k), -1e30, np.float32)
    out_i = np.full((Nq, k), -1, np.int64)
    for q in range(Nq if k_eff else 0):
        keys = _key(S[q])
        tau, rem, above, ties = _select(keys, k_eff, chunks)
        c = k_eff - rem
        assert above.sum() == c and 1 <= rem <= ties.sum()
        off_a = np.cumsum(above) - above
        off_t = np.cumsum(ties) - ties
        slot = np.full(k_eff, -1, np.int64)
        hits = np.zeros(k_eff, np.int64)
        for ch, (a, b) in enumerate(chunks):
            doc = np.arange(a, b)
            up, eq = doc[keys[a:b] > tau], doc[keys[a:b] == tau]
            pos = np.concatenate([off_a[ch] + np.arange(len(up)),
                                  c + off_t[ch] + np.arange(len(eq))])
            ids = np.concatenate([up, eq])
            keep = pos < np.concatenate([np.full(len(up), c),
                                         np.full(len(eq), k_eff)])
            slot[pos[keep]] = ids[keep]
            np.add.at(hits, pos[keep], 1)
        assert (hits == 1).all()
        order = _order(S[q, slot], slot)
        runs = [np.sort(order[j:j + run]) for j in range(0, k_eff, run)]
        while len(runs) > 1:
            runs = [_rank_merge(*runs[j:j + 2]) if j + 1 < len(runs)
                    else runs[j] for j in range(0, len(runs), 2)]
        ids = (runs[0] & np.uint64(0xFFFFFFFF)).astype(np.int64)
        out_s[q, :k_eff] = S[q, ids]
        out_i[q, :k_eff] = ids
    return out_s, out_i


def _plain_on(S, k):
    """ref.topk_ref's selection on a given score matrix (a stable
    descending sort: ties, -0.0 and +0.0 among them, by index)."""
    s, i = ref.topk_ref(torch.eye(S.shape[0]), torch.from_numpy(S.T), k)
    return s.numpy(), i.numpy()


DESIGN_CASES = {
    # (Nq, Nd, D, k, select chunks, run)
    "k 6177": (3, 6500, 4, 6177, 3, 512),
    "k 6177, one chunk, one run": (2, 6300, 8, 6177, 1, 8192),
    "k > Nd": (2, 50, 8, 100, 4, 16),
    "k = Nd, 6 runs": (3, 333, 6, 333, 5, 64),
    "Nd 0": (2, 0, 4, 7000, 1, 256),
}


@pytest.mark.parametrize("name", list(DESIGN_CASES))
def test_design_matches_plain_and_pallas(name):
    Nq, Nd, D, k, n_sel, run = DESIGN_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q = _unit(rng, Nq, D)
    d = _unit(rng, max(Nd, 1), D)[:Nd]
    s_r, i_r = (t.numpy() for t in ref.topk_ref(torch.from_numpy(q),
                                                torch.from_numpy(d), k))
    S = (torch.from_numpy(q) @ torch.from_numpy(d).T).numpy()
    s, i = _emulate(S, k, n_sel, run)
    np.testing.assert_array_equal(s, s_r)
    np.testing.assert_array_equal(i, i_r)
    if Nd:
        s_p, i_p = topk_pallas(jnp.asarray(q), jnp.asarray(d), k,
                               interpret=True)
        np.testing.assert_allclose(s, np.asarray(s_p), rtol=0, atol=TOL)
        assert _ids_agree(s_r, i, np.asarray(i_p))
    assert (i[:, Nd:] == -1).all() and (s[:, Nd:] == np.float32(-1e30)).all()


@pytest.mark.parametrize("k", [700, 1500, 2500])
def test_design_integer_ties_at_the_kth(k):
    """Integer-valued data: every score is exact, thousands of docs tie
    at the k-th score, across select chunks, and the ties go lowest id
    first."""
    rng = np.random.default_rng(k)
    d = rng.integers(-2, 3, (3000, 6)).astype(np.float32)
    q = rng.integers(-2, 3, (4, 6)).astype(np.float32)
    S = q @ d.T
    s, i = _emulate(S, k, 7, 128)
    s_r, i_r = (t.numpy() for t in ref.topk_ref(torch.from_numpy(q),
                                                torch.from_numpy(d), k))
    np.testing.assert_array_equal(s, s_r)
    np.testing.assert_array_equal(i, i_r)
    s_p, i_p = topk_pallas(jnp.asarray(q), jnp.asarray(d), k,
                           interpret=True)
    np.testing.assert_array_equal(s, np.asarray(s_p))
    np.testing.assert_array_equal(i, np.asarray(i_p))
    kth = S[np.arange(4), i[:, -1]]
    assert ((S == kth[:, None]).sum(1) > 100).all()   # wide ties at tau


def test_design_negative_zero_ties_by_id():
    """A -0.0 score at doc 2 and a +0.0 at doc 5, and the k-th at zero:
    the two compare equal, so doc 2 wins although +0.0 > -0.0 as bits."""
    rng = np.random.default_rng(5)
    S = rng.uniform(-1, 1, (2, 400)).astype(np.float32)
    S[:, 2], S[:, 5], S[:, 9] = -0.0, 0.0, 0.0
    k = int((S[0] > 0).sum()) + 1
    S[1] = S[0]
    s, i = _emulate(S, k, 3, 32)
    s_r, i_r = _plain_on(S, k)
    np.testing.assert_array_equal(i, i_r)
    assert i[0, -1] == 2 and np.signbit(s[0, -1])
    s2, i2 = _emulate(S, k + 1, 3, 32)
    assert list(i2[0, -2:]) == [2, 5]


# --------------------------------------- the CUDA source, emulated on CPU


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/topk_select.cu (with sort runs of ``EMU_RUN`` entries),
    csrc/topk_list.cu and
    csrc/topk.cu compiled with g++ against tests/cuda_emu.h.
    topk_select.cu also exports its layout constants (``layout``) and
    work_ints, which ops.topk_select_scratch must agree with."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the CUDA sources cannot be "
                    "emulated on the CPU")
    tmp = tmp_path_factory.mktemp("topk_select_emu")
    (tmp / "common.cuh").write_text('#include "cuda_emu.h"\n')
    for header in ("topk_core.cuh", "select_core.cuh"):
        (tmp / header).write_text(_emulated_source(
            (build.CSRC / header).read_text()))
    here = build.CSRC.parents[3] / "tests"
    libs, procs = {}, []
    for lib in ("topk_select", "topk_list", "topk"):
        (tmp / f"{lib}.cpp").write_text(_emulated_source(
            (build.CSRC / build.SOURCES[lib]).read_text())
            + (_LAYOUT_SHIM if lib == "topk_select" else ""))
        libs[lib] = tmp / f"lib{lib}.so"
        procs.append(subprocess.Popen(
            [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
             "-Wno-unknown-pragmas", "-DTOPK_L2_256B=0",
             f"-DSELECT_RUN={EMU_RUN}", f"-I{tmp}", f"-I{here}", "-o",
             str(libs[lib]), str(tmp / f"{lib}.cpp")],
            stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    fns = {}
    for lib, entry in (("topk_select", "retrieval_topk_select"),
                       ("topk_list", "retrieval_topk_list"),
                       ("topk", "retrieval_topk")):
        fn = getattr(ctypes.CDLL(str(libs[lib])), entry)
        fn.argtypes = ops._SIGNATURES[(lib, entry)]
        fn.restype = ctypes.c_int
        fns[entry] = fn
    shim = ctypes.CDLL(str(libs["topk_select"]))
    fns["layout"] = shim.emu_select_layout
    fns["layout"].argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fns["layout"].restype = None
    fns["work_ints"] = shim.emu_work_ints
    fns["work_ints"].argtypes = [ctypes.c_int, ctypes.c_int]
    fns["work_ints"].restype = ctypes.c_longlong
    return fns


# Appended to csrc/topk_select.cu's translation unit: its constants and
# its work_ints, which ops.topk_select_scratch must agree with.
_LAYOUT_SHIM = """
extern "C" void emu_select_layout(long long* out) {
  out[0] = sel::kBins;
  out[1] = sel::kState;
  out[2] = kG;
  out[3] = sel::kRun;
}
extern "C" long long emu_work_ints(int chunk_q, int n_sel) {
  return static_cast<long long>(sel::work_ints(chunk_q, n_sel));
}
"""


def test_cuda_source_layout_matches_ops(emulated):
    out = (ctypes.c_longlong * 4)()
    emulated["layout"](out)
    assert list(out) == [ops.SELECT_BINS, ops.SELECT_STATE, ops.TOPK_GROUP,
                         EMU_RUN]
    for chunk_q, n_sel in ((1, 1), (32, 17), (224, 3), (5, 32)):
        assert emulated["work_ints"](chunk_q, n_sel) == \
            ops.topk_select_scratch(chunk_q, 1000, 7000, n_sel)[1]


def _run_select(fns, q, d, k, chunk_q=None, sms=4):
    """The emulated entry point with the wrapper's scratch (as
    ops._topk_select_launch allocates it; the scratch starts as garbage,
    so a read of an unwritten slot shows), at the plan's cut or a forced
    query chunk."""
    Nq, D = q.shape
    Nd = d.shape[0]
    plan_q, _, n_splits, per, n_sel, sel_per = \
        ops.retrieval_topk_select_plan(Nq, Nd, k, sms)
    chunk_q = chunk_q or plan_q
    n_s, n_w, n_c = ops.topk_select_scratch(chunk_q, Nd, k, n_sel)
    scratch = (torch.full((n_s,), float("nan")),
               torch.full((n_w,), -7, dtype=torch.int32),
               torch.full((n_c,), -7, dtype=torch.int64))
    out = [torch.empty(Nq, k), torch.empty(Nq, k, dtype=torch.int32)]
    rc = fns["retrieval_topk_select"](
        *map(ops._ptr, (q, d, *scratch, *out)), Nq, Nd, D, k, chunk_q, per,
        n_splits, n_sel, sel_per, None)
    assert rc == 0
    return out[0].numpy(), out[1].numpy()


def _plain(q, d, k):
    return (t.numpy() for t in ref.topk_ref(q, d, k))


# (Nq, Nd, D, k, forced query chunk or None)
SOURCE_CASES = {
    "k 6177 (25 runs, 5 merge levels)": (2, 6400, 4, LIMIT + 1, None),
    "one run": (3, 900, 16, 200, None),
    "k > Nd": (3, 50, 8, 100, None),
    "k > Nd, several runs": (2, 700, 8, 1000, None),
    "Nd 0": (2, 0, 8, 40, None),
    "Nd 1": (3, 1, 8, 300, None),
    "D 30 (4-byte copies)": (5, 700, 30, 300, None),
    "Nq 33 (two groups)": (33, 300, 16, 257, None),
    "spread group, Nq 1": (1, 2000, 8, 1500, None),
    "query chunks of 2": (5, 600, 8, 450, 2),
}


@pytest.mark.parametrize("name", list(SOURCE_CASES))
def test_cuda_source_emulated_matches_plain(emulated, name):
    Nq, Nd, D, k, chunk_q = SOURCE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q = torch.from_numpy(_unit(rng, Nq, D))
    d = torch.from_numpy(_unit(rng, max(Nd, 1), D)[:Nd])
    s, i = _run_select(emulated, q, d, k, chunk_q)
    s_r, i_r = _plain(q, d, k)
    np.testing.assert_allclose(s, s_r, rtol=0, atol=TOL)
    assert _ids_agree(s_r, i, i_r)
    assert (i[:, Nd:] == -1).all() and (s[:, Nd:] == np.float32(-1e30)).all()
