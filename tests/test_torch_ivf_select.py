"""The IVF probe's route from k 16 (``csrc/ivf_select.cu`` on CUDA): its
plan, its route and its CUDA source, on the CPU.

- ``ops.ivf_retrieval_topk_select_plan``: every list row in exactly one
  scan split and every candidate column (probe * L + slot) in exactly one
  select chunk, query chunks whose scratch stays under
  ``ops.SELECT_BYTES``, and the scan's cut that of
  ``ops.ivf_retrieval_topk_plan`` for the chunk.
- ``ops.ivf_route``: the narrow kernel below k 16, this one from it.
- ``csrc/ivf_select.cu`` itself, compiled with g++ against
  ``tests/cuda_emu.h`` with sort runs of 256 entries (2048 on the card, so
  that rows of more than 256 candidates take the select rounds, gather,
  sort runs and merge levels, and rows of fewer the one-block sort of S)
  and without the cp.async L2 hint (inline PTX).  Held to the plain
  version ``ref.ivf_topk_ref`` and to the reference's Pallas kernel in
  interpret mode at k 33, k 300, k above the live candidates, a list
  probed twice, -1 slots inside a list, probe ids outside the lists, one
  doc in two lists (tied by probe rank), a -0.0 / +0.0 pair, Nq 1, D 30,
  forced query chunks and a forced plan of several splits and group
  blocks.  ``csrc/ivf_topk.cu``, built the same way, shares its scan core
  (``csrc/ivf_core.cuh``): the first 32 of k 64 are bitwise its k 32
  (in ``test_torch_ivf_select_emulated.py``, with the narrow kernel's
  own cases).

Tolerance: scores within 1e-5 absolute (the same f32 dot products summed
in another order); ids equal, except where the plain scores of two slots
lie within 2e-5 of each other (another order may swap a near-tie).  On
exact ties built from integers or equal rows, ids and scores are equal
exactly."""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.kernels.topk_retrieval import ivf_topk_pallas  # noqa: E402

from repro_torch.kernels import build, ops, ref  # noqa: E402
from test_torch_topk_wide_plan import _emulated_source  # noqa: E402

TOL = 1e-5
EMU_RUN = 256     # the emulated build's sort run (the card's: 2048)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _ids_agree(s_plain, i, i_plain, tol=TOL):
    same = i == i_plain
    k = s_plain.shape[1]
    gap = np.abs(s_plain[:, :, None] - s_plain[:, None, :])
    near = ((gap <= 2 * tol) & ~np.eye(k, dtype=bool)).any(-1)
    return bool((same | near).all())


def _lists(rng, sizes, L, D, holes=()):
    """Unit rows; list l live in its first sizes[l] slots (minus the
    (l, slot) ``holes``, which become -1), unique global ids."""
    emb = _unit(rng, len(sizes) * L, D).reshape(len(sizes), L, D)
    ids = np.full((len(sizes), L), -1, np.int32)
    nxt = 0
    for l, n in enumerate(sizes):
        ids[l, :n] = np.arange(nxt, nxt + n)
        nxt += n
    for l, slot in holes:
        ids[l, slot] = -1
    return emb, ids


def _covered_once(n, spans):
    cov = np.zeros(n, np.int64)
    for a, b in spans:
        cov[a:b] += 1
    return bool((cov == 1).all())


# ------------------------------------------------------------- the plan


@pytest.mark.parametrize("Nq,nprobe,n_lists,L,k,sms", [
    (32, 51, 256, 8000, 64, 132), (1, 51, 256, 8000, 6177, 132),
    (3, 2, 11, 34, 64, 132), (8, 2, 12, 16, 33, 132),
    (5, 3, 4, 1500, 300, 4), (1000, 51, 256, 8000, 64, 132),
    (70, 7, 30, 900, 5000, 8), (2, 1, 1, 1, 40, 1),
])
def test_plan_covers_every_row_and_column_once(Nq, nprobe, n_lists, L, k,
                                               sms):
    chunk_q, q_chunks, gb, n_splits, per, n_sel, sel_per = \
        ops.ivf_retrieval_topk_select_plan(Nq, nprobe, n_lists, L, k, sms)
    assert 1 <= chunk_q <= min(Nq, 65535)
    assert q_chunks == -(-Nq // chunk_q)
    assert (gb, n_splits, per) == ops.ivf_retrieval_topk_plan(
        chunk_q, nprobe, n_lists, L, sms)
    assert per % ops.IVF_TILE == 0
    assert _covered_once(L, [(s * per, min(L, (s + 1) * per))
                             for s in range(n_splits)])
    n_cand = nprobe * L
    assert sel_per % 4 == 0 and 1 <= n_sel <= ops.SELECT_MAX_CHUNKS
    assert _covered_once(n_cand, [(c * sel_per, min(n_cand, (c + 1) * sel_per))
                                  for c in range(n_sel)])
    assert (n_sel - 1) * sel_per < n_cand
    if n_sel > 1:
        assert sel_per >= ops.SELECT_MIN_CHUNK


@pytest.mark.parametrize("Nq,nprobe,L,k", [
    (32, 51, 8000, 64), (1000, 51, 8000, 64), (5000, 64, 4000, 20_000),
    (100, 300, 10_000, 7000), (1, 4000, 100_000, 6177), (40, 2, 10, 7000),
])
def test_plan_query_chunks_under_the_byte_limit(Nq, nprobe, L, k):
    """A chunk's scratch stays within ops.SELECT_BYTES (unless one query
    alone needs more), all queries form one chunk when they fit, and one
    more query would not have fitted."""
    plan = ops.ivf_retrieval_topk_select_plan(Nq, nprobe, 256, L, k, 132)
    chunk_q, n_sel = plan[0], plan[5]
    n_cand = nprobe * L
    nbytes = ops.topk_select_bytes(chunk_q, n_cand, k, n_sel)
    assert nbytes <= ops.SELECT_BYTES or chunk_q == 1
    if ops.topk_select_bytes(Nq, n_cand, k, ops.SELECT_MAX_CHUNKS) \
            <= ops.SELECT_BYTES:
        assert chunk_q == Nq
    if chunk_q < Nq:
        assert ops.topk_select_bytes(chunk_q + 1, n_cand, k,
                                     ops.SELECT_MAX_CHUNKS) > ops.SELECT_BYTES


def test_plan_1m_shard_is_one_chunk_and_fills_the_card():
    """The 1M-doc shard's cut (256 lists, nprobe 51): 32 queries in one
    chunk, S [32, 51 L] f32 in the scratch, and the select passes spread
    over at least four blocks an SM; one query cuts its row into the most
    select chunks."""
    chunk_q, q_chunks, _, _, _, n_sel, _ = \
        ops.ivf_retrieval_topk_select_plan(32, 51, 256, 8000, 64, 132)
    assert (chunk_q, q_chunks) == (32, 1)
    assert n_sel * chunk_q >= 4 * 132
    assert ops.topk_select_scratch(32, 51 * 8000, 64, n_sel)[0] == \
        32 * 51 * 8000
    assert ops.ivf_retrieval_topk_select_plan(1, 51, 256, 8000, 64,
                                              132)[5] == ops.SELECT_MAX_CHUNKS


# ------------------------------------------------------------ the route


@pytest.mark.parametrize("k,route", [
    (1, "ivf_retrieval_topk"), (3, "ivf_retrieval_topk"),
    (ops.IVF_SELECT_K - 1, "ivf_retrieval_topk"),
    (ops.IVF_SELECT_K, "ivf_retrieval_topk_select"),
    (32, "ivf_retrieval_topk_select"), (33, "ivf_retrieval_topk_select"),
    (6177, "ivf_retrieval_topk_select"),
    (10 ** 6, "ivf_retrieval_topk_select"),
])
def test_ivf_route(k, route):
    """The narrow kernel below ops.IVF_SELECT_K (16, the crossing the card
    measured: from it csrc/ivf_select.cu is as fast or faster at every
    timed shape, PERF.md), csrc/ivf_select.cu from it; the narrow kernel
    serves up to ops.TOPK_NARROW_MAX."""
    assert ops.IVF_SELECT_K == 16 <= ops.TOPK_NARROW_MAX
    assert ops.ivf_route(k) == route
    assert route in ops.launches


def test_route_is_registered():
    assert build.SOURCES["ivf_select"] == "ivf_select.cu"
    assert ("ivf_select", "ivf_retrieval_topk_select") in ops._SIGNATURES
    assert "ivf_retrieval_topk_select" in ops.launches


# --------------------------------------- the CUDA source, emulated on CPU


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/ivf_select.cu and csrc/ivf_topk.cu compiled with g++ against
    tests/cuda_emu.h (csrc/common.cuh replaced by it; the cp.async L2
    hint, inline PTX, off; sort runs of EMU_RUN).  ivf_select.cu also
    exports its layout constants (``layout``) and its work_ints."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the CUDA sources cannot be "
                    "emulated on the CPU")
    tmp = tmp_path_factory.mktemp("ivf_select_emu")
    (tmp / "common.cuh").write_text('#include "cuda_emu.h"\n')
    for header in ("ivf_core.cuh", "select_core.cuh"):
        (tmp / header).write_text(_emulated_source(
            (build.CSRC / header).read_text()))
    here = build.CSRC.parents[3] / "tests"
    libs, procs = {}, []
    for lib in ("ivf_select", "ivf_topk"):
        (tmp / f"{lib}.cpp").write_text(_emulated_source(
            (build.CSRC / build.SOURCES[lib]).read_text())
            + (_LAYOUT_SHIM if lib == "ivf_select" else ""))
        libs[lib] = tmp / f"lib{lib}.so"
        procs.append(subprocess.Popen(
            [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
             "-Wno-unknown-pragmas", "-DIVF_L2_256B=0",
             f"-DSELECT_RUN={EMU_RUN}", f"-I{tmp}", f"-I{here}", "-o",
             str(libs[lib]), str(tmp / f"{lib}.cpp")],
            stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    fns = {}
    for lib, entry in (("ivf_select", "ivf_retrieval_topk_select"),
                       ("ivf_topk", "ivf_retrieval_topk")):
        fn = getattr(ctypes.CDLL(str(libs[lib])), entry)
        fn.argtypes = ops._SIGNATURES[(lib, entry)]
        fn.restype = ctypes.c_int
        fns[entry] = fn
    shim = ctypes.CDLL(str(libs["ivf_select"]))
    fns["layout"] = shim.emu_ivf_select_layout
    fns["layout"].argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fns["layout"].restype = None
    fns["work_ints"] = shim.emu_work_ints
    fns["work_ints"].argtypes = [ctypes.c_int, ctypes.c_int]
    fns["work_ints"].restype = ctypes.c_longlong
    return fns


# Appended to csrc/ivf_select.cu's translation unit: the constants that
# ops' plan and scratch must agree with.
_LAYOUT_SHIM = """
extern "C" void emu_ivf_select_layout(long long* out) {
  out[0] = sel::kBins;
  out[1] = sel::kState;
  out[2] = kG;
  out[3] = kTD;
  out[4] = sel::kRun;
}
extern "C" long long emu_work_ints(int chunk_q, int n_sel) {
  return static_cast<long long>(sel::work_ints(chunk_q, n_sel));
}
"""


def test_cuda_source_layout_matches_ops(emulated):
    out = (ctypes.c_longlong * 5)()
    emulated["layout"](out)
    assert list(out) == [ops.SELECT_BINS, ops.SELECT_STATE, ops.IVF_GROUP,
                         ops.IVF_TILE, EMU_RUN]
    for chunk_q, n_sel in ((1, 1), (32, 17), (7, 3)):
        assert emulated["work_ints"](chunk_q, n_sel) == \
            ops.topk_select_scratch(chunk_q, 1000, 300, n_sel)[1]


def _run_select(fns, q, emb, ids, probe, k, chunk_q=None, plan=None, sms=4):
    """The emulated entry point with the wrapper's scratch (as
    ops._ivf_select_launch allocates it; the scratch starts as garbage,
    NaN scores, so a read of an unwritten slot shows), at the plan's cut,
    a forced query chunk or a forced (group blocks, splits, rows per
    split)."""
    q, emb, ids, probe = (torch.from_numpy(np.ascontiguousarray(a))
                          for a in (q, emb, ids, probe))
    Nq, D = q.shape
    n_lists, L = ids.shape
    nprobe = probe.shape[1]
    cq, _, gb, n_splits, per, n_sel, sel_per = \
        ops.ivf_retrieval_topk_select_plan(Nq, nprobe, n_lists, L, k, sms)
    cq = chunk_q or cq
    if plan is not None:
        gb, n_splits, per = plan
    n_s, n_w, n_c = ops.topk_select_scratch(cq, nprobe * L, k, n_sel)
    scratch = (torch.full((n_s,), float("nan")),
               torch.full((n_w,), -7, dtype=torch.int32),
               torch.full((n_c,), -7, dtype=torch.int64))
    out = [torch.empty(Nq, k), torch.empty(Nq, k, dtype=torch.int32)]
    rc = fns["ivf_retrieval_topk_select"](
        *map(ops._ptr, (q, emb, ids, probe, *scratch, *out)), Nq, n_lists, L,
        D, nprobe, k, cq, per, n_splits, gb, n_sel, sel_per, None)
    assert rc == 0
    return out[0].numpy(), out[1].numpy()


def _run_narrow(fns, q, emb, ids, probe, k, sms=4):
    q, emb, ids, probe = (torch.from_numpy(np.ascontiguousarray(a))
                          for a in (q, emb, ids, probe))
    Nq, D = q.shape
    n_lists, L = ids.shape
    nprobe = probe.shape[1]
    gb, n_splits, per = ops.ivf_retrieval_topk_plan(Nq, nprobe, n_lists, L,
                                                    sms)
    part = (torch.empty(Nq, nprobe, n_splits, k),
            torch.empty(Nq, nprobe, n_splits, k, dtype=torch.int32))
    out = [torch.empty(Nq, k), torch.empty(Nq, k, dtype=torch.int32)]
    rc = fns["ivf_retrieval_topk"](
        *map(ops._ptr, (q, emb, ids, probe, *part, *out)), Nq, n_lists, L, D,
        nprobe, k, per, n_splits, gb, None)
    assert rc == 0
    return out[0].numpy(), out[1].numpy()


def _plain(q, emb, ids, probe, k):
    """ref.ivf_topk_ref, a probe id outside the lists given an empty
    list's (the kernels' contract; the plain version would index it)."""
    n_lists, L = ids.shape
    bad = (probe < 0) | (probe >= n_lists)
    if bad.any():
        emb = np.concatenate([emb, np.zeros((1,) + emb.shape[1:], emb.dtype)])
        ids = np.concatenate([ids, np.full((1, L), -1, np.int32)])
        probe = np.where(bad, n_lists, probe).astype(np.int32)
    return (t.numpy() for t in ref.ivf_topk_ref(
        *map(torch.from_numpy, (q, emb, ids, probe)), k))


def _case(name):
    """(q, emb, ids, probe, k, forced query chunk, forced plan)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    D = 30 if "D 30" in name else 8
    emb, ids = _lists(rng, [400, 0, 380, 200, 90], 400, D,
                      holes=[(0, 7), (2, 100), (2, 379)])
    q = _unit(rng, 3, D)
    probe = np.array([[3, 0, 2, 4, 1], [0, 0, 2, 1, 3], [4, 3, 2, 1, 0]],
                     np.int32)
    k, chunk_q, plan = 300, None, None
    if name.startswith("k "):
        k = int(name.split()[1])
    if "outside" in name:
        probe[1, 3], probe[2, 0], probe[0, 1] = -1, 9, 5
    if "Nq 1" in name:
        q, probe = q[:1], probe[:1]
    if "small rows" in name:      # 2 probes of 100 slots: one-block sort
        emb, ids, probe = emb[:, :100], ids[:, :100], probe[:, :2]
        k = 150
    if "chunks" in name:
        chunk_q = 2
    if "forced plan" in name:
        plan = (2, 4, ops.IVF_TILE)     # 2 group blocks, 4 splits of a tile
    if "live" in name:
        k = 2000                         # 1850 live candidates in row 0
    return q, emb, ids, probe, k, chunk_q, plan


SOURCE_CASES = ["k 33", "k 300", "k 1000", "above the live candidates",
                "probe ids outside the lists", "Nq 1", "D 30 (4-byte copies)",
                "small rows", "query chunks of 2", "forced plan"]


@pytest.mark.parametrize("name", SOURCE_CASES)
def test_cuda_source_emulated_matches_plain(emulated, name):
    """Three queries over five lists (one empty, -1 slots inside two, list
    0 probed twice by query 1)."""
    q, emb, ids, probe, k, chunk_q, plan = _case(name)
    s, i = _run_select(emulated, q, emb, ids, probe, k, chunk_q, plan)
    s_r, i_r = _plain(q, emb, ids, probe, k)
    np.testing.assert_allclose(s, s_r, rtol=0, atol=TOL)
    assert _ids_agree(s_r, i, i_r)
    assert ((i == -1) == (s_r <= -1e29)).all()
    assert (s[i == -1] == np.float32(-1e30)).all()


@pytest.mark.parametrize("k", [33, 130, 700])
def test_cuda_source_emulated_matches_pallas(emulated, k):
    """The reference's Pallas kernel in interpret mode, on the same numpy
    inputs: a list probed twice, an empty list, -1 slots inside lists."""
    rng = np.random.default_rng(k)
    emb, ids = _lists(rng, [120, 0, 90, 128], 128, 16,
                      holes=[(0, 3), (3, 17), (3, 100)])
    q = _unit(rng, 4, 16)
    probe = np.array([[1, 0, 3], [0, 0, 2], [3, 2, 1], [2, 1, 0]], np.int32)
    s, i = _run_select(emulated, q, emb, ids, probe, k)
    s_p, i_p = ivf_topk_pallas(jnp.asarray(q), jnp.asarray(emb),
                               jnp.asarray(ids), jnp.asarray(probe), k,
                               interpret=True)
    s_p, i_p = np.asarray(s_p), np.asarray(i_p)
    np.testing.assert_allclose(s, s_p, rtol=0, atol=TOL)
    assert _ids_agree(s_p, i, i_p)


@pytest.mark.parametrize("k", [40, 400])
def test_cuda_source_emulated_a_doc_in_two_lists_ties_by_probe(emulated, k):
    """One doc's row in list 3 (slot 5) and list 0 (slot 2): the query that
    probes list 3 first gets list 3's copy first, the one that probes
    list 0 first list 0's; equal scores, both ids, in probe order."""
    rng = np.random.default_rng(5)
    emb, ids = _lists(rng, [300, 200, 250, 280], 300, 8)
    emb[3, 5] = emb[0, 2]
    q = np.stack([2.0 * emb[0, 2]] * 2)
    probe = np.array([[3, 1, 0], [0, 2, 3]], np.int32)
    s, i = _run_select(emulated, q, emb, ids, probe, k)
    assert list(i[0, :2]) == [ids[3, 5], ids[0, 2]]
    assert list(i[1, :2]) == [ids[0, 2], ids[3, 5]]
    assert (s[:, 0] == s[:, 1]).all()


def test_cuda_source_emulated_list_probed_twice_counts_twice(emulated):
    """Query 0 names list 2 twice: each of its docs comes out twice, the
    first probe's copy first."""
    rng = np.random.default_rng(8)
    emb, ids = _lists(rng, [50, 60, 70], 80, 8)
    q = _unit(rng, 1, 8)
    probe = np.array([[2, 0, 2]], np.int32)
    s, i = _run_select(emulated, q, emb, ids, probe, 250)
    live = 70 + 50 + 70
    assert (np.sort(i[0, :live]) == np.sort(np.concatenate(
        [ids[2, :70], ids[0, :50], ids[2, :70]]))).all()
    assert (i[0, live:] == -1).all()
    for d in ids[2, :70]:
        assert (i[0] == d).sum() == 2


@pytest.mark.parametrize("k", [35, 600])
def test_cuda_source_emulated_integer_ties_exact(emulated, k):
    """Integer-valued rows: exact scores with wide ties at the k-th across
    lists, splits and select chunks; ids and scores equal the plain
    version's exactly (ties by probe rank, then slot)."""
    rng = np.random.default_rng(k)
    emb = rng.integers(-2, 3, (6, 400, 6)).astype(np.float32)
    ids = np.arange(6 * 400, dtype=np.int32).reshape(6, 400)
    ids[1, 50:90] = -1
    q = rng.integers(-2, 3, (3, 6)).astype(np.float32)
    probe = np.array([[5, 1, 0, 2], [1, 1, 3, 4], [0, 2, 4, 5]], np.int32)
    s, i = _run_select(emulated, q, emb, ids, probe, k)
    s_r, i_r = _plain(q, emb, ids, probe, k)
    np.testing.assert_array_equal(s, s_r)
    np.testing.assert_array_equal(i, i_r)


@pytest.mark.parametrize("D,n_cand", [(32, "one-block sort"),
                                      (32, "select rounds")])
def test_cuda_source_emulated_negative_zero(emulated, D, n_cand):
    """fmaf(1e-30, -1e-20, 0) underflows to -0.0 (list 0, slot 4), and
    +1e-20 to +0.0 (list 1, slot 2): they tie at the k-th, and the earlier
    probe's -0.0 is taken although +0.0 > -0.0 as bits.  D 32, one ring
    chunk: zero-filled dims would add +0.0, so the -0.0 row's other dims
    are -0.0 (0 * -0.0 + -0.0 stays -0.0)."""
    L = 60 if n_cand == "one-block sort" else 200
    rng = np.random.default_rng(2)
    emb = np.zeros((2, L, D), np.float32)
    emb[:, :, 0] = rng.uniform(-1, 1, (2, L))
    emb[0, 4] = -0.0
    emb[0, 4, 0], emb[1, 2, 0] = -1e-20, 1e-20
    ids = np.arange(2 * L, dtype=np.int32).reshape(2, L)
    q = np.zeros((1, D), np.float32)
    q[0, 0] = 1e-30
    probe = np.array([[0, 1]], np.int32)
    k = int((emb[:, :, 0] > 1e-6).sum()) + 1
    s, i = _run_select(emulated, q, emb, ids, probe, k)
    assert i[0, -1] == ids[0, 4] and s[0, -1] == 0 and np.signbit(s[0, -1])
    s, i = _run_select(emulated, q, emb, ids, probe, k + 1)
    assert list(i[0, -2:]) == [ids[0, 4], ids[1, 2]]
    _, i_r = _plain(q, emb, ids, probe, k + 1)
    np.testing.assert_array_equal(i, i_r)


def test_cuda_source_emulated_unaligned_pointer(emulated):
    """Queries 4 bytes off 16: the scan's 4-byte copies."""
    rng = np.random.default_rng(7)
    emb, ids = _lists(rng, [90, 100], 100, 16)
    flat = torch.from_numpy(_unit(rng, 1, 2 * 16 + 1)).view(-1)[1:]
    q = flat.view(2, 16)
    assert q.data_ptr() % 16 != 0
    probe = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    out = [torch.empty(2, 64), torch.empty(2, 64, dtype=torch.int32)]
    cq, _, gb, n_splits, per, n_sel, sel_per = \
        ops.ivf_retrieval_topk_select_plan(2, 2, 2, 100, 64, 4)
    n_s, n_w, n_c = ops.topk_select_scratch(cq, 200, 64, n_sel)
    scratch = (torch.empty(n_s), torch.empty(n_w, dtype=torch.int32),
               torch.empty(n_c, dtype=torch.int64))
    t = [torch.from_numpy(emb), torch.from_numpy(ids)]
    assert emulated["ivf_retrieval_topk_select"](
        *map(ops._ptr, (q, *t, probe, *scratch, *out)), 2, 2, 100, 16, 2, 64,
        cq, per, n_splits, gb, n_sel, sel_per, None) == 0
    s_r, i_r = _plain(q.numpy(), emb, ids, probe.numpy(), 64)
    np.testing.assert_allclose(out[0].numpy(), s_r, rtol=0, atol=TOL)
    assert _ids_agree(s_r, out[1].numpy(), i_r)
