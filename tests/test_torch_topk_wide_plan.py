"""The exact top-k route for 32 < k <= ``ops.TOPK_LIST_MAX``
(``csrc/topk_list.cu`` on CUDA): its plan, its decomposition and its
CUDA source, on the CPU.

- ``ops.retrieval_topk_wide_plan``: every doc in exactly one split, the
  query group (8 or 4) shrinking with k so that the lists fit shared
  memory, the route (``ops.topk_route``) on the measured grid, the
  merge's fan-in.
- The design emulated with numpy at small buffers (so that they
  overflow and merge many times): per (group, split) block a running
  threshold, a candidate buffer and a sorted list of k merged by ranks;
  then the splits' lists merged by a tree of pairwise rank merges.  Held
  to the plain version ``ref.topk_ref`` and to the reference's Pallas
  kernel in interpret mode at k 33, 64, 256 and the limit, k above a
  split's docs and above Nd, Nq off a group, D 30, and duplicate rows
  across tile and split boundaries.
- ``csrc/topk_list.cu`` itself, compiled with g++ against
  ``tests/cuda_emu.h`` (a block's threads are fibres taking turns on one
  thread, a warp's shuffles and ballots go through a barrier of its 32
  threads), at every group size, with spread warps, a tree of merge levels, the 4-byte copy
  path, an unaligned pointer and ties; and k 64's first 32 bitwise equal
  to ``csrc/topk.cu``'s k 32, emulated the same way.

Tolerance: scores within 1e-5 absolute (the same f32 dot products summed
in another order); ids equal, except where the plain scores of two slots
lie within 2e-5 of each other (another order may swap a near-tie).  The
emulation of the design selects on the plain version's own scores, so
there ids are equal exactly; so are they on exact duplicates and on
integer-valued data."""
import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.kernels.topk_retrieval import topk_pallas  # noqa: E402

from repro_torch.kernels import build, ops, ref  # noqa: E402

TOL = 1e-5
TILE = ops.TOPK_TILE
LIMIT = ops.TOPK_LIST_MAX


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _splits(Nd, n_splits, per):
    return [(s * per, min(Nd, (s + 1) * per)) for s in range(n_splits)]


def _ids_agree(s_plain, i, i_plain, tol=TOL):
    same = i == i_plain
    k = s_plain.shape[1]
    gap = np.abs(s_plain[:, :, None] - s_plain[:, None, :])
    near = ((gap <= 2 * tol) & ~np.eye(k, dtype=bool)).any(-1)
    return bool((same | near).all())


# ------------------------------------------------------------- the plan


@pytest.mark.parametrize("Nq,Nd,k,sms", [
    (8, 240, 64, 132), (32, 1_000_000, 64, 132), (32, 1_000_000, 256, 132),
    (1, 1_000_000, 64, 132), (33, 4097, 33, 132), (8, 0, 40, 132),
    (1, 1, 100, 132), (8, 4 * TILE, 64, 132), (8, 4 * TILE + 1, 64, 132),
    (31, 12_345, 500, 8), (200, 77_777, 1000, 132), (5, 3 * TILE - 1, 64, 1),
    (3, 100_000, LIMIT, 132), (40, 50_000, 2048, 132),
])
def test_wide_plan_covers_every_doc_once(Nq, Nd, k, sms):
    group, groups, n_splits, per = ops.retrieval_topk_wide_plan(Nq, Nd, k,
                                                                sms)
    assert group in ops.TOPK_LIST_GROUPS
    assert groups == max(1, -(-Nq // group))
    assert per % TILE == 0 and n_splits >= 1
    if n_splits > 1:       # a split of a split corpus holds k docs or more
        assert per >= k and per >= 4 * TILE
    spans = _splits(Nd, n_splits, per)
    covered = np.zeros(Nd, dtype=np.int64)
    for a, b in spans:
        assert a < b or Nd == 0, f"empty split {a}:{b}"
        covered[a:b] += 1
    assert (covered == 1).all()
    assert spans[-1][1] == Nd


def test_wide_plan_group_shrinks_with_k_so_the_lists_fit():
    """At 32 queries the group halves as k grows, and a block always fits
    in shared memory: two to an SM while any group allows it, one at
    the limit."""
    last = 32
    for k in list(range(33, 300)) + [584, 585, 1000, 1232, 1233, 2528,
                                      2529, 4000, LIMIT]:
        group = ops.retrieval_topk_wide_plan(32, 10 ** 6, k, 132)[0]
        assert group <= last, k
        last = group
        smem = ops.topk_list_smem(group, k)
        assert smem <= ops.SMEM_BLOCK, k
        two = [g for g in ops.TOPK_LIST_GROUPS
               if ops.topk_list_smem(g, k) <= ops.SMEM_TWO_BLOCKS]
        if two:   # the largest group that lets two blocks share an SM
            assert group == max(two) and smem <= ops.SMEM_TWO_BLOCKS, k
        else:
            assert group == 4, k
    assert ops.retrieval_topk_wide_plan(32, 10 ** 6, 64, 132)[0] == 8
    assert ops.retrieval_topk_wide_plan(32, 10 ** 6, 1232, 132)[0] == 8
    assert ops.retrieval_topk_wide_plan(32, 10 ** 6, 1233, 132)[0] == 4
    assert ops.retrieval_topk_wide_plan(32, 10 ** 6, LIMIT, 132)[0] == 4


@pytest.mark.parametrize("Nq,group", [(1, 4), (4, 4), (5, 8), (8, 8),
                                      (9, 8), (16, 8), (17, 8), (32, 8),
                                      (33, 8), (1000, 8)])
def test_wide_plan_group_is_the_smallest_holding_the_queries(Nq, group):
    got, groups, _, _ = ops.retrieval_topk_wide_plan(Nq, 10_000, 64, 132)
    assert got == group
    assert (groups - 1) * group < Nq <= groups * group


def test_wide_plan_main_path_is_one_block_and_1m_docs_fill_the_card():
    assert ops.retrieval_topk_wide_plan(8, 240, 64, 132) == (8, 1, 1,
                                                             2 * TILE)
    for k in (64, 256):
        _, groups, n_splits, _ = ops.retrieval_topk_wide_plan(
            32, 1_000_000, k, 132)
        assert 132 < groups * n_splits <= 2 * 132 + groups
    _, groups, n_splits, _ = ops.retrieval_topk_wide_plan(1, 1_000_000, 64,
                                                          132)
    assert groups * n_splits >= 132


# (Nq, Nd, k) -> the route: the cells of chip_smoke.py's kernels_topk_grid
# (Nd 240, 8192 and 1M; Nq 1, 8 and 32; k 64 .. 6176) by the kernel the
# card found faster there, the boundaries of the rule between them, and
# k 32/33 and the limit
ROUTES = [
    ((1, 240, 32), "retrieval_topk"), ((32, 10 ** 6, 32), "retrieval_topk"),
    ((1, 240, 33), "retrieval_topk_list"),
    ((1, 240, 512), "retrieval_topk_list"),
    ((1, 240, 1023), "retrieval_topk_list"),
    ((1, 240, 1024), "retrieval_topk_select"),
    ((1, 240, 6176), "retrieval_topk_select"),
    ((8, 240, 64), "retrieval_topk_list"),
    ((8, 240, 6176), "retrieval_topk_list"),
    ((32, 240, 64), "retrieval_topk_list"),
    ((32, 240, 6176), "retrieval_topk_list"),
    ((2, 512, LIMIT), "retrieval_topk_list"),
    ((2, 513, 64), "retrieval_topk_select"),
    ((1, 513, 128), "retrieval_topk_list"),
    ((1, 8192, 64), "retrieval_topk_list"),
    ((1, 8192, 128), "retrieval_topk_list"),
    ((1, 8192, 129), "retrieval_topk_select"),
    ((8, 8192, 64), "retrieval_topk_select"),
    ((32, 8192, 64), "retrieval_topk_list"),
    ((9, 8192, 64), "retrieval_topk_list"),
    ((32, 8192, 65), "retrieval_topk_select"),
    ((32, 8193, 64), "retrieval_topk_select"),
    ((32, 8192, 128), "retrieval_topk_select"),
    ((1, 10 ** 6, 64), "retrieval_topk_list"),
    ((1, 10 ** 6, 256), "retrieval_topk_select"),
    ((8, 10 ** 6, 64), "retrieval_topk_select"),
    ((32, 10 ** 6, 1024), "retrieval_topk_select"),
    ((8, 240, LIMIT + 1), "retrieval_topk_select"),
    ((1, 10 ** 6, 10 ** 6), "retrieval_topk_select"),
]


@pytest.mark.parametrize("shape,route", ROUTES, ids=lambda x: str(x))
def test_route_boundaries(shape, route):
    """k 32 is the narrow kernel's.  Above it, up to the limit (the widest
    list whose block fits shared memory at the smallest group, 4), the
    list kernel takes a corpus of at most ops.TOPK_LIST_DOCS docs unless
    one query asks for ops.TOPK_LIST_SPREAD_K or more, over more docs one
    query up to ops.TOPK_LIST_ONE_K, and more than one group of 8 queries
    up to ops.TOPK_LIST_GROUPS_K over at most ops.TOPK_LIST_GROUPS_DOCS
    docs; csrc/topk_select.cu the rest."""
    assert ops.topk_route(*shape) == route
    assert route in ops.launches
    assert ops.topk_list_smem(4, LIMIT) <= ops.SMEM_BLOCK
    assert ops.topk_list_smem(4, LIMIT + 1) > ops.SMEM_BLOCK
    assert ops.SMEM_BLOCK == 227 * 1024
    assert 2 * (ops.SMEM_TWO_BLOCKS + 1024) <= 228 * 1024
    assert ops.topk_list_smem(8, 64) == 40_960


@pytest.mark.parametrize("k", [33, 64, 65, 128, 256, 257, 1024, 2048, 2049,
                               LIMIT])
def test_merge_fan_in(k):
    f = ops.topk_merge_fan_in(k)
    assert f >= 2 and f & (f - 1) == 0
    assert f * k <= ops.TOPK_MERGE_ENTRIES or f == 2
    assert 2 * f * k > ops.TOPK_MERGE_ENTRIES
    # the merge block's two shared-memory lists (f and f / 2 of them)
    assert 8 * (f + f // 2) * k <= ops.SMEM_BLOCK


# ------------------------------------------------- the design, emulated


def _keys(s, i):
    """uint64 keys whose ascending order is the (score desc, id asc)
    order, fill id -1 as the largest unsigned id."""
    b = np.asarray(s, np.float32).view(np.uint32).astype(np.uint64)
    asc = np.where(b >> 31 == 1, ~b & 0xFFFFFFFF, b | 0x80000000)
    return ((~asc & 0xFFFFFFFF) << 32) | (np.asarray(i, np.int64).astype(
        np.uint64) & 0xFFFFFFFF)


def _rank_merge(a_s, a_i, b_s, b_i, k):
    """The best k of sorted lists A and B by ranks: an entry of A lands at
    its index plus B's entries that rank before it, an entry of B at its
    index plus A's entries that do not rank after it (ties, among fills
    only, to A); positions past k drop out.  Checks that every position
    below k is written exactly once."""
    ka, kb = _keys(a_s, a_i), _keys(b_s, b_i)
    pa = np.arange(len(ka)) + np.searchsorted(kb, ka, side="left")
    pb = np.arange(len(kb)) + np.searchsorted(ka, kb, side="right")
    out_s = np.zeros(k, np.float32)
    out_i = np.zeros(k, np.int64)
    seen = np.zeros(k, np.int64)
    for p, s, i in ((pa, a_s, a_i), (pb, b_s, b_i)):
        keep = p < k
        out_s[p[keep]] = np.asarray(s)[keep]
        out_i[p[keep]] = np.asarray(i)[keep]
        np.add.at(seen, p[keep], 1)
    assert (seen == 1).all()
    return out_s, out_i


def _scan(row, spans, k, buffer, batch, start):
    """One query's blocks over ``spans`` of its scores ``row``: docs
    offered in order, ``batch`` at a time; a doc passes if it beats the
    threshold (the better of the key ``start`` and the list's k-th at the
    last merge).  When the passing docs would overflow the buffer, the
    buffer is sorted and rank-merged into the sorted list of k (fills
    (-inf, -1)) and the batch offered again; so at the end.  -> (the
    spans' lists, merges)."""
    lists, flushes = [], 0
    for a, b in spans:
        ls, li = np.full(k, -np.inf, np.float32), np.full(k, -1)
        bs, bi = [], []
        th = start

        def flush():
            nonlocal ls, li, bs, bi, th, flushes
            order = np.argsort(_keys(bs, bi), kind="stable")
            ls, li = _rank_merge(ls, li, np.asarray(bs, np.float32)[order],
                                 np.asarray(bi)[order], k)
            bs, bi = [], []
            th = min(th, _keys([ls[-1]], [li[-1]])[0])
            flushes += 1

        for c in range(a, b, batch):
            docs = np.arange(c, min(b, c + batch))
            ok = _keys(row[docs], docs) < th
            if len(bs) + ok.sum() > buffer:
                flush()
                ok = _keys(row[docs], docs) < th
            bs += list(row[docs[ok]])
            bi += list(docs[ok])
        if bs:
            flush()
        lists.append((ls, li))
    return lists, flushes


def _merge_tree(lists, k, fan_in):
    """The splits' lists merged ``fan_in`` at a time by a tree of pairwise
    rank merges, level after level, until one is left."""
    while len(lists) > 1:
        nxt = []
        for c in range(0, len(lists), fan_in):
            level = lists[c:c + fan_in]
            while len(level) > 1:
                level = [_rank_merge(*level[j], *level[j + 1], k)
                         if j + 1 < len(level) else level[j]
                         for j in range(0, len(level), 2)]
            nxt.append(level[0])
        lists = nxt
    return lists[0]


def _emulate(scores, k, plan, buffer, batch, fan_in):
    """The design on precomputed scores [Nq, Nd]: each split's block's
    list, then the merge of the splits' lists."""
    _, _, n_splits, per = plan
    Nq, Nd = scores.shape
    spans = _splits(Nd, n_splits, per)
    out_s = np.empty((Nq, k), np.float32)
    out_i = np.empty((Nq, k), np.int64)
    flushes = 0
    for q in range(Nq):
        start = np.uint64(2 ** 64 - 1)
        lists, n = _scan(scores[q], spans, k, buffer, batch, start)
        flushes += n
        ls, li = _merge_tree(lists, k, fan_in)
        out_s[q] = np.where(li < 0, ref.NEG_INF, ls)
        out_i[q] = li
    return out_s, out_i.astype(np.int32), flushes


def _check(q, d, k, plan, buffer=8, batch=4, fan_in=None):
    qt, dt = torch.from_numpy(q), torch.from_numpy(d)
    s_r, i_r = (t.numpy() for t in ref.topk_ref(qt, dt, k))
    scores = (qt @ dt.T).numpy()
    s, i, flushes = _emulate(scores, k, plan, buffer, batch,
                             fan_in or ops.topk_merge_fan_in(k))
    np.testing.assert_array_equal(s, s_r)
    np.testing.assert_array_equal(i, i_r)
    s_p, i_p = topk_pallas(jnp.asarray(q), jnp.asarray(d), k, q_block=16,
                           d_block=512, interpret=True)
    s_p, i_p = np.asarray(s_p), np.asarray(i_p)
    np.testing.assert_allclose(s, s_p, rtol=0, atol=TOL)
    assert _ids_agree(s_r, i, i_p)
    return s, i, flushes


# (Nq, Nd, D, k, forced docs per split or None for the plan's, fan-in or
# None for the rule's)
EDGES = {
    "k 33, 3 splits": (8, 700, 16, 33, 2 * TILE, None),
    "k 64, 4 splits, fan-in 2": (8, 1000, 16, 64, 2 * TILE, 2),
    "k 256, 3 splits": (5, 1200, 8, 256, 4 * TILE, None),
    "k limit, 2 splits": (2, LIMIT + 300, 4, LIMIT, LIMIT, None),
    "k > split's docs": (4, 600, 8, 200, TILE, 2),
    "k > Nd": (3, 40, 8, 100, None, None),
    "Nq off a group": (37, 500, 16, 40, None, None),
    "D 30": (5, 900, 30, 48, 2 * TILE, None),
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_design_matches_plain_and_pallas(name):
    Nq, Nd, D, k, per, fan_in = EDGES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q, d = _unit(rng, Nq, D), _unit(rng, Nd, D)
    plan = ops.retrieval_topk_wide_plan(Nq, Nd, k, 132)
    if per is not None:
        plan = plan[:2] + (-(-Nd // per), per)
    s, i, flushes = _check(q, d, k, plan, fan_in=fan_in)
    assert flushes > Nq * plan[2]     # buffers overflowed mid-split
    if k > Nd:
        assert (i[:, Nd:] == -1).all() and (s[:, Nd:] <= -1e29).all()


def test_design_on_integer_data_with_many_ties():
    """Integer-valued rows: every score exact in any order, many exact
    ties, which go to the lower id across batches, flushes and splits."""
    rng = np.random.default_rng(19)
    d = rng.integers(-2, 3, (900, 6)).astype(np.float32)
    q = rng.integers(-2, 3, (4, 6)).astype(np.float32)
    for k, per, fan_in in ((40, TILE, 2), (70, 2 * TILE, 4)):
        plan = (4, 1, -(-900 // per), per)
        _check(q, d, k, plan, fan_in=fan_in)


def test_design_duplicates_across_tile_and_split_boundaries():
    """Doc rows equal across a tile boundary (TILE-1, TILE) and a split
    boundary (2*TILE-1, 2*TILE, 3*TILE): each query's best row appears two
    or three times, and its ids come out lowest first."""
    rng = np.random.default_rng(19)
    D, Nd, per = 16, 4 * TILE, 2 * TILE
    d = _unit(rng, Nd, D)
    dups = [(TILE - 1, TILE), (2 * TILE - 1, 2 * TILE, 3 * TILE),
            (5, 2 * TILE + 5)]
    for g in dups:
        d[list(g[1:])] = d[g[0]]
    q = np.stack([2.0 * d[g[0]] for g in dups])
    s, i, _ = _check(q, d, 40, (4, 1, 2, per))
    for row, g in enumerate(dups):
        assert list(i[row, :len(g)]) == list(g)
        assert (s[row, :len(g)] == s[row, 0]).all()


# --------------------------------------- the CUDA source, emulated on CPU


def _emulated_source(src: str) -> str:
    """A kernel source rewritten for tests/cuda_emu.h: dynamic shared
    memory from emu_dyn_smem, and each kernel<<<grid, block, smem,
    stream>>>(args) an emu_launch_dyn(grid, block, smem, kernel, args)."""
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = emu_dyn_smem<\1>();", src)
    out, pos = [], 0
    while (a := src.find("<<<", pos)) >= 0:
        b = src.find(">>>(", a)
        name = re.search(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)\s*$", src[pos:a])
        parts, depth, cur = [], 0, ""
        for ch in src[a + 3:b]:
            depth += (ch in "(<") - (ch in ")>")
            if ch == "," and depth == 0:
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        grid, block, smem = (" ".join(p.split()) for p in parts[:3])
        out += [src[pos:pos + name.start(1)],
                f"emu_launch_dyn({grid}, {block}, {smem}, "
                f"{name.group(1)}, "]
        pos = b + 4
    return "".join(out) + src[pos:]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/topk_list.cu and csrc/topk.cu compiled with g++ against
    tests/cuda_emu.h (csrc/common.cuh replaced by it; the cp.async L2
    hint, inline PTX, off).  topk_list.cu also exports, for the tests,
    its layout constants (``layout``) and its scan block's shared memory
    (``scan_smem``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the CUDA sources cannot be "
                    "emulated on the CPU")
    tmp = tmp_path_factory.mktemp("topk_list_emu")
    (tmp / "common.cuh").write_text('#include "cuda_emu.h"\n')
    shutil.copy(build.CSRC / "topk_core.cuh", tmp / "topk_core.cuh")
    here = build.CSRC.parents[3] / "tests"
    libs, procs = {}, []
    for lib in ("topk_list", "topk"):
        (tmp / f"{lib}.cpp").write_text(_emulated_source(
            (build.CSRC / build.SOURCES[lib]).read_text())
            + (_LAYOUT_SHIM if lib == "topk_list" else ""))
        libs[lib] = tmp / f"lib{lib}.so"
        procs.append(subprocess.Popen(
            [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
             "-Wno-unknown-pragmas", "-DTOPK_L2_256B=0", f"-I{tmp}",
             f"-I{here}", "-o", str(libs[lib]), str(tmp / f"{lib}.cpp")],
            stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    fns = {}
    for lib, entry in (("topk_list", "retrieval_topk_list"),
                       ("topk", "retrieval_topk")):
        fn = getattr(ctypes.CDLL(str(libs[lib])), entry)
        fn.argtypes = ops._SIGNATURES[(lib, entry)]
        fn.restype = ctypes.c_int
        fns[entry] = fn
    shim = ctypes.CDLL(str(libs["topk_list"]))
    fns["layout"] = shim.emu_layout
    fns["layout"].argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    fns["layout"].restype = None
    fns["scan_smem"] = shim.emu_scan_smem
    fns["scan_smem"].argtypes = [ctypes.c_int, ctypes.c_int]
    fns["scan_smem"].restype = ctypes.c_longlong
    return fns


# Appended to csrc/topk_list.cu's translation unit: its constants and its
# scan_smem, which ops.retrieval_topk_wide_plan must agree with.
_LAYOUT_SHIM = """
extern "C" void emu_layout(long long* out) {
  out[0] = kTD;
  out[1] = kKC;
  out[2] = kStages;
  out[3] = kLB;
  out[4] = kSmemMax;
}
extern "C" long long emu_scan_smem(int group, int k) {
  return static_cast<long long>(scan_smem(group, k));
}
"""


def test_cuda_source_layout_matches_the_plan(emulated):
    """ops.topk_list_smem, the constants it is made of and the limit are
    csrc/topk_list.cu's own: a change to the kernel's layout that the plan
    does not follow fails here, not as an invalid-value return on the
    card."""
    out = (ctypes.c_longlong * 5)()
    emulated["layout"](out)
    assert list(out) == [TILE, ops.TOPK_CHUNK, ops.TOPK_STAGES,
                         ops.TOPK_BUFFER, ops.SMEM_BLOCK]
    for group in ops.TOPK_LIST_GROUPS:
        for k in (33, 64, 256, 261, 1000, 2529, LIMIT, LIMIT + 1):
            assert emulated["scan_smem"](group, k) == ops.topk_list_smem(
                group, k), (group, k)
    smem = emulated["scan_smem"]
    assert smem(4, LIMIT) <= ops.SMEM_BLOCK < smem(4, LIMIT + 1)


def _run_list(fns, q, d, k, plan, fan_in=None):
    """The emulated entry point with the wrapper's scratch (as
    ops._topk_list_launch allocates it)."""
    group, _, n_splits, per = plan
    Nq, D = q.shape
    fan_in = fan_in or ops.topk_merge_fan_in(k)
    m = -(-n_splits // fan_in)
    out = [torch.empty(Nq, k), torch.empty(Nq, k, dtype=torch.int32)]
    scratch = [torch.empty(Nq, n_splits, k),
               torch.empty(Nq, n_splits, k, dtype=torch.int32),
               torch.empty(Nq, m, k), torch.empty(Nq, m, k,
                                                  dtype=torch.int32)]
    rc = fns["retrieval_topk_list"](
        *map(ops._ptr, (q, d, *scratch, *out)), Nq, d.shape[0], D, k, group,
        per, n_splits, fan_in if n_splits > 1 else 0, None)
    assert rc == 0
    return out[0].numpy(), out[1].numpy()


def _run_narrow(fns, q, d, k):
    Nq, D = q.shape
    per = TILE * max(1, -(-d.shape[0] // TILE))
    out = [torch.empty(Nq, k), torch.empty(Nq, k, dtype=torch.int32)]
    rc = fns["retrieval_topk"](ops._ptr(q), ops._ptr(d), None, None,
                               *map(ops._ptr, out), Nq, d.shape[0], D, k,
                               per, 1, None)
    assert rc == 0
    return out[0].numpy(), out[1].numpy()


def _plain(q, d, k):
    return (t.numpy() for t in ref.topk_ref(q, d, k))


# (Nq, Nd, D, k, (group, docs per split) forced or None, fan-in or None)
SOURCE_CASES = {
    "main path, group 8": (8, 240, 32, 64, None, None),
    "group 8, Nq 33, 3 splits": (33, 900, 16, 50, (8, 3 * TILE), None),
    "group 8, k 256 > split": (12, 700, 8, 256, (8, 2 * TILE), 2),
    "group 4, 3 merge levels": (3, 2000, 8, 40, (4, TILE), 2),
    "spread, Nq 1": (1, 2000, 8, 70, None, None),
    "spread, Nq 2 of group 8": (2, 900, 8, 40, (8, 2 * TILE), None),
    "D 30 (4-byte copies)": (5, 700, 30, 100, None, None),
    "k > Nd": (10, 50, 8, 100, None, None),
    "k 1024": (2, 3000, 8, 1024, None, None),
    "k limit": (3, LIMIT + 900, 4, LIMIT, None, None),
    "Nd 1": (3, 1, 8, 40, None, None),
    "Nd 0": (2, 0, 8, 40, None, None),
}


@pytest.mark.parametrize("name", list(SOURCE_CASES))
def test_cuda_source_emulated_matches_plain(emulated, name):
    Nq, Nd, D, k, force, fan_in = SOURCE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q = torch.from_numpy(_unit(rng, Nq, D))
    d = torch.from_numpy(_unit(rng, max(Nd, 1), D)[:Nd])
    plan = ops.retrieval_topk_wide_plan(Nq, Nd, k, 4)
    if force is not None:
        group, per = force
        plan = (group, -(-Nq // group), -(-Nd // per), per)
    s, i = _run_list(emulated, q, d, k, plan, fan_in)
    s_r, i_r = _plain(q, d, k)
    np.testing.assert_allclose(s, s_r, rtol=0, atol=TOL)
    assert _ids_agree(s_r, i, i_r)
    assert (i[:, Nd:] == -1).all() and (s[:, Nd:] == np.float32(-1e30)).all()


def test_cuda_source_emulated_unaligned_pointer(emulated):
    rng = np.random.default_rng(7)
    flat = torch.from_numpy(_unit(rng, 1, 12 * 64 + 1)).view(-1)[1:]
    q, d = flat[:64].view(1, 64), flat[64:].view(11, 64)
    assert q.data_ptr() % 16 != 0
    s, i = _run_list(emulated, q, d, 40,
                     ops.retrieval_topk_wide_plan(1, 11, 40, 4))
    s_r, i_r = _plain(q, d, 40)
    np.testing.assert_allclose(s, s_r, rtol=0, atol=TOL)
    assert _ids_agree(s_r, i, i_r)


@pytest.mark.parametrize("group,Nq", [(4, 3), (4, 1), (8, 2)])
def test_cuda_source_emulated_ties_across_tiles_and_splits(emulated, group,
                                                           Nq):
    """Equal doc rows across a tile boundary and a split boundary, and far
    apart: ids lowest first, with one list per query and with spread
    warps' lists (Nq 1 at group 4; Nq 2 at group 8)."""
    rng = np.random.default_rng(group + Nq)
    d = _unit(rng, 2000, 16)
    dups = [(127, 128), (255, 256, 1000), (5, 1999)]
    for g in dups:
        d[list(g[1:])] = d[g[0]]
    q = np.stack([2.0 * d[g[0]] for g in dups])[:Nq]
    plan = (group, -(-Nq // group), 8, 2 * TILE)
    s, i = _run_list(emulated, torch.from_numpy(q), torch.from_numpy(d), 40,
                     plan, 2)
    for row, g in enumerate(dups[:Nq]):
        assert list(i[row, :len(g)]) == list(g)
        assert (s[row, :len(g)] == s[row, 0]).all()


def test_cuda_source_emulated_integer_data_ids_exact(emulated):
    rng = np.random.default_rng(3)
    d = torch.from_numpy(rng.integers(-2, 3, (1500, 8)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-2, 3, (6, 8)).astype(np.float32))
    for k, plan in ((33, (8, 1, 6, 2 * TILE)), (300, (4, 2, 3, 4 * TILE))):
        s, i = _run_list(emulated, q, d, k, plan, 2)
        s_r, i_r = _plain(q, d, k)
        np.testing.assert_array_equal(s, s_r)
        np.testing.assert_array_equal(i, i_r)


@pytest.mark.parametrize("Nq,Nd,D", [(8, 240, 32), (5, 900, 30)])
def test_cuda_source_emulated_k64_first_32_equal_narrow_k32(emulated, Nq,
                                                            Nd, D):
    """One fmaf chain per (query, doc) in both kernels: the first 32 of
    k 64 are bitwise csrc/topk.cu's k 32."""
    rng = np.random.default_rng(Nd)
    q, d = (torch.from_numpy(_unit(rng, n, D)) for n in (Nq, Nd))
    s64, i64 = _run_list(emulated, q, d, 64,
                         ops.retrieval_topk_wide_plan(Nq, Nd, 64, 4))
    s32, i32 = _run_narrow(emulated, q, d, 32)
    np.testing.assert_array_equal(s64[:, :32], s32)
    np.testing.assert_array_equal(i64[:, :32], i32)
