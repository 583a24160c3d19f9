"""The IVF probe kernel's cut of its work (``ops.ivf_retrieval_topk_plan``)
and its decomposition, on the CPU.

The CUDA kernel runs one block per (list, split, group block): the block
finds the (query, probe) pairs that name its list in probe-table order,
takes them in groups of ``IVF_GROUP``, scores its split's live span (first
to last live slot) once per group, and writes one sorted partial top-k
per (query, probe, split).  A merge then takes each query's partials keyed
(score, probe * splits + split).  Here that decomposition is emulated with
numpy and torch at the plan's edges (a list probed twice by one query,
more pairs for a list than a group holds, -1 slots inside a list, equal
rows across lists and a split boundary, an empty list, k 32 over fewer
live rows, L not a multiple of the tile, D 30) and held to the plain
version ``ref.ivf_topk_ref`` and to the reference's Pallas kernel in
interpret mode.

Tolerance: scores within 1e-5 absolute (the same f32 dot products
summed in another order); ids equal, except where the plain scores of
two slots lie within 2e-5 of each other (another order may swap a
near-tie), and always equal on exact duplicates."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.topk_retrieval import ivf_topk_pallas  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402

TOL = 1e-5
NEG = -1e30
G, TILE = ops.IVF_GROUP, ops.IVF_TILE


def _blocks(probe, list_ids, plan):
    """The kernel's units of work: (list, split, group, pairs, lo, hi) for
    each group a block scores, with the pairs as flat probe-table
    indices in table order and [lo, hi) the split's live span."""
    group_blocks, n_splits, per = plan
    n_lists, L = list_ids.shape
    flat = probe.reshape(-1)
    for l in range(n_lists):
        pairs = np.nonzero(flat == l)[0]
        groups = [pairs[g:g + G] for g in range(0, len(pairs), G)]
        for s in range(n_splits):
            a, b = s * per, min(L, (s + 1) * per)
            live = np.nonzero(list_ids[l, a:b] >= 0)[0]
            lo, hi = (a + live[0], a + live[-1] + 1) if len(live) else (a, a)
            for z in range(group_blocks):
                for g in range(z, len(groups), group_blocks):
                    yield l, s, g, groups[g], lo, hi


def _emulate(q, emb, ids, probe, k, plan):
    """Per (list, split, group) block: each pair's top-k of the split's
    live rows under (score desc, slot asc), filled with (-1e30, -1); then
    per query the best k of its probes' partials keyed (score, probe *
    splits + split, position in the partial)."""
    Nq, nprobe = probe.shape
    n_lists = ids.shape[0]
    n_splits = plan[1]
    part = {}
    for l, s, _, pairs, lo, hi in _blocks(probe, ids, plan):
        rows = torch.from_numpy(emb[l, lo:hi])
        live = ids[l, lo:hi] >= 0
        for e in pairs:
            sc = (rows * torch.from_numpy(q[e // nprobe])).sum(-1).numpy()
            slots = np.arange(lo, hi)[live]
            sc = sc[live]
            order = np.argsort(-sc, kind="stable")[:k]
            entries = [(float(sc[o]), int(slots[o])) for o in order]
            part[e, s] = entries + [(NEG, -1)] * (k - len(entries))
    out_s = np.full((Nq, k), NEG, np.float32)
    out_i = np.full((Nq, k), -1, np.int32)
    for qi in range(Nq):
        cand = []
        for p in range(nprobe):
            l = probe[qi, p]
            if not 0 <= l < n_lists:
                continue   # an empty list: no partials
            for s in range(n_splits):
                for pos, (sc, slot) in enumerate(part[qi * nprobe + p, s]):
                    cand.append((-sc, p * n_splits + s, pos, sc, l, slot))
        cand.sort(key=lambda c: c[:3])
        for j, (_, _, _, sc, l, slot) in enumerate(cand[:k]):
            if slot >= 0:
                out_s[qi, j], out_i[qi, j] = sc, ids[l, slot]
    return out_s, out_i


def _ids_agree(s_plain, i, i_plain, tol=TOL):
    same = i == i_plain
    k = s_plain.shape[1]
    gap = np.abs(s_plain[:, :, None] - s_plain[:, None, :])
    near = ((gap <= 2 * tol) & ~np.eye(k, dtype=bool)).any(-1)
    return bool((same | near).all())


def _plain(q, emb, ids, probe, k):
    s, i = ref.ivf_topk_ref(*map(torch.from_numpy, (q, emb, ids, probe)), k)
    return s.numpy(), i.numpy()


def _check(q, emb, ids, probe, k, plan, pallas=True):
    s, i = _emulate(q, emb, ids, probe, k, plan)
    s_r, i_r = _plain(q, emb, ids, probe, k)
    np.testing.assert_allclose(s, s_r, rtol=0, atol=TOL)
    assert _ids_agree(s_r, i, i_r)
    if pallas:
        s_p, i_p = ivf_topk_pallas(*map(jnp.asarray, (q, emb, ids, probe)),
                                   k, interpret=True)
        np.testing.assert_allclose(s, np.asarray(s_p), rtol=0, atol=TOL)
        assert _ids_agree(s_r, i, np.asarray(i_p))
    return s, i


def _lists(rng, sizes, L, D):
    """Unit rows, list l live in its first sizes[l] slots (zero rows
    after), unique ids."""
    emb = rng.standard_normal((len(sizes), L, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    ids = np.full((len(sizes), L), -1, np.int32)
    nxt = 0
    for l, n in enumerate(sizes):
        ids[l, :n] = np.arange(nxt, nxt + n)
        emb[l, n:] = 0.0
        nxt += n
    return emb, ids


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# ------------------------------------------------------------- the plan


@pytest.mark.parametrize("Nq,nprobe,n_lists,L,sms", [
    (3, 2, 11, 34, 132), (8, 2, 12, 16, 132), (32, 51, 256, 8832, 132),
    (1, 51, 256, 8832, 132), (100, 2, 4, 300, 132), (70, 1, 1, 4097, 8),
    (5, 3, 3, 4 * TILE, 132), (5, 3, 3, 4 * TILE + 1, 132),
    (2000, 64, 16, 1000, 132), (1, 20000, 20000, 3, 132),
])
def test_plan_cuts_lists_into_whole_tiles(Nq, nprobe, n_lists, L, sms):
    group_blocks, n_splits, per = ops.ivf_retrieval_topk_plan(
        Nq, nprobe, n_lists, L, sms)
    assert 1 <= group_blocks <= 65535 and 1 <= n_splits <= 65535
    assert per % TILE == 0 and per >= TILE
    assert (n_splits - 1) * per < L <= n_splits * per
    assert nprobe * n_splits <= max(nprobe, ops.IVF_MAX_PARTIALS)
    # enough group blocks for an even spread of the pairs over the lists
    assert group_blocks * n_lists * G >= min(Nq * nprobe, 65535 * n_lists * G)


@pytest.mark.parametrize("seed,Nq,nprobe,n_lists,L,plan", [
    (0, 5, 3, 6, 300, None), (1, 70, 2, 3, 200, None),
    (2, 70, 2, 3, 200, (1, 2, TILE)), (3, 40, 4, 2, 600, (3, 5, TILE)),
    (4, 9, 5, 4, 90, None),
])
def test_blocks_cover_every_live_pair_slot_once(seed, Nq, nprobe, n_lists,
                                                L, plan):
    """Every (query, probe, live slot of the probed list) is scored by
    exactly one block, and nothing else is: not a padding slot, not a
    probe outside the lists, not a slot of another list."""
    rng = np.random.default_rng(seed)
    ids = np.where(rng.random((n_lists, L)) < 0.6,
                   np.arange(n_lists * L).reshape(n_lists, L), -1
                   ).astype(np.int32)
    ids[0, L // 2:] = -1                      # padding at a list's end
    probe = rng.integers(-1, n_lists + 1, (Nq, nprobe)).astype(np.int32)
    probe[0, :2] = 0                          # one list twice
    plan = plan or ops.ivf_retrieval_topk_plan(Nq, nprobe, n_lists, L, 132)
    seen = np.zeros((Nq * nprobe, L), np.int64)
    for l, _, _, pairs, lo, hi in _blocks(probe, ids, plan):
        assert len(pairs) <= G
        for e in pairs:
            assert probe.reshape(-1)[e] == l
            live = np.arange(lo, hi)[ids[l, lo:hi] >= 0]
            seen[e, live] += 1
    for e, l in enumerate(probe.reshape(-1)):
        want = (ids[l] >= 0).astype(np.int64) if 0 <= l < n_lists else 0
        assert (seen[e] == want).all(), f"pair {e} (list {l})"


def test_plan_main_path_is_one_block_per_list():
    # the cluster path's IVF call: 3 queries, 11 lists of 34 slots, nprobe 2
    assert ops.ivf_retrieval_topk_plan(3, 2, 11, 34, 132) == (1, 1, TILE)
    assert ops.ivf_retrieval_topk_plan(8, 2, 12, 16, 132) == (1, 1, TILE)


def test_plan_1m_docs_fill_the_card():
    """256 lists of a 1M-doc shard (L_max 8832, list sizes skewed), Nq
    32 at nprobe 51: at least one block with work per SM."""
    rng = np.random.default_rng(0)
    sizes = rng.gamma(2.0, 1.0, 256)
    sizes = np.minimum(8832, np.round(sizes / sizes.sum() * 1_000_000))
    probe = np.stack([rng.choice(256, 51, replace=False) for _ in range(32)])
    group_blocks, n_splits, per = ops.ivf_retrieval_topk_plan(
        32, 51, 256, 8832, 132)
    pairs = np.bincount(probe.reshape(-1), minlength=256)
    groups = -(-pairs // G)
    with_work = sum(min(group_blocks, groups[l])
                    for l in range(256) for s in range(n_splits)
                    if sizes[l] > s * per)
    assert with_work >= 132


# ------------------------------------------------- the decomposition


# (Nq, sizes, L, D, nprobe or a probe table, k, forced plan or None)
EDGES = {
    "a list probed twice": (3, [7, 5, 6], 8, 16, [[0, 0, 1], [2, 1, 2],
                                                  [1, 2, 1]], 8, None),
    "more pairs than a group": (70, [150, 100, 40], 150, 16,
                                [[0, 1 if r < 12 else 2] for r in range(70)],
                                5, None),
    "more pairs than a group, one block loops": (
        70, [150, 100, 40], 150, 16,
        [[0, 1 if r < 12 else 2] for r in range(70)], 5, (1, 2, TILE)),
    "an empty list": (3, [2, 1, 3, 0], 3, 16, [[0, 1], [2, 3], [1, 3]], 6,
                      None),
    "k 32 over fewer live rows": (2, [5, 3, 0], 8, 16, [[0, 1], [1, 2]], 32,
                                  None),
    "L not a multiple of the tile": (4, [TILE + 37, 90, TILE + 1], TILE + 37,
                                     16, 2, 7, (1, 2, TILE)),
    "D 30": (5, [40, 33, 12, 40], 40, 30, 3, 6, None),
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_decomposition_matches_plain_and_pallas(name):
    Nq, sizes, L, D, nprobe, k, plan = EDGES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    emb, ids = _lists(rng, sizes, L, D)
    q = _unit(rng, Nq, D)
    if isinstance(nprobe, int):
        probe = np.stack([rng.permutation(len(sizes))[:nprobe]
                          for _ in range(Nq)])
    else:
        probe = np.asarray(nprobe)
    probe = probe.astype(np.int32)
    plan = plan or ops.ivf_retrieval_topk_plan(Nq, probe.shape[1],
                                               len(sizes), L, 132)
    s, i = _check(q, emb, ids, probe, k, plan)
    live = sum(sizes[l] for l in probe[0])
    if k > live:
        assert (i[0, live:] == -1).all() and (s[0, live:] <= -1e29).all()


def test_a_list_probed_twice_counts_twice():
    rng = np.random.default_rng(3)
    emb, ids = _lists(rng, [7, 5], 8, 16)
    q = 2.0 * emb[0, 3:4]
    probe = np.array([[0, 1, 0]], np.int32)
    s, i = _check(q, emb, ids, probe, 4, (1, 1, TILE))
    assert list(i[0, :2]) == [3, 3] and s[0, 0] == s[0, 1]


def test_minus_one_slots_inside_lists_never_win():
    """-1 slots inside the live span, their rows pointing at the query,
    and a -1 slot at a list's end with a non-zero row (past the span)."""
    rng = np.random.default_rng(4)
    emb, ids = _lists(rng, [40, 40], 40, 16)
    q = _unit(rng, 2, 16)
    ids[0, [3, 17, 39]] = -1
    ids[1, [0, 20]] = -1
    emb[0, [3, 17, 39]] = 3.0 * q[0]
    emb[1, [0, 20]] = 3.0 * q[1]
    probe = np.array([[0, 1], [1, 0]], np.int32)
    s, _ = _check(q, emb, ids, probe, 10, (1, 1, TILE))
    assert (s <= 1.0 + 1e-5).all()


def test_duplicates_across_lists_and_splits_rank_by_probe_then_slot():
    """One row at list 0 slots TILE-1, TILE and 2*TILE (across split
    boundaries at TILE rows a split) and at list 1 slot 5: probing [1, 0]
    ranks list 1's copy first, then list 0's by slot."""
    rng = np.random.default_rng(5)
    L = 3 * TILE + 17
    emb, ids = _lists(rng, [L, 300], L, 32)
    dup = emb[0, TILE - 1].copy()
    emb[0, TILE] = emb[0, 2 * TILE] = emb[1, 5] = dup
    q = 2.0 * dup[None]
    probe = np.array([[1, 0]], np.int32)
    want = [ids[1, 5], TILE - 1, TILE, 2 * TILE]
    for plan in ((1, 1, 4 * TILE), (1, 4, TILE), (2, 2, 2 * TILE)):
        s, i = _check(q, emb, ids, probe, 6, plan)
        assert list(i[0, :4]) == want, plan
        assert (s[0, :4] == s[0, 0]).all()


def test_probe_ids_outside_the_lists_probe_an_empty_list():
    rng = np.random.default_rng(6)
    emb, ids = _lists(rng, [6, 4, 0], 6, 16)
    q = _unit(rng, 2, 16)
    probe = np.array([[0, -1], [3, 1]], np.int32)
    s, i = _emulate(q, emb, ids, probe, 8, (1, 1, TILE))
    s_r, i_r = _plain(q, emb, ids, np.array([[0, 2], [2, 1]], np.int32), 8)
    np.testing.assert_allclose(s, s_r, rtol=0, atol=TOL)
    assert _ids_agree(s_r, i, i_r)
