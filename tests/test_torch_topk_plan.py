"""The exact top-k kernel's split rule (``ops.retrieval_topk_plan``) and
its decomposition, on the CPU.

The CUDA kernel scores each (query group, doc split) block on its own,
keeps the split's top-k per query, and merges the splits' sorted lists in
split order.  Here that decomposition is emulated with torch at the
plan's edges (a doc past a tile, duplicates across tile and split
boundaries, a query past a group, k 32, k > Nd, Nd 1, D 30) and held to
the plain version ``ref.topk_ref`` and to the reference's Pallas kernel
in interpret mode.

Tolerance: scores within 1e-5 absolute (the same f32 dot products
summed in another order); ids equal, except where the plain scores of
two slots lie within 2e-5 of each other (another order may swap a
near-tie), and always equal on exact duplicates."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.kernels.topk_retrieval import topk_pallas  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402

TOL = 1e-5
G, TILE = ops.TOPK_GROUP, ops.TOPK_TILE


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _splits(Nd, n_splits, per):
    return [(s * per, min(Nd, (s + 1) * per)) for s in range(n_splits)]


# ------------------------------------------------------------- the plan


@pytest.mark.parametrize("Nq,Nd,sms", [
    (8, 240, 132), (32, 1_000_000, 132), (1, 1_000_000, 132),
    (33, 4097, 132), (65, 1_000_000, 132), (8, 0, 132), (1, 1, 132),
    (8, 4 * TILE, 132), (8, 4 * TILE + 1, 132), (31, 12_345, 8),
    (200, 77_777, 132), (5, 3 * TILE - 1, 1),
])
def test_plan_covers_every_doc_once(Nq, Nd, sms):
    groups, n_splits, per = ops.retrieval_topk_plan(Nq, Nd, sms)
    assert groups == -(-Nq // G) and G >= 32
    assert per % TILE == 0 and n_splits >= 1
    spans = _splits(Nd, n_splits, per)
    covered = np.zeros(Nd, dtype=np.int64)
    for a, b in spans:
        assert a < b or Nd == 0, f"empty split {a}:{b}"
        covered[a:b] += 1
    assert (covered == 1).all()
    assert spans[-1][1] == Nd


def test_plan_main_path_is_one_block_and_1m_docs_fill_the_card():
    assert ops.retrieval_topk_plan(8, 240, 132) == (1, 1, 2 * TILE)
    groups, n_splits, _ = ops.retrieval_topk_plan(32, 1_000_000, 132)
    assert groups == 1 and groups * n_splits >= 132
    groups, n_splits, _ = ops.retrieval_topk_plan(1, 1_000_000, 132)
    assert groups * n_splits >= 132


@pytest.mark.parametrize("Nq", [32, 33, 64, 65, 1000])
def test_plan_groups_hold_32_queries(Nq):
    groups, _, _ = ops.retrieval_topk_plan(Nq, 10_000, 132)
    # every group but the last is full
    assert (groups - 1) * G < Nq <= groups * G


# ------------------------------------------------- the decomposition


def _emulate(q, d, k, groups, n_splits, per):
    """The kernel's decomposition: per (group, split) the split's top-k
    (scores of one (query, doc) pair, ties to the lower id, (-1e30, -1)
    fill), then per query the best k of the splits' lists, in split
    order."""
    Nq = q.shape[0]
    out_s = torch.empty((Nq, k))
    out_i = torch.empty((Nq, k), dtype=torch.int32)
    spans = _splits(d.shape[0], n_splits, per)
    for g in range(groups):
        qg = q[g * G:(g + 1) * G]
        lists_s, lists_i = [], []
        for a, b in spans:
            s, i = ref.topk_ref(qg, d[a:b], k)
            lists_s.append(s)
            lists_i.append(torch.where(i >= 0, i + a, i))
        cat_s, cat_i = torch.cat(lists_s, 1), torch.cat(lists_i, 1)
        # best k under (score desc, id asc), fills (id -1) last
        key_i = torch.where(cat_i < 0, torch.full_like(cat_i, 2 ** 31 - 1),
                            cat_i).long()
        order = torch.argsort(key_i, dim=1, stable=True)
        s_by_id = torch.gather(cat_s, 1, order)
        pos = torch.argsort(s_by_id, dim=1, descending=True, stable=True)
        pick = torch.gather(order, 1, pos)[:, :k]
        out_s[g * G:(g + 1) * G] = torch.gather(cat_s, 1, pick)
        out_i[g * G:(g + 1) * G] = torch.gather(cat_i, 1, pick)
    return out_s, out_i


def _ids_agree(s_plain, i, i_plain, tol=TOL):
    same = i == i_plain
    k = s_plain.shape[1]
    gap = np.abs(s_plain[:, :, None] - s_plain[:, None, :])
    near = ((gap <= 2 * tol) & ~np.eye(k, dtype=bool)).any(-1)
    return bool((same | near).all())


def _check(q, d, k, plan):
    s, i = _emulate(torch.from_numpy(q), torch.from_numpy(d), k, *plan)
    s_r, i_r = ref.topk_ref(torch.from_numpy(q), torch.from_numpy(d), k)
    s_p, i_p = topk_pallas(jnp.asarray(q), jnp.asarray(d), k, q_block=16,
                           d_block=64, interpret=True)
    s_p, i_p = np.asarray(s_p), np.asarray(i_p)
    np.testing.assert_allclose(s.numpy(), s_r.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(s.numpy(), s_p, rtol=0, atol=TOL)
    assert _ids_agree(s_r.numpy(), i.numpy(), i_r.numpy())
    assert _ids_agree(s_r.numpy(), i.numpy(), i_p)
    return s.numpy(), i.numpy()


# (Nq, Nd, D, k, forced docs per split or None for the plan's)
EDGES = {
    "Nd tile-1": (8, TILE - 1, 32, 5, None),
    "Nd tile+1": (8, TILE + 1, 32, 5, None),
    "Nd 4 tiles+1, 2 splits": (8, 4 * TILE + 1, 16, 4, 2 * TILE),
    "Nq G-1": (G - 1, 300, 16, 3, TILE),
    "Nq G+1": (G + 1, 300, 16, 3, TILE),
    "k 32": (4, 700, 16, 32, 2 * TILE),
    "k 32 > split": (3, 300, 8, 32, TILE),
    "k > Nd": (4, 3, 8, 5, None),
    "Nd 1": (2, 1, 8, 3, None),
    "D 30": (5, 1000, 30, 6, 3 * TILE),
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_decomposition_matches_plain_and_pallas(name):
    Nq, Nd, D, k, per = EDGES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q, d = _unit(rng, Nq, D), _unit(rng, Nd, D)
    groups, n_splits, plan_per = ops.retrieval_topk_plan(Nq, Nd, 132)
    if per is not None:
        n_splits, plan_per = -(-Nd // per), per
    s, i = _check(q, d, k, (groups, n_splits, plan_per))
    if k > Nd:
        assert (i[:, Nd:] == -1).all() and (s[:, Nd:] <= -1e29).all()


def test_duplicates_across_tile_and_split_boundaries_go_to_lowest_id():
    """Doc rows equal across a tile boundary (TILE-1, TILE) and a split
    boundary (2*TILE-1, 2*TILE, 3*TILE): each query's best row appears
    two or three times, and its ids come out lowest first."""
    rng = np.random.default_rng(15)
    D, Nd, per = 16, 4 * TILE, 2 * TILE
    d = _unit(rng, Nd, D)
    groups_of_dups = [(TILE - 1, TILE), (2 * TILE - 1, 2 * TILE, 3 * TILE),
                      (5, 2 * TILE + 5)]
    for dup in groups_of_dups:
        d[list(dup[1:])] = d[dup[0]]
    q = np.stack([2.0 * d[g[0]] for g in groups_of_dups])
    s, i = _check(q, d, 4, (1, -(-Nd // per), per))
    for row, dup in enumerate(groups_of_dups):
        assert list(i[row, :len(dup)]) == list(dup)
        assert (s[row, :len(dup)] == s[row, 0]).all()
