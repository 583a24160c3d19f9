"""The port's IVF retrieval against the reference on the CPU: the plain
version of the IVF probe kernel (what ``ops.ivf_retrieval_topk`` runs for
CPU tensors) against ``ivf_topk_ref`` and ``ivf_topk_pallas`` in
interpret mode; the torch k-means against the jax one; ``IVFIndex``
against the reference's kernel path (``use_pallas=True``, the Pallas
kernel in interpret mode on the CPU), its numpy path, and with the
reference's trained quantizer carried across; the shard sketches.

Tolerances: kernel scores 1e-6 absolute (unit-norm f32 dot products
summed in another order); index scores 1e-5; centroids 1e-5 (the same
Lloyd steps in f32, sums in another order); doc ids and assignments
exactly.  Exact ties are built from small integers, whose dot products
are exact in f32 in any summation order."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.data.corpus import generate_corpus as j_corpus  # noqa: E402
from repro.data.partition import partition_edge_data as j_partition  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.topk_retrieval import ivf_topk_pallas  # noqa: E402
from repro.retrieval.encoder import TextEncoder as JEncoder  # noqa: E402
from repro.retrieval.index import FlatIndex as JFlatIndex  # noqa: E402
from repro.retrieval.ivf import IVFIndex as JIVFIndex  # noqa: E402
from repro.retrieval.ivf import kmeans as j_kmeans  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.retrieval.index import (FlatIndex, VectorIndex,  # noqa: E402
                                         build_index)
from repro_torch.retrieval.ivf import IVFIndex, kmeans  # noqa: E402

KERNEL_TOL = 1e-6
INDEX_TOL = 1e-5


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _lists(rng, n_lists, L, D, sizes):
    """Packed lists as IVFIndex.train lays them out: list l holds
    ``sizes[l]`` live rows then -1 padding; global ids are unique."""
    emb = _unit(rng, n_lists, L, D)
    ids = np.full((n_lists, L), -1, np.int32)
    nxt = 0
    for l, n in enumerate(sizes):
        ids[l, :n] = np.arange(nxt, nxt + n)
        emb[l, n:] = 0.0
        nxt += n
    return emb, ids


def _check_kernel(q, emb, ids, probe, k):
    s, i = ops.ivf_retrieval_topk(t(q), t(emb), t(ids), t(probe), k)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    js, ji = jref.ivf_topk_ref(*map(jnp.asarray, (q, emb, ids, probe)), k)
    ps, pi = ivf_topk_pallas(*map(jnp.asarray, (q, emb, ids, probe)), k,
                             interpret=True)
    for ws, wi in ((js, ji), (ps, pi)):
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=0,
                                   atol=KERNEL_TOL)
    return s.numpy(), i.numpy()


# (Nq, D, list sizes (L = max, or the given L), nprobe, k)
KERNEL_CASES = {
    "padded lists": (4, 32, [7, 4, 7, 6, 2], 3, 6),
    "k above live docs": (3, 16, [2, 1, 3, 0], 2, 6),
    "empty list probed": (3, 16, [5, 0, 5], 3, 4),
    "nprobe 1": (5, 16, [9, 8, 9, 3, 9, 6], 1, 4),
    "L 37, k 32": (2, 24, [37, 30, 11], 2, 32),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES), ids=str)
def test_plain_ivf_topk_matches_pallas_and_oracle(case):
    nq, D, sizes, nprobe, k = KERNEL_CASES[case]
    rng = np.random.default_rng(len(case))
    n_lists, L = len(sizes), max(sizes)
    emb, ids = _lists(rng, n_lists, L, D, sizes)
    q = _unit(rng, nq, D)
    probe = np.stack([rng.permutation(n_lists)[:nprobe]
                      for _ in range(nq)]).astype(np.int32)
    s, i = _check_kernel(q, emb, ids, probe, k)
    live = np.asarray(sizes)[probe].sum(axis=1)
    for row in range(nq):
        n = min(k, int(live[row]))
        assert (i[row, :n] >= 0).all()
        assert (i[row, n:] == -1).all() and (s[row, n:] <= -1e29).all()


def test_plain_ivf_topk_exact_ties_follow_probe_then_slot():
    """Integer rows: list 0 holds a row twice (slots 0 and 2); list 2
    holds the same row at slot 1.  Probing [2, 0] puts list 2's copy
    first (earlier probe), then list 0's by slot."""
    D = 8
    row = np.array([1, 0, 2, 0, 1, 0, 0, 1], np.float32)
    emb = np.zeros((3, 4, D), np.float32)
    ids = np.array([[10, 11, 12, -1], [20, 21, -1, -1], [30, 31, 32, 33]],
                   np.int32)
    emb[0, 0] = emb[0, 2] = emb[2, 1] = row
    emb[0, 1] = row * 0.5
    emb[1, 0] = row
    emb[2, 0] = emb[2, 2] = row * 0.5
    emb[2, 3] = -row
    q = np.stack([row, row]).astype(np.float32)
    probe = np.array([[2, 0], [0, 1]], np.int32)
    s, i = _check_kernel(q, emb, ids, probe, 6)
    assert i[0].tolist() == [31, 10, 12, 30, 32, 11]
    assert i[1].tolist() == [10, 12, 20, 11, 21, -1]
    assert s[1, 5] <= -1e29


def test_plain_ivf_topk_fills_when_k_exceeds_probed_slots():
    """k above nprobe * L (the oracle's lax.top_k cannot take it): the
    plain version returns the oracle's top nprobe*L, then (-1e30, -1)."""
    rng = np.random.default_rng(7)
    emb, ids = _lists(rng, 3, 4, 16, [4, 3, 4])
    q = _unit(rng, 2, 16)
    probe = np.array([[0, 1], [2, 1]], np.int32)
    s, i = ops.ivf_retrieval_topk(t(q), t(emb), t(ids), t(probe), 12)
    js, ji = jref.ivf_topk_ref(*map(jnp.asarray, (q, emb, ids, probe)), 8)
    np.testing.assert_array_equal(i[:, :8].numpy(), np.asarray(ji))
    np.testing.assert_allclose(s[:, :8].numpy(), np.asarray(js), rtol=0,
                               atol=KERNEL_TOL)
    assert (i[:, 8:] == -1).all() and (s[:, 8:] <= -1e29).all()


# ------------------------------------------------------------------ k-means


@pytest.fixture(scope="module")
def corpus():
    docs, qas = j_corpus(20, seed=0)                 # 120 docs, 6 domains
    enc = JEncoder(seed=0)
    emb = enc.encode([d.text for d in docs])
    shards = j_partition(docs, 2, [[0, 2, 4], [1, 3, 5]], seed=0)
    shard_embs = [enc.encode([d.text for d in s]) for s in shards]
    q = enc.encode([qa.question for qa in qas[::3]])
    return docs, emb, shard_embs, q


def _kmeans_inputs(name, corpus):
    if name == "random":
        return _unit(np.random.default_rng(3), 400, 32), 12, 5
    _, emb, shard_embs, _ = corpus
    if name == "corpus":
        return emb, 10, 0
    return shard_embs[int(name[-1])], 8, 1 + int(name[-1])


@pytest.mark.parametrize("name", ["random", "corpus", "shard0", "shard1"])
def test_kmeans_matches_reference(name, corpus):
    x, c, seed = _kmeans_inputs(name, corpus)
    jc, ja = j_kmeans(x, c, seed=seed)
    pc, pa = kmeans(x, c, seed=seed)
    np.testing.assert_array_equal(pa.numpy(), ja)
    np.testing.assert_allclose(pc.numpy(), jc, rtol=0, atol=1e-5)


# ----------------------------------------------------------------- IVFIndex


def _pair(emb, payloads, **kw):
    ours = IVFIndex(emb.shape[1], device="cpu", **kw)
    theirs = JIVFIndex(emb.shape[1], use_pallas=True, **kw)
    for idx in (ours, theirs):
        idx.add(emb, payloads)
    return ours, theirs


@pytest.mark.parametrize("kw", [{}, {"n_lists": 6, "nprobe": 3, "seed": 2}],
                         ids=["defaults", "6 lists nprobe 3"])
def test_ivf_index_matches_reference_kernel_path(kw, corpus):
    _, emb, _, q = corpus
    ours, theirs = _pair(emb, list(range(len(emb))), **kw)
    s, i = ours.search(q, 4)
    js, ji = theirs.search(q, 4)
    assert i.dtype == np.int32 and s.shape == (len(q), 4)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=0, atol=INDEX_TOL)
    assert (ours.n_lists, ours.nprobe) == (theirs.n_lists, theirs.nprobe)
    assert ours.last_scored_frac == theirs.last_scored_frac
    assert 0 < ours.last_scored_frac < 1


def test_ivf_index_with_carried_quantizer_is_exact(corpus):
    """The reference's trained state, carried through ``bridge``: ids
    stay exact whatever k-means would give on either side."""
    _, emb, shard_embs, q = corpus
    x = shard_embs[0]
    theirs = JIVFIndex(x.shape[1], nprobe=2, use_pallas=True, seed=4)
    ours = IVFIndex(x.shape[1], nprobe=2, seed=4, device="cpu")
    for idx in (ours, theirs):
        idx.add(x, list(range(len(x))))
    theirs.train()
    bridge.ivf_state_from_numpy(ours, theirs._centroids, theirs._list_emb,
                                theirs._list_ids, theirs._list_sizes)
    s, i = ours.search(q, 3)
    js, ji = theirs.search(q, 3)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=0, atol=INDEX_TOL)
    assert ours.last_scored_frac == theirs.last_scored_frac
    with pytest.raises(ValueError):
        bridge.ivf_state_from_numpy(ours, theirs._centroids,
                                    theirs._list_emb[:, :1],
                                    theirs._list_ids, theirs._list_sizes)


def test_ivf_index_matches_reference_numpy_probe(corpus):
    """The reference node's default path (``use_pallas=False``) walks
    lists in ``np.unique`` order and breaks exact ties arbitrarily: ids
    must agree in every row whose top-k holds no exact tie."""
    _, emb, _, q = corpus
    ours = IVFIndex(emb.shape[1], nprobe=3, device="cpu")
    theirs = JIVFIndex(emb.shape[1], nprobe=3, use_pallas=False)
    for idx in (ours, theirs):
        idx.add(emb, list(range(len(emb))))
    s, i = ours.search(q, 5)
    js, ji = theirs.search(q, 5)
    np.testing.assert_allclose(s, js, rtol=0, atol=INDEX_TOL)
    for row in range(len(q)):
        if len(np.unique(js[row])) == js.shape[1]:
            assert i[row].tolist() == ji[row].tolist(), row


def test_ivf_index_edge_cases_match_reference(corpus):
    docs, emb, _, q = corpus
    ours, theirs = IVFIndex(8, device="cpu"), JIVFIndex(8, use_pallas=True)
    for idx in (ours, theirs):                       # empty index
        s, i = idx.search(np.zeros((2, 8), np.float32), 3)
        assert s.shape == (2, 0) and i.shape == (2, 0)
        assert i.dtype == np.int32
    for idx in (ours, theirs):
        idx.add(np.eye(2, 8, dtype=np.float32), ["a", "b"])
    s, i = ours.search(np.ones((1, 8), np.float32), 5)     # k > n
    js, ji = theirs.search(np.ones((1, 8), np.float32), 5)
    assert s.shape == (1, 2)
    np.testing.assert_array_equal(i, ji)
    assert ours.payloads(i[0]) == theirs.payloads(ji[0])
    assert ours.payloads([-1, 0]) == ["a"]
    assert ours.search(np.ones((1, 8), np.float32), 0)[0].shape == (1, 0)
    # retrain after add: lazily, to the reference's lists
    ours, theirs = _pair(emb[:50], list(range(50)))
    ours.search(q[:1], 2)
    theirs.search(q[:1], 2)
    before = ours.n_lists
    for idx in (ours, theirs):
        idx.add(emb[50:], list(range(50, len(emb))))
    assert ours._dirty
    s, i = ours.search(q, 2)
    js, ji = theirs.search(q, 2)
    assert not ours._dirty and ours.n_lists >= before
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, rtol=0, atol=INDEX_TOL)


# ----------------------------------------------------------------- sketches


@pytest.mark.parametrize("kind", ["flat", "ivf reuses lists",
                                  "ivf refits"])
def test_sketch_matches_reference(kind, corpus):
    _, _, shard_embs, _ = corpus
    x = shard_embs[1]
    if kind == "flat":
        ours, theirs = FlatIndex(x.shape[1], device="cpu"), \
            JFlatIndex(x.shape[1])
        m = 8
    else:
        ours, theirs = IVFIndex(x.shape[1], device="cpu"), \
            JIVFIndex(x.shape[1])
        m = 8 if kind == "ivf reuses lists" else 4
    for idx in (ours, theirs):
        idx.add(x, list(range(len(x))))
    c, n = ours.sketch(m, seed=5)
    jc, jn = theirs.sketch(m, seed=5)
    assert isinstance(c, np.ndarray) and n.dtype == np.float64
    np.testing.assert_allclose(c, jc, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(n, jn)
    empty = (FlatIndex(4, device="cpu") if kind == "flat"
             else IVFIndex(4, device="cpu"))
    assert empty.sketch()[0].shape == (0, 4)


def test_build_index_builds_ivf():
    ivf = build_index(16, "ivf", nprobe=2, device="cpu")
    assert isinstance(ivf, IVFIndex) and isinstance(ivf, VectorIndex)
    assert isinstance(build_index(16, device="cpu"), FlatIndex)
    with pytest.raises(ValueError):
        build_index(16, "faiss", device="cpu")
