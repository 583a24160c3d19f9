"""The plain attention versions (what the CUDA kernels are held to on the
card) against the reference's Pallas kernels in interpret mode and its
jnp oracles, at the shapes where the Hopper designs split their work:
long block tables, a first position mid-block, B 1, ragged query tiles
(Sq 13 and 40) over keys that span several 64-key tiles, hd 64, GQA.
Also the wrapper's rule for splitting a table across thread blocks.

Tolerance: 1e-5 absolute in f32 (the same math summed in another
order)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.paged_attention import \
    paged_decode_attention_pallas  # noqa: E402
from repro.models.layers import flash_attention as jnp_flash  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402

TOL = 1e-5


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _paged(B, H, KV, hd, bs, nb, lengths, firsts, seed, free=()):
    """Rows with ``ceil((last+1)/bs)`` blocks drawn from a shuffled pool;
    the table columns listed in ``free`` (row, col) are set to -1."""
    rng = np.random.default_rng(seed)
    P = sum(-(-(n + 1) // bs) for n in lengths) + 3
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = rng.standard_normal((P, bs, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((P, bs, KV, hd)).astype(np.float32)
    perm = rng.permutation(P).astype(np.int32)
    tables = np.full((B, nb), -1, np.int32)
    used = 0
    for b, n in enumerate(lengths):
        m = -(-(n + 1) // bs)
        tables[b, :m] = perm[used:used + m]
        used += m
    for b, j in free:
        tables[b, j] = -1
    return (q, kp, vp, tables, np.asarray(firsts, np.int32),
            np.asarray(lengths, np.int32))


PAGED_CASES = {
    # long table, first mid-block, B 1
    "B1 nb48 first mid-block": dict(B=1, H=4, KV=2, hd=16, bs=4, nb=48,
                                    lengths=[185], firsts=[6]),
    # a range inside one block, a freed column inside the range, MHA
    "B3 nb40 range in one block": dict(B=3, H=4, KV=4, hd=16, bs=4, nb=40,
                                       lengths=[150, 22, 99],
                                       firsts=[37, 20, 0],
                                       free=((2, 5),)),
    # G = 4 query heads per KV head, odd block size
    "B2 nb42 gqa4 bs3": dict(B=2, H=8, KV=2, hd=8, bs=3, nb=42,
                             lengths=[120, 61], firsts=[1, 59]),
}


@pytest.mark.parametrize("name", sorted(PAGED_CASES))
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_paged_plain_matches_pallas_at_split_shapes(name, softcap):
    c = dict(PAGED_CASES[name])
    args = _paged(**c, seed=len(name))
    got = ops.paged_decode_attention(*map(t, args), softcap=softcap)
    jargs = [jnp.asarray(a) for a in args]
    pallas = paged_decode_attention_pallas(*jargs, softcap=softcap,
                                           interpret=True)
    oracle = jref.paged_attention_ref(*jargs, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=0,
                               atol=TOL)


FLASH_CASES = [
    # B, H, KV, Sq, Sk, hd, window, softcap: ragged q tiles over keys
    # spanning several 64-key tiles
    (1, 4, 2, 13, 141, 64, None, None),
    (1, 4, 2, 40, 200, 64, None, None),
    (2, 4, 1, 40, 200, 64, 5, 30.0),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_plain_matches_pallas_ragged_tiles(case):
    B, H, KV, Sq, Sk, hd, window, cap = case
    rng = np.random.default_rng(Sq)
    q = rng.standard_normal((B, H, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, Sk, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, Sk, hd)).astype(np.float32)
    got = ops.flash_attention_aligned(t(q), t(k), t(v), window=window,
                                      softcap=cap)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=window,
                                  softcap=cap, q_block=32, kv_block=64,
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("Sq,lead", [(13, 37), (40, 75)])
def test_flash_plain_matches_layers_flash_chunk_path(Sq, lead):
    """Chunk-path inputs: ``lead`` unwritten slots, then cached keys that
    start mid-tile, more -1 slots, then the chunk (pads at -1)."""
    rng = np.random.default_rng(lead)
    B, H, KV, hd, Sk = 2, 4, 2, 64, 256 + Sq
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    kv_pos = np.full((B, Sk), -1, np.int32)
    q_pos = np.full((B, Sq), -1, np.int32)
    past, pads = [100, 9], [0, 3]
    for b in range(B):
        kv_pos[b, lead:lead + past[b]] = np.arange(past[b])
        real = np.arange(past[b], past[b] + Sq - pads[b])
        q_pos[b, pads[b]:] = real
        kv_pos[b, Sk - Sq + pads[b]:] = real
    got = ops.flash_attention(t(q), t(k), t(v), t(q_pos), t(kv_pos))
    want = jnp_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=True,
                     q_block=16, kv_block=64)
    assert torch.isfinite(got).all()
    rows = q_pos >= 0
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                               rtol=0, atol=TOL)


def test_paged_split_rule_bounds():
    for sms in (1, 78, 132):
        for B in (1, 2, 4, 8, 32, 256):
            for KV in (1, 2, 16):
                for nb in (1, 3, 4, 12, 128, 1000):
                    n = ops.paged_decode_splits(B, KV, nb, sms)
                    assert n >= 1
                    assert n <= max(1, nb)       # never past the columns
                    if n > 1:
                        # every warp of every split has a column, and the
                        # grid stays within two blocks per SM plus a row
                        assert -(-nb // n) >= ops.PAGED_WARPS
                        assert B * KV * (n - 1) < 2 * sms
                    if B * KV >= sms:
                        assert n == 1            # the rows fill the SMs


def test_paged_split_rule_main_path_and_scale():
    # olmo-1b decode on an H100: B 4 x KV 16 rows, 12 live columns
    assert ops.paged_decode_splits(4, 16, 12, 132) == 3
    assert ops.paged_decode_splits(1, 16, 128, 132) == 17
    assert ops.paged_decode_splits(32, 16, 128, 132) == 1
