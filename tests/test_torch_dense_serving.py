"""The serving paths of the port's dense decoders (llama3-8b, gemma2-9b,
nemotron-4-15b) against the reference on the CPU: exact greedy tokens.

  * ``generate`` and ``generate_reference`` (with an EOS stop, and a
    wave that decodes past gemma2's window of 16), the paged continuous
    queue with forks of a shared prefix (and every scheduler counter),
    the wave ``RequestQueue``, the non-paged continuous queue and the
    same queue standing (``test_torch_hybrid.py``'s checks), at the
    smoke config (d 64); the paged queue also with 2 KV heads, and
    gemma2's at head dim 256.

The reference's cache-kind tests (the paged standing queue among them)
and the launcher are in ``test_torch_dense_cache_kinds.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

import test_torch_hybrid as hybrid_t  # noqa: E402
from test_torch_dense import ARCHS, HD256, dense_pair  # noqa: E402


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    return dense_pair(request.param)


def test_dense_generate_matches_reference(bridged):
    hybrid_t.check_generate(*bridged)


def test_dense_paged_queue_with_forks_matches_reference(bridged):
    hybrid_t.check_paged_queue(*bridged, "forks", "fifo")


@pytest.mark.parametrize("variant", ["gqa2", "hd256"])
def test_dense_paged_queue_variants_match_reference(variant):
    """The paged queue with forks at GQA group 2 (gemma2: a local and a
    pooled layer of 4 query heads over 2 KV heads) and gemma2 at head dim
    256."""
    pair = dense_pair("gemma2-9b", num_kv_heads=2) if variant == "gqa2" \
        else dense_pair("gemma2-9b", smoke=HD256)
    assert pair[0].resolved_head_dim == (256 if variant == "hd256" else 16)
    hybrid_t.check_paged_queue(*pair, "forks", "fifo")


def test_dense_wave_queue_matches_reference(bridged):
    hybrid_t.check_wave_queue(*bridged)


def test_dense_nonpaged_queues_match_reference(bridged):
    hybrid_t.check_nonpaged_queues(*bridged)
