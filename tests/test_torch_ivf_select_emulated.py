"""``csrc/ivf_select.cu`` and ``csrc/ivf_topk.cu`` built with g++ against
``tests/cuda_emu.h`` (``test_torch_ivf_select.py``'s ``emulated``
fixture): the two kernels on their shared scan core
(``csrc/ivf_core.cuh``).  The first 32 of ``ivf_select.cu``'s k 64 are
bitwise ``ivf_topk.cu``'s k 32 and two calls are bitwise equal; the
narrow kernel is held to the plain version at k 1, 5 and 32.  These
cases run the emulation longest, so they sit in a file of their own,
which ``--dist loadfile`` gives a worker of its own."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from test_torch_ivf_select import (  # noqa: E402,F401  (emulated: fixture)
    TOL, _case, _ids_agree, _lists, _plain, _run_narrow, _run_select,
    _unit, emulated)


@pytest.mark.parametrize("name", ["k 300", "small rows", "forced plan"])
def test_cuda_source_emulated_first_32_equal_narrow_and_repeat(emulated,
                                                               name):
    """The shared scan core: one fmaf chain per (pair, row) in both
    kernels, so the first 32 of k 64 are bitwise csrc/ivf_topk.cu's k 32;
    and two calls are bitwise equal."""
    q, emb, ids, probe, _, chunk_q, plan = _case(name)
    s64, i64 = _run_select(emulated, q, emb, ids, probe, 64, chunk_q, plan)
    s32, i32 = _run_narrow(emulated, q, emb, ids, probe, 32)
    np.testing.assert_array_equal(s64[:, :32], s32)
    np.testing.assert_array_equal(i64[:, :32], i32)
    s2, i2 = _run_select(emulated, q, emb, ids, probe, 64, chunk_q, plan)
    np.testing.assert_array_equal(s64, s2)
    np.testing.assert_array_equal(i64, i2)


@pytest.mark.parametrize("k", [1, 5, 32])
def test_cuda_source_emulated_narrow_kernel_on_the_shared_core(emulated, k):
    """csrc/ivf_topk.cu after its scan moved into csrc/ivf_core.cuh: held
    to the plain version at k <= 32, with a list named by more pairs than
    a group holds (two groups of list 0's 40 pairs)."""
    rng = np.random.default_rng(30 + k)
    emb, ids = _lists(rng, [300, 280, 0, 150], 300, 8, holes=[(1, 9)])
    q = _unit(rng, 40, 8)
    probe = np.stack([rng.permutation(4)[:3] for _ in range(40)]).astype(
        np.int32)
    probe[:, 0] = 0                    # list 0: 40 pairs
    s, i = _run_narrow(emulated, q, emb, ids, probe, k)
    s_r, i_r = _plain(q, emb, ids, probe, k)
    np.testing.assert_allclose(s, s_r, rtol=0, atol=TOL)
    assert _ids_agree(s_r, i, i_r)
