"""The tensor-core primitives of ``tests/cuda_emu.h`` against the PTX ISA.

``csrc/common.cuh`` wraps ``ldmatrix.sync.aligned.m8n8.x4[.trans].b16``
and ``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`` (and packs
two f32 into a register of two bf16); the emulation in ``cuda_emu.h``
lets the CUDA sources that use them (``csrc/flash_attention_bwd.cu``'s
bf16 kernels) run on the CPU.  Here each primitive runs on one emulated
warp and its per-lane registers are held to the fragment tables of the
PTX ISA, stated below in numpy on their own (not read back from the
emulation):

  * ldmatrix .x4: lane 8i + r gives the address of row r of matrix i;
    lane l receives in register i the b16 pair (row l // 4, columns
    2 (l % 4) and 2 (l % 4) + 1) of matrix i, the lower column in the
    low half; .trans reads each matrix transposed.  The rows lie at
    permuted addresses with a padded stride, so only the addresses
    decide what each lane gets.
  * mma m16n8k16: with g = l // 4 and t = l % 4, A's a0..a3 are (row g,
    columns 2t, 2t+1), (row g+8, the same), (row g, columns 2t+8, 2t+9)
    and (row g+8, those); B's b0, b1 are (rows 2t, 2t+1 of column g) and
    (rows 2t+8, 2t+9); C and D's c0..c3 are (row g, columns 2t, 2t+1)
    and (row g+8, the same).  Operands are multiples of 1/8 and 1/64, so
    D = A B + C is exact in f32 and compared bit for bit.
  * pack_bf16 rounds to nearest even, as ``__floats2bfloat162_rn``:
    against torch's own f32 -> bf16 conversion, halfway cases included.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

_SOURCE = r"""#include "cuda_emu.h"
__global__ void ld_kernel(const uint16_t* m, const int* rows, int ld,
                          int trans, uint32_t* out) {
  const int lane = threadIdx.x;
  uint32_t r[4];
  const uint16_t* p = m + rows[lane] * ld;
  if (trans)
    rt::ldmatrix_x4_trans(r, p);
  else
    rt::ldmatrix_x4(r, p);
  for (int i = 0; i < 4; ++i) out[lane * 4 + i] = r[i];
}
__global__ void mma_kernel(const uint32_t* frags, const float* cin,
                           float* cout) {
  const int lane = threadIdx.x;
  const uint32_t* f = frags + lane * 6;
  const uint32_t a[4] = {f[0], f[1], f[2], f[3]};
  float c[4];
  for (int e = 0; e < 4; ++e) c[e] = cin[lane * 4 + e];
  rt::mma_bf16_16816(c, a, f[4], f[5]);
  for (int e = 0; e < 4; ++e) cout[lane * 4 + e] = c[e];
}
__global__ void pack_kernel(const float* x, uint32_t* out, int n) {
  for (int i = threadIdx.x; i < n; i += 32)
    out[i] = rt::pack_bf16(x[2 * i], x[2 * i + 1]);
}
extern "C" void run_ld(const uint16_t* m, const int* rows, int ld,
                       int trans, uint32_t* out) {
  emu_launch_dyn(dim3(1), 32, 0, ld_kernel, m, rows, ld, trans, out);
}
extern "C" void run_mma(const uint32_t* frags, const float* cin,
                        float* cout) {
  emu_launch_dyn(dim3(1), 32, 0, mma_kernel, frags, cin, cout);
}
extern "C" void run_pack(const float* x, uint32_t* out, int n) {
  emu_launch_dyn(dim3(1), 32, 0, pack_kernel, x, out, n);
}
"""


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The three primitives, each in a one-warp kernel, built with g++
    against tests/cuda_emu.h."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the CUDA emulation cannot be "
                    "built")
    tmp = tmp_path_factory.mktemp("mma_emu")
    src, lib = tmp / "mma_emu.cpp", tmp / "libmma_emu.so"
    src.write_text(_SOURCE)
    res = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
         f"-I{Path(__file__).resolve().parent}", "-o", str(lib), str(src)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return ctypes.CDLL(str(lib))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _bits(x):
    """The bf16 bits of f32 values that are exact in bf16."""
    u = np.asarray(x, np.float32).view(np.uint32)
    assert not (u & 0xffff).any(), "not exact in bf16"
    return (u >> 16).astype(np.uint32)


def _pack(lo, hi):
    return _bits(lo) | (_bits(hi) << 16)


@pytest.mark.parametrize("trans", [False, True], ids=["plain", "trans"])
def test_ldmatrix_matches_ptx_table(emu, trans):
    rng = np.random.default_rng(1)
    ld = 24                                      # padded row stride
    mem = rng.permutation(32 * ld).astype(np.uint16).reshape(32, ld)
    rows = rng.permutation(32).astype(np.int32)  # lane -> memory row
    out = np.zeros((32, 4), np.uint32)
    emu.run_ld(_ptr(mem), _ptr(rows), ld, int(trans), _ptr(out))
    # matrix i, row r: the 8 b16 at the address lane 8i + r gave
    mats = np.stack([mem[rows[8 * i:8 * i + 8], :8] for i in range(4)])
    want = np.zeros((32, 4), np.uint32)
    for lane in range(32):
        for i in range(4):
            m = mats[i].T if trans else mats[i]
            r, c = lane // 4, 2 * (lane % 4)
            want[lane, i] = int(m[r, c]) | (int(m[r, c + 1]) << 16)
    np.testing.assert_array_equal(out, want)


def test_mma_matches_ptx_table(emu):
    rng = np.random.default_rng(2)
    A = rng.integers(-16, 17, (16, 16)).astype(np.float32) / 8
    B = rng.integers(-16, 17, (16, 8)).astype(np.float32) / 8
    C = rng.integers(-512, 513, (16, 8)).astype(np.float32) / 64
    frags = np.zeros((32, 6), np.uint32)
    cin = np.zeros((32, 4), np.float32)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        frags[lane] = [
            _pack(A[g, 2 * t], A[g, 2 * t + 1]),
            _pack(A[g + 8, 2 * t], A[g + 8, 2 * t + 1]),
            _pack(A[g, 2 * t + 8], A[g, 2 * t + 9]),
            _pack(A[g + 8, 2 * t + 8], A[g + 8, 2 * t + 9]),
            _pack(B[2 * t, g], B[2 * t + 1, g]),
            _pack(B[2 * t + 8, g], B[2 * t + 9, g])]
        cin[lane] = [C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
                     C[g + 8, 2 * t + 1]]
    cout = np.zeros((32, 4), np.float32)
    emu.run_mma(_ptr(frags), _ptr(cin), _ptr(cout))
    D = np.zeros((16, 8), np.float32)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        D[g, 2 * t], D[g, 2 * t + 1] = cout[lane, 0], cout[lane, 1]
        D[g + 8, 2 * t], D[g + 8, 2 * t + 1] = cout[lane, 2], cout[lane, 3]
    want = (A.astype(np.float64) @ B.astype(np.float64) + C).astype(
        np.float32)
    np.testing.assert_array_equal(D, want)


def test_pack_bf16_rounds_to_nearest_even(emu):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(254).astype(np.float32) * 100
    # exact halfway cases below an even and an odd bf16, and carries
    half = (np.arange(1, 65, dtype=np.uint32) << 16 | 0x8000) + (
        0x3f80 << 16)
    x = np.concatenate([x, half.view(np.float32),
                        np.float32([0.0, -0.0, 1e-40, 3.4e38])])
    x = x[: 2 * (len(x) // 2)]
    out = np.zeros(len(x) // 2, np.uint32)
    emu.run_pack(_ptr(x), _ptr(out), len(out))
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    want = want.astype(np.uint16).astype(np.uint32)
    np.testing.assert_array_equal(out & 0xffff, want[0::2])
    np.testing.assert_array_equal(out >> 16, want[1::2])
