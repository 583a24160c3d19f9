"""The gradient of the port's flash attention on the CPU.

  * The plain backward (``ref.flash_attention_bwd_ref``: autograd of
    ``ref.flash_attention_ref``, what ``ops.flash_attention_bwd`` runs on
    CPU tensors) against ``jax.grad`` of the reference's
    ``repro.models.layers.flash_attention`` (its blocked jnp attention,
    the function the reference trains through): causal, a window, a
    softcap, GQA group 2, left-padded ``kv_pos`` with pad queries.  Rows
    of a query with no valid key are unspecified: their output gradient
    is 0 on both sides and their dq is not compared.  Tolerance 2e-5
    absolute (f32, the same math blocked in another order).
  * ``csrc/flash_attention_bwd.cu`` itself, compiled with g++ against
    ``tests/cuda_emu.h`` (a bf16 stand-in added to its ``common.cuh``;
    the emulation's ldmatrix, mma.sync and bf16 packing are held to the
    PTX fragment tables in ``test_torch_mma_emu.py``), against the plain
    backward at tiny shapes (``EMU_CASES``): f32 inputs run the FFMA
    kernels, within 2e-5; bf16 inputs run the tensor-core kernels as
    written, within 2e-2 of max|grad| (P and dS round to bf16 for their
    products, the outputs to bf16).  The cases: GQA 2 with a window, a
    softcap and a left pad at hd 24 (padded to 32 along the
    contraction); non-causal at hd 8 over 70 keys; hd 128 over 72
    positions (past one 64-row tile) with GQA 2, a window and a left
    pad; hd 256 over 68 (the dK/dV columns split between warp pairs)
    with GQA 2, a window, a softcap and a left pad.  Then through
    ``ops.flash_attention_bwd``'s CUDA branch (the wrapper's argument
    order and checks) and through ``ops.FlashAttention``, the autograd
    function the model's training path takes on the card, with the
    forward's ``lse`` computed by the plain route.
"""
import ctypes
import math
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.models.layers import flash_attention as jflash  # noqa: E402

from repro_torch.kernels import build, ops, ref  # noqa: E402

TOL = 2e-5

CASES = {
    # B, Sq, Sk, H, KV, hd, causal, window, softcap, left pads per row
    "causal": (2, 24, 24, 4, 4, 16, True, None, None, (0, 0)),
    "window": (2, 24, 24, 4, 2, 16, True, 6, None, (0, 0)),
    "softcap": (1, 20, 20, 2, 2, 32, True, None, 5.0, (0,)),
    "gqa2-noncausal": (2, 12, 30, 4, 2, 8, False, None, None, (0, 0)),
    "left-pad": (2, 16, 16, 4, 2, 16, True, None, 30.0, (5, 0)),
}


def _inputs(B, Sq, Sk, H, KV, hd, causal, window, softcap, pads, seed=0):
    """numpy q, k, v, dO, q_pos, kv_pos; row b's first ``pads[b]`` slots
    are pads (-1) in both positions, the queries right-aligned to the
    keys.  dO is 0 on rows with no valid key."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    kv_pos = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    q_pos = np.tile(np.arange(Sq, dtype=np.int32) + (Sk - Sq), (B, 1))
    for b, p in enumerate(pads):
        kv_pos[b] -= p
        q_pos[b] -= p
    kv_pos[kv_pos < 0] = -1
    q_pos[q_pos < 0] = -1
    live = _live_rows(q_pos, kv_pos, causal, window)
    do[~live] = 0.0
    return q, k, v, do, q_pos, kv_pos, live


def _live_rows(q_pos, kv_pos, causal, window):
    qp, kp = q_pos[:, :, None], kv_pos[:, None, :]
    ok = np.broadcast_to(kp >= 0, qp.shape[:2] + kp.shape[2:]).copy()
    if causal:
        ok &= kp <= qp
    if window:
        ok &= qp - kp < window
    return ok.any(-1)                                    # [B, Sq]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_jax_grad(name):
    B, Sq, Sk, H, KV, hd, causal, window, cap, pads = CASES[name]
    q, k, v, do, qp, kp, live = _inputs(*CASES[name])

    def f(q_, k_, v_):
        o = jflash(q_, k_, v_, jnp.asarray(qp), jnp.asarray(kp),
                   causal=causal, window=window, softcap=cap, q_block=8,
                   kv_block=8)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = ops.flash_attention_bwd(_t(q), _t(k), _t(v), _t(qp), _t(kp),
                                  torch.empty(0), _t(do), torch.empty(0),
                                  causal=causal, window=window, softcap=cap)
    np.testing.assert_allclose(got[0].numpy()[live], np.asarray(want[0])[live],
                               rtol=0, atol=TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


# --------------------------------------- the CUDA source, emulated on CPU

# cuda_emu.h has no bf16: a stand-in (round to nearest even, as
# __float2bfloat16) and the rt helpers the source takes from common.cuh
_COMMON = """#include "cuda_emu.h"
#define RT_F32 0
#define RT_BF16 1
struct __nv_bfloat16 { uint16_t x; };
namespace rt {
inline float to_f32(float x) { return x; }
inline float to_f32(__nv_bfloat16 h) {
  uint32_t u = static_cast<uint32_t>(h.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
template <typename T> T from_f32(float x);
template <> inline float from_f32<float>(float x) { return x; }
template <> inline __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  u += 0x7fff + ((u >> 16) & 1);
  return __nv_bfloat16{static_cast<uint16_t>(u >> 16)};
}
inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
}  // namespace rt
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/flash_attention_bwd.cu compiled with g++ against
    tests/cuda_emu.h: its ctypes entry point."""
    from test_torch_topk_wide_plan import _emulated_source
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the CUDA source cannot be "
                    "emulated on the CPU")
    tmp = tmp_path_factory.mktemp("flash_bwd_emu")
    (tmp / "common.cuh").write_text(_COMMON)
    src = tmp / "flash_attention_bwd.cpp"
    src.write_text(_emulated_source(
        (build.CSRC / build.SOURCES["flash_attention_bwd"]).read_text()))
    lib = tmp / "libflash_attention_bwd.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread",
         "-Wno-unknown-pragmas", f"-I{tmp}",
         f"-I{build.CSRC.parents[3] / 'tests'}", "-o", str(lib), str(src)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    fn = ctypes.CDLL(str(lib)).flash_attention_bwd
    fn.argtypes = ops._SIGNATURES[("flash_attention_bwd",
                                   "flash_attention_bwd")]
    fn.restype = ctypes.c_int
    return fn


def _plain_lse(q, k, q_pos, kv_pos, causal, window, softcap):
    """The forward's row log-sum-exp [B,H,Sq] f32, by the plain route."""
    B, Sq, H, hd = q.shape
    kf = k.float().repeat_interleave(H // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), kf) / math.sqrt(hd)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qp, kp = q_pos[:, None, :, None], kv_pos[:, None, None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window:
        ok = ok & (qp - kp < window)
    s = torch.where(ok, s, torch.full_like(s, ref.NEG_INF))
    return torch.logsumexp(s, -1).contiguous()


EMU_CASES = {
    # shapes past one 32-row tile in both axes, hd off the padded width
    "gqa2-window-softcap": (2, 40, 45, 4, 2, 24, True, 16, 5.0, (3, 0)),
    "noncausal-hd8": (1, 20, 70, 2, 1, 8, False, None, None, (0,)),
    # past one 64-row tile (the bf16 kernels' dK/dV query tile and dQ
    # block): hd 128 with K/V and Q/dO held as fragments, hd 256 with the
    # dK/dV columns split between two warps and 32-key tiles
    "hd128-gqa2-window-leftpad": (2, 72, 72, 4, 2, 128, True, 40, None,
                                  (5, 0)),
    "hd256-gqa2-window-softcap-leftpad": (1, 68, 68, 2, 1, 256, True, 24,
                                          50.0, (3,)),
}


def _kernel_inputs(case, dtype):
    q, k, v, do, qp, kp, live = _inputs(*case)
    T = lambda a: _t(a).to(dtype).contiguous()
    return T(q), T(k), T(v), T(do), _t(qp), _t(kp), live


def _run_emulated(fn, case, q, k, v, do, qp, kp, out, lse):
    B, Sq, Sk, H, KV, hd, causal, window, cap, _ = case
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    rc = fn(P(q), P(k), P(v), P(qp), P(kp), P(out), P(do), P(lse), P(delta),
            P(dq), P(dk), P(dv), B, Sq, Sk, H, KV, hd, int(causal),
            int(window or 0), float(cap or 0.0),
            ops._DTYPE_CODE[q.dtype], None)
    assert rc == 0
    return dq, dk, dv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(EMU_CASES))
def test_cuda_source_emulated_matches_plain(emulated, name, dtype):
    case = EMU_CASES[name]
    causal, window, cap = case[6:9]
    q, k, v, do, qp, kp, live = _kernel_inputs(case, dtype)
    out = ref.flash_attention_ref(q, k, v, qp, kp, causal, window,
                                  cap).contiguous()
    lse = _plain_lse(q, k, qp, kp, causal, window, cap)
    got = _run_emulated(emulated, case, q, k, v, do, qp, kp, out, lse)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), qp,
                                       kp, do.float(), causal, window, cap)
    masks = (torch.from_numpy(live), None, None)
    for g, w, m in zip(got, want, masks):
        assert g.dtype == dtype
        g, w = g.float(), w.float()
        if m is not None:
            g, w = g[m], w[m]
        tol = TOL if dtype == torch.float32 else 2e-2 * float(w.abs().max())
        assert float((g - w).abs().max()) <= tol
    if dtype == torch.float32:   # no atomics: the same bits every call
        again = _run_emulated(emulated, case, q, k, v, do, qp, kp, out, lse)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


# 200 positions (4 query and key tiles of 64, the last of 8) under a
# window of 16: most tile pairs are dead; 7 tile flags of 32 positions,
# so the last tile's second flag lies past the row; hd 20 is not a
# multiple of 8, so the tiles load element by element
DEAD_CASE = (1, 200, 200, 2, 1, 20, True, 16, None, (0,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dead_tiles_skipped_are_exact(emulated, dtype):
    """Skipping the dead tiles drops no live pair: the gradients are the
    plain backward's within tolerance, and the same bits every call."""
    case = DEAD_CASE
    causal, window, cap = case[6:9]
    q, k, v, do, qp, kp, live = _kernel_inputs(case, dtype)
    out = ref.flash_attention_ref(q, k, v, qp, kp, causal, window,
                                  cap).contiguous()
    lse = _plain_lse(q, k, qp, kp, causal, window, cap)
    got = _run_emulated(emulated, case, q, k, v, do, qp, kp, out, lse)
    again = _run_emulated(emulated, case, q, k, v, do, qp, kp, out, lse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), qp,
                                       kp, do.float(), causal, window, cap)
    for g, w, m in zip(got, want, (torch.from_numpy(live), None, None)):
        g, w = g.float(), w.float()
        if m is not None:
            g, w = g[m], w[m]
        tol = TOL if dtype == torch.float32 else 2e-2 * float(w.abs().max())
        assert float((g - w).abs().max()) <= tol


@pytest.fixture
def kernel_route(emulated, monkeypatch):
    """``ops`` taking its CUDA branch on CPU tensors, the backward kernel
    emulated and the forward launch replaced by the plain route (which
    writes ``lse`` when asked); yields the forward's calls."""
    calls = []

    def flash_launch(q, k, v, q_pos, kv_pos, causal, window, softcap,
                     lse=None):
        calls.append(lse is not None)
        if lse is not None:
            lse.copy_(_plain_lse(q, k, q_pos, kv_pos, causal, window,
                                 softcap))
        return ref.flash_attention_ref(q, k, v, q_pos, kv_pos, causal,
                                       window, softcap).contiguous()

    monkeypatch.setattr(ops, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(ops, "_stream", lambda t: None)
    monkeypatch.setattr(ops, "_flash_launch", flash_launch)
    monkeypatch.setitem(ops._FNS, "flash_attention_bwd", emulated)
    return calls


def test_autograd_function_takes_the_kernels(kernel_route):
    case = EMU_CASES["gqa2-window-softcap"]
    causal, window, cap = case[6:9]
    q, k, v, do, qp, kp, live = _kernel_inputs(case, torch.float32)
    ops.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*leaves, qp, kp, causal=causal, window=window,
                              softcap=cap)
    got = torch.autograd.grad(out, leaves, do)
    want = ref.flash_attention_bwd_ref(q, k, v, qp, kp, do, causal, window,
                                       cap)
    np.testing.assert_allclose(got[0][live].numpy(), want[0][live].numpy(),
                               rtol=0, atol=TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=TOL)
    assert kernel_route == [True]
    assert ops.launches["flash_attention_bwd"] == 1
    # serving's calls: no grad, no lse, no backward
    with torch.no_grad():
        ops.flash_attention(*leaves, qp, kp, causal=causal, window=window,
                            softcap=cap)
    ops.flash_attention(q, k, v, qp, kp, causal=causal, window=window,
                        softcap=cap)
    assert kernel_route == [True, False, False]
    assert ops.launches["flash_attention_bwd"] == 1
    # the wrapper's checks hold on its CUDA branch
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(q, k, v, qp, kp, out.detach(), do,
                                torch.zeros(1))
    with pytest.raises(ValueError, match="head dim"):
        wide = torch.zeros(1, 4, 1, 264)
        p4 = torch.arange(4, dtype=torch.int32)[None]
        ops.flash_attention_bwd(wide, wide, wide, p4, p4, wide, wide,
                                torch.zeros(1, 1, 4))
