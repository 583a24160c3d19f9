"""The port's xLSTM cells (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) on the same inputs, at the xlstm-350m
smoke width (f32): the mLSTM step scan, the chunkwise mLSTM below, at
and above its 128-step chunk, the single decode steps, the sLSTM scan,
each from zero and from a carried state, with and without a pad mask;
and a left- or right-padded masked chunk ends in the unpadded chunk's
state.

Tolerance: f32 outputs and states (C/n/m, c/n/h/m) within atol 1e-5,
rtol 1e-4 (the same f32 arithmetic summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch.models import ssm  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
B = 2


@pytest.fixture(scope="module")
def cells():
    cfg = get_smoke_config("xlstm-350m", max_d_model=64)
    km, ks = jax.random.split(jax.random.PRNGKey(0))
    jp = {"mlstm": jssm.init_mlstm(km, cfg, jnp.float32),
          "slstm": jssm.init_slstm(ks, cfg, jnp.float32)}
    tp = {kind: {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
          for kind, p in jp.items()}
    return cfg, jp, tp


def _x(seed, S, d):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, d)).astype(np.float32)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _carried(cfg, jp, kind):
    """A state the reference reaches after 9 tokens: nonzero C, n, m."""
    fwd = jssm.mlstm_forward if kind == "mlstm" else jssm.slstm_forward
    _, st = fwd(jp[kind], jnp.asarray(_x(99, 9, cfg.d_model)), cfg)
    return st


def _mask(S):
    """Row 0 left-padded by 3, row 1 right-padded by 2 (a fork suffix)."""
    m = np.ones((B, S), bool)
    m[0, :3] = False
    m[1, S - 2:] = False
    return m


@pytest.mark.parametrize("carry", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_mlstm_scan_matches_reference(cells, carry, masked):
    cfg, jp, tp = cells
    x = _x(1, 12, cfg.d_model)
    st = _carried(cfg, jp, "mlstm") if carry else None
    mask = _mask(12) if masked else None
    want = jssm.mlstm_forward(jp["mlstm"], jnp.asarray(x), cfg, st,
                              mask=None if mask is None else jnp.asarray(mask))
    got = ssm.mlstm_forward(tp["mlstm"], torch.from_numpy(x), cfg,
                            None if st is None else _t(st),
                            mask=None if mask is None
                            else torch.from_numpy(mask))
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("S", [37, 128, 150], ids=["below", "at", "above"])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_mlstm_chunked_matches_reference(cells, S, masked):
    """Below, at and above the 128-step chunk, from a carried state; the
    chunked form also equals the step scan."""
    cfg, jp, tp = cells
    x = _x(2, S, cfg.d_model)
    st = _carried(cfg, jp, "mlstm")
    mask = _mask(S) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = jssm.mlstm_forward_chunked(jp["mlstm"], jnp.asarray(x), cfg, st,
                                      mask=jm)
    got = ssm.mlstm_forward_chunked(tp["mlstm"], torch.from_numpy(x), cfg,
                                    _t(st), mask=tm)
    _close(got[0], want[0])
    _close(got[1], want[1])
    scan = ssm.mlstm_forward(tp["mlstm"], torch.from_numpy(x), cfg, _t(st),
                             mask=tm)
    _close(got[0], scan[0].numpy())
    _close(got[1], {k: v.numpy() for k, v in scan[1].items()})


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_match_reference(cells, kind):
    cfg, jp, tp = cells
    jstep = jssm.mlstm_step if kind == "mlstm" else jssm.slstm_step
    tstep = ssm.mlstm_step if kind == "mlstm" else ssm.slstm_step
    jst = _carried(cfg, jp, kind)
    tst = _t(jst)
    x = _x(3, 4, cfg.d_model)
    for t in range(4):
        jy, jst = jstep(jp[kind], jnp.asarray(x[:, t:t + 1]), cfg, jst)
        ty, tst = tstep(tp[kind], torch.from_numpy(x[:, t:t + 1]), cfg, tst)
        _close(ty, jy)
        _close(tst, jst)


@pytest.mark.parametrize("carry", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_slstm_scan_matches_reference(cells, carry, masked):
    cfg, jp, tp = cells
    x = _x(4, 20, cfg.d_model)
    st = _carried(cfg, jp, "slstm") if carry else None
    mask = _mask(20) if masked else None
    want = jssm.slstm_forward(jp["slstm"], jnp.asarray(x), cfg, st,
                              mask=None if mask is None else jnp.asarray(mask))
    got = ssm.slstm_forward(tp["slstm"], torch.from_numpy(x), cfg,
                            None if st is None else _t(st),
                            mask=None if mask is None
                            else torch.from_numpy(mask))
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("side", ["left", "right"])
def test_padded_chunk_ends_in_unpadded_state(cells, kind, side):
    """Padding a chunk (masked) leaves the carried state where the real
    tokens alone take it, and the real tokens' outputs unchanged."""
    cfg, jp, tp = cells
    fwd = ssm.mlstm_forward_chunked if kind == "mlstm" \
        else ssm.slstm_forward
    st = _t(_carried(cfg, jp, kind))
    x = _x(5, 11, cfg.d_model)
    pad = np.zeros((B, 5, cfg.d_model), np.float32) + 0.7   # not zeros
    xp = np.concatenate([pad, x] if side == "left" else [x, pad], axis=1)
    real = slice(5, 16) if side == "left" else slice(0, 11)
    mask = np.zeros((B, 16), bool)
    mask[:, real] = True
    y, s = fwd(tp[kind], torch.from_numpy(x), cfg,
               {k: v.clone() for k, v in st.items()})
    yp, sp = fwd(tp[kind], torch.from_numpy(xp), cfg,
                 {k: v.clone() for k, v in st.items()},
                 mask=torch.from_numpy(mask))
    _close(sp, {k: v.numpy() for k, v in s.items()})
    _close(yp[:, real], y.numpy())
