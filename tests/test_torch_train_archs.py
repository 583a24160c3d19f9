"""The port's train step on every architecture, on the CPU.

  * Loss, auxiliary (MoE load-balance) loss and every gradient leaf of
    ``make_loss_fn`` (the fused cross-entropy path) against the
    reference's ``jax.value_and_grad(make_loss_fn(...))`` on bridged f32
    smoke weights, for olmo-1b (dense attention), gemma2-9b (the rolling
    "local" kind, both softcaps, GeGLU), qwen2-moe-a2.7b (routed experts
    with drops at capacity factor 1.25, the shared expert, the aux loss)
    and xlstm-350m (mLSTM and sLSTM).  Losses within 1e-5; gradients
    within 1e-4 of the leaf's largest magnitude (at least 1e-6): f32
    products and scans summed in another order.  The same checks with
    ``remat`` (per-layer checkpointing).
  * One port step of all ten archs at their smoke configs (whisper-base
    with encoder frames, qwen2-vl-72b with a vision prefix and [3, B, S]
    positions): a finite loss, an aux loss >= 0 and parameters that move.
  * The loss falls over 6 steps on one batch for the reference's five
    ``test_loss_decreases`` archs (tests/test_arch_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.train import train_step as jts  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4
PARITY = ("olmo-1b", "gemma2-9b", "qwen2-moe-a2.7b", "xlstm-350m")
# gemma2's window shrunk under the sequence, so the "local" layers mask
PARITY_KW = {"gemma2-9b": {}, "xlstm-350m": {"num_layers": 4}}


def _np_batch(cfg, B=2, S=16, seed=0):
    """The reference's ``_batch`` made with numpy: tokens, labels,
    positions ([3, B, Nv+S] with a vision prefix), vision embeds or
    encoder frames where the arch takes them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.use_mrope:
        St = S + cfg.num_vision_tokens
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
        batch["positions"] = np.broadcast_to(
            np.arange(St, dtype=np.int32), (3, B, St)).copy()
    else:
        batch["positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (B, S)).copy()
    if cfg.is_encoder_decoder:
        batch["encoder_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=PARITY)
def parity(request):
    """(cfg, reference (loss, aux, grads) from one jitted value_and_grad,
    port params, batch) for one arch."""
    arch = request.param
    kw = dict(max_d_model=64, vocab=96, **PARITY_KW.get(arch, {}))
    cfg = get_smoke_config(arch, **kw)
    if arch == "gemma2-9b":
        import dataclasses
        cfg = dataclasses.replace(cfg, sliding_window=6)
    jm = JModel(cfg)
    jparams = jm.init_params(jax.random.PRNGKey(0), max_seq=64)
    batch = _np_batch(cfg)
    if arch == "olmo-1b":    # a loss mask, as train_tiny's batches carry
        batch["loss_mask"] = (np.random.default_rng(1).random(
            batch["labels"].shape) < 0.6).astype(np.int32)
    vg = jax.jit(jax.value_and_grad(jts.make_loss_fn(jm, remat=False),
                                    has_aux=True))
    (total, (loss, aux)), grads = vg(jparams,
                                     jax.tree.map(jnp.asarray, batch))
    want = (float(total), float(loss), float(aux),
            jax.tree.map(np.asarray, grads))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                      device="cpu")
    return cfg, want, params, batch


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_aux_and_grads_match_reference(parity, remat):
    cfg, (total, loss, aux, jgrads), params, batch = parity
    loss_fn = ts.make_loss_fn(Model(cfg), remat=remat)
    (t, (l, a)), grads = ts.value_and_grad(loss_fn, params,
                                           _torch_batch(batch))
    assert float(l) == pytest.approx(loss, abs=LOSS_TOL)
    assert float(a) == pytest.approx(aux, abs=LOSS_TOL)
    assert float(t) == pytest.approx(total, abs=LOSS_TOL)
    if cfg.moe is not None:
        assert aux > 0
    ours = jax.tree_util.tree_leaves_with_path(
        bridge.params_to_numpy(grads, cfg))
    theirs = jax.tree_util.tree_leaves_with_path(jgrads)
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, g), (_, w) in zip(ours, theirs):
        w = np.asarray(w, np.float32)
        tol = max(1e-6, GRAD_RTOL * float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def _step(arch, steps=1, lr=1e-3):
    cfg = port_smoke(arch)
    model = Model(cfg)
    params = model.init_params(seed=0, device="cpu", max_seq=64)
    batch = _torch_batch(_np_batch(cfg))
    step = ts.make_train_step(model, lr=lr, remat=False)
    opt = ts.init_opt_state(params)
    p, metrics = params, []
    for _ in range(steps):
        p, opt, m = step(p, opt, batch)
        metrics.append(m)
    return params, p, metrics, opt


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_takes_a_train_step(arch):
    before, after, (m,), opt = _step(arch)
    assert np.isfinite(float(m["loss"])) and float(m["aux_loss"]) >= 0.0
    assert float(m["total_loss"]) == pytest.approx(
        float(m["loss"]) + float(m["aux_loss"]), abs=1e-6)
    assert int(opt.step) == 1
    moved = max(float((a.float() - b.float()).abs().max()) for a, b in zip(
        optimizer.tree_leaves(before), optimizer.tree_leaves(after)))
    assert moved > 0


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-9b", "xlstm-350m",
                                  "qwen2-moe-a2.7b", "whisper-base"])
def test_loss_decreases(arch):
    _, _, metrics, _ = _step(arch, steps=6, lr=3e-3)
    losses = [float(m["loss"]) for m in metrics]
    assert losses[-1] < losses[0], losses
