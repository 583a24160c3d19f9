"""The port's training pieces against the reference on the CPU:

  * ``adamw_update`` over 3 steps, with the global-norm clip active and
    inactive, on a tree of f32 leaves and one bf16 leaf, under a cosine
    schedule: params, moments and step count (f32: 1e-6 absolute, the
    clip's norm summed over leaves in another order; the bf16 leaf
    exactly, both casts round to nearest even);
  * ``cosine_schedule`` at warmup, middle and end (1e-7 relative);
  * ``cross_entropy`` and ``fused_cross_entropy`` against the reference's
    (the latter its custom VJP): loss, dx and dhead with and without
    softcap and mask, at S 300 so the padded last chunk runs (1e-5:
    f32 products summed in another order);
  * microbatch 2 against microbatch 1 (the reference's test);
  * checkpoints both ways: a file the port writes loads through the
    reference's ``load`` and the reverse, with equal logits (1e-4);
  * ``launch.train.main`` and ``launch.train_tiny.main`` at small sizes
    on ``--device cpu``: finite losses, their files load back.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.launch import train, train_tiny  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import checkpoint, optimizer  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(rng, scale):
    """(numpy params, numpy grads): a nested dict with a list, in sorted
    key order (the reference flattens dicts sorted)."""
    shapes = {"a": [(4, 3), (5,)], "b": {"c": (2, 2, 3)}}
    mk = lambda s: rng.standard_normal(s).astype(np.float32)
    params = {"a": [mk(s) for s in shapes["a"]], "b": {"c": mk((2, 2, 3))}}
    grads = {"a": [mk(s) * scale for s in shapes["a"]],
             "b": {"c": mk((2, 2, 3)) * scale}}
    return params, grads


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["no-clip", "clip"])
def test_adamw_matches_reference(scale):
    rng = np.random.default_rng(0)
    np_p, _ = _tree(rng, scale)
    grads = [_tree(rng, scale)[1] for _ in range(3)]
    lr_j = jopt.cosine_schedule(1e-2, warmup=2, total=6)
    lr_t = optimizer.cosine_schedule(1e-2, warmup=2, total=6)
    bf = rng.standard_normal((3, 4)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, np_p)
    jp["bf"] = jnp.asarray(bf).astype(jnp.bfloat16)
    tp = optimizer.tree_map(_t, np_p)
    tp["bf"] = _t(bf).to(torch.bfloat16)
    js, tst = jopt.adamw_init(jp), optimizer.adamw_init(tp)
    for g in grads:
        gb = rng.standard_normal((3, 4)).astype(np.float32) * scale
        jg = dict(jax.tree.map(jnp.asarray, g), bf=jnp.asarray(gb))
        tg = dict(optimizer.tree_map(_t, g), bf=_t(gb))
        jp, js = jopt.adamw_update(jg, js, jp, lr=lr_j)
        tp, tst = optimizer.adamw_update(tg, tst, tp, lr=lr_t)
    assert int(tst.step) == int(js.step) == 3
    for jtree, ttree in ((jp, tp), (js.mu, tst.mu), (js.nu, tst.nu)):
        for a, b in zip(jax.tree.leaves(jtree), optimizer.tree_leaves(ttree)):
            np.testing.assert_allclose(b.float().numpy(),
                                       np.asarray(a, np.float32), rtol=0,
                                       atol=1e-6)
    assert tp["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["bf"].float().numpy(),
                                  np.asarray(jp["bf"], np.float32))


def test_cosine_schedule_matches_reference():
    jl = jopt.cosine_schedule(3e-3, warmup=20, total=300)
    tl = optimizer.cosine_schedule(3e-3, warmup=20, total=300)
    for step in (0, 1, 10, 19, 20, 21, 160, 299, 300, 400):
        want = float(jl(jnp.asarray(step, jnp.int32)))
        got = float(tl(torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-7, abs=0), step


def _ce_inputs(S=300, V=50, D=16, B=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    head = (rng.standard_normal((D, V)) * 0.5).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.int32)
    return x, head, labels, mask


@pytest.mark.parametrize("masked", [False, True], ids=["all", "mask"])
def test_cross_entropy_matches_reference(masked):
    x, head, labels, mask = _ce_inputs()
    logits = x @ head
    m = mask if masked else None
    want = jts.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                             None if m is None else jnp.asarray(m))
    got = ts.cross_entropy(_t(logits), _t(labels),
                           None if m is None else _t(m))
    assert float(got) == pytest.approx(float(want), abs=1e-5)


@pytest.mark.parametrize("softcap", [None, 30.0], ids=["plain", "softcap"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "mask"])
def test_fused_cross_entropy_matches_reference(softcap, masked):
    x, head, labels, mask = _ce_inputs()
    if not masked:
        mask = np.ones_like(mask)
    jfn = lambda xx, hh: jts.fused_cross_entropy(
        xx, hh, jnp.asarray(labels), jnp.asarray(mask), softcap)
    want, (jdx, jdh) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    tx = _t(x).requires_grad_(True)
    th = _t(head).requires_grad_(True)
    got = ts.fused_cross_entropy(tx, th, _t(labels), _t(mask), softcap)
    dx, dh = torch.autograd.grad(got, (tx, th))
    assert float(got.detach()) == pytest.approx(float(want), abs=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), rtol=0,
                               atol=1e-5)
    # and the plain cross entropy of the same logits, by autograd
    logits = tx @ th
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    plain = ts.cross_entropy(logits, _t(labels), _t(mask))
    assert float(plain.detach()) == pytest.approx(float(got.detach()),
                                                  abs=1e-5)


def _olmo(vocab=96, **kw):
    cfg = get_smoke_config("olmo-1b", max_d_model=64, vocab=vocab, **kw)
    jm = JModel(cfg)
    jparams = jm.init_params(jax.random.PRNGKey(0), max_seq=64)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                      device="cpu")
    return cfg, jm, jparams, params


def _batch(cfg, B=4, S=8, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int64)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return {"tokens": _t(toks[:, :-1]), "labels": _t(toks[:, 1:]),
            "positions": _t(pos)}


def test_microbatch_equals_full_batch():
    cfg, _, _, params = _olmo()
    model = Model(cfg)
    batch = _batch(cfg)
    opt = ts.init_opt_state(params)
    p1, _, m1 = ts.make_train_step(model, lr=1e-3, remat=False)(
        params, opt, batch)
    p2, _, m2 = ts.make_train_step(model, lr=1e-3, remat=False,
                                   microbatch=2)(params, opt, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), abs=1e-5)
    err = max(float((a - b).abs().max()) for a, b in zip(
        optimizer.tree_leaves(p1), optimizer.tree_leaves(p2)))
    assert err < 1e-3     # the reference's bound (reassociation via Adam)
    with pytest.raises(ValueError, match="microbatch"):
        ts.make_train_step(model, microbatch=3)(params, opt, batch)


def _logits_both(cfg, jm, jparams, params, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    want, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks),
                                   "positions": jnp.asarray(pos)})
    got = Model(cfg).forward(params, _t(toks), _t(pos))
    return got.detach().numpy(), np.asarray(want)


def test_checkpoint_port_to_reference(tmp_path):
    cfg, jm, jparams, params = _olmo()
    # train a step so the weights are not the reference's draw
    params, _, _ = ts.make_train_step(Model(cfg), lr=1e-2, remat=False)(
        params, ts.init_opt_state(params), _batch(cfg))
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, params, cfg)
    restored = jckpt.load(path, jparams)
    got, want = _logits_both(cfg, jm, restored, params)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_checkpoint_reference_to_port(tmp_path):
    cfg, jm, jparams, params = _olmo()
    jparams = jax.tree.map(lambda a: a * 1.5, jparams)
    path = str(tmp_path / "ref.npz")
    jckpt.save(path, jparams)
    restored = checkpoint.load(path, params, cfg)
    assert [t.dtype for t in optimizer.tree_leaves(restored)] == \
        [t.dtype for t in optimizer.tree_leaves(params)]
    got, want = _logits_both(cfg, jm, jparams, restored)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # a bf16 model reads the same file, each leaf cast to bf16
    like = optimizer.tree_map(lambda a: a.to(torch.bfloat16), params)
    bf = checkpoint.load(path, like, cfg)
    np.testing.assert_array_equal(
        bf["embed"].float().numpy(),
        torch.from_numpy(np.array(jparams["embed"])).to(
            torch.bfloat16).float().numpy())
    # a bf16 model's file (numpy reads its 2-byte bf16 leaves as raw
    # records) loads bit for bit
    jbf = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    jckpt.save(str(tmp_path / "bf.npz"), jbf)
    bf = checkpoint.load(str(tmp_path / "bf.npz"), like, cfg)
    for a, b in zip(optimizer.tree_leaves(bf), optimizer.tree_leaves(
            bridge.params_from_numpy(jax.tree.map(np.asarray, jbf), cfg,
                                     device="cpu"))):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    # shapes are checked
    other = bridge.params_from_numpy(jax.tree.map(np.asarray, JModel(
        get_smoke_config("olmo-1b", max_d_model=32, vocab=96)).init_params(
        jax.random.PRNGKey(0))), get_smoke_config(
        "olmo-1b", max_d_model=32, vocab=96), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load(path, other, cfg)


def test_train_main_runs_on_cpu(tmp_path, capsys):
    path = str(tmp_path / "t.npz")
    out = train.main(["--arch", "olmo-1b", "--smoke", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--device", "cpu",
                      "--ckpt", path])
    text = capsys.readouterr().out
    assert "step    0  loss" in text and "step    2  loss" in text
    assert "tokens/s" in text and f"saved {path}" in text
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    back = checkpoint.load(path, out["params"], out["cfg"])
    for a, b in zip(optimizer.tree_leaves(back),
                    optimizer.tree_leaves(out["params"])):
        assert torch.equal(a, b)


def test_train_tiny_main_runs_on_cpu(tmp_path):
    path = str(tmp_path / "tiny.npz")
    out = train_tiny.main(["--steps", "2", "--batch", "2", "--out", path,
                           "--device", "cpu"])
    assert np.isfinite([l for _, l in out["losses"]]).all()
    with open(str(tmp_path / "tiny_vocab.json")) as f:
        vocab = json.load(f)
    assert len(vocab) == out["cfg"].vocab_size
    like = Model(out["cfg"]).init_params(seed=1, device="cpu",
                                         max_seq=train_tiny.SEQ)
    checkpoint.load(path, like, out["cfg"])
