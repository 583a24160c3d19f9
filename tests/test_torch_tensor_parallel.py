"""The sharded program (``repro_torch.distributed.tensor_parallel``:
tensor parallelism over `model`, FSDP over `data`) of all ten archs on
gloo process groups on the CPU, held to the reference's one-device
program and to the port's one-process one.

One ``torch.multiprocessing.spawn`` per world size (2 and 4 ranks, each
on one torch thread, meeting through a ``FileStore`` under the test's
tmp dir) runs every case of ``_torch_tp_worker.checks``; the reference's
side and the one-process port run here.  Smoke configs in f32
(d_model 64, vocab 96): olmo-1b, gemma2-9b (the "local" kind, both
softcaps, the tied head) and qwen2-vl-72b (M-RoPE, the vision prefix),
and "kv2", llama3-8b's smoke config ``dataclasses.replace``d on both
sides to 2 KV heads for 4 query heads, which on a `model` axis of 4
leaves ``wk`` / ``wv`` whole on every rank (no smoke config reaches that
path: all have 4 KV heads); "kv2-local", gemma2-9b's the same way with a
1032-token window, whose rolling buffer is split by sequence over
`model` and wraps.  The other five archs' smoke configs (qwen2-moe-a2.7b
and qwen3-moe-30b-a3b: experts by FFN column, under EP at inference
where they divide `model`; hymba-1.5b: Mamba channels, its rolling
buffer also split by sequence over `data`; xlstm-350m: mLSTM heads and
sLSTM units; whisper-base: encoder, cross-attention, learned positions)
on (1, 2), (2, 2) and (2, 1) with FSDP, and variants of the production
layouts no smoke config reaches, on (1, 4): hymba with 5 heads over 1
KV head and vocab 97 (attention and vocab whole), xlstm with 2 heads
(the cells whole beside a cut sLSTM), qwen2-moe with 6 experts (FFN
columns at inference; on (1, 2) under EP), whisper with 2 heads and
vocab 97, and qwen3-moe without the load-balance loss (the router's
gradient from the cross-entropy alone).

  * one train step with remat on meshes (data 1, model 2), (2, 2) and
    (2, 1) with FSDP forced (and (2, 2) with FSDP, (1, 4) for kv2): the
    loss within 1e-5 and the updated params (gathered) within 1e-4 of
    their largest magnitude, against the reference's one-device step
    and the port's one-process step.  AdamW's first step moves a param
    by about lr * sign(g), whatever the gradient's scale, so the
    gradient is held apart: the first moments (gathered; 0.1 x the
    clipped gradient) within 1e-5 of each leaf's largest magnitude, the
    clip active in every case (the reference's gradient norm above 1,
    the moments' global norm 0.1 within 1e-5), and the gradient the
    step hands AdamW (``sync_grads`` of the rank's batch shard's,
    gathered) and its squared norm (``grad_sq_norm``) within 1e-5 of
    the reference's unclipped ones;
  * every rank's local shapes (params and AdamW moments; the inference
    cut with the reference's ``moe_ep``) equal the reference's
    ``param_specs`` local shapes, and a gathered tree equals the whole;
  * prefill logits within 1e-5 and greedy decode tokens equal, each
    data rank on its rows, and every rank's cache its part of the
    one-process cache within 1e-5 (K/V, rolling and cross-attention
    buffers by its slots and KV heads, recurrent state whole); kv2
    over a 1040-slot cache split by sequence
    over `model` (a 270-token prompt crosses into the second chunk),
    kv2-local over 1060 tokens (its buffer wraps in prefill), and kv2's
    long_500k layout (``shard_seq``: the sequence over `data`);
  * ``init_params`` under ``tp`` keeps the whole draw's shards;
  * ``launch.train --production-mesh`` of olmo-1b over a (1, world)
    stand-in of the 16x16 mesh runs the sharded step: the one-process
    launcher's losses, and with ``--ckpt`` its parameters, gathered to
    rank 0 alone; without ``--ckpt`` nothing is gathered and every rank
    returns its shards.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

import _torch_tp_worker  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.train import train_step as jts  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed import tensor_parallel as tpl  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.model import _shard_runs  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train.optimizer import tree_leaves, tree_map  # noqa: E402

SMOKE = dict(max_d_model=64, vocab=96)


def _moe(**kw):
    return lambda cfg: dataclasses.replace(cfg.moe, **kw)


# name -> (arch, fields replaced on both sides; a callable gets the config)
CASES = {"olmo": ("olmo-1b", {}), "gemma2": ("gemma2-9b", {}),
         "qwen2vl": ("qwen2-vl-72b", {}),
         "kv2": ("llama3-8b", {"num_kv_heads": 2}),
         "kv2-local": ("gemma2-9b", {"num_kv_heads": 2,
                                     "sliding_window": 1032}),
         "qwen2moe": ("qwen2-moe-a2.7b", {}),
         "qwen3moe": ("qwen3-moe-30b-a3b", {}),
         "hymba": ("hymba-1.5b", {}), "xlstm": ("xlstm-350m", {}),
         "whisper": ("whisper-base", {}),
         # the production layouts no smoke config reaches: hymba's
         # attention and vocab whole, xlstm's cells whole beside a cut
         # sLSTM, qwen2-moe's experts by FFN column at inference (6 on
         # `model` 4) and under EP (on 2), whisper's attention and vocab
         # whole; the router's gradient without the load-balance loss
         "hymba-h5": ("hymba-1.5b", {"num_heads": 5, "num_kv_heads": 1,
                                     "vocab_size": 97}),
         "xlstm-h2": ("xlstm-350m", {"num_heads": 2, "num_kv_heads": 2}),
         "qwen2moe-e6": ("qwen2-moe-a2.7b", {"moe": _moe(num_experts=6)}),
         "whisper-h2": ("whisper-base", {"num_heads": 2, "num_kv_heads": 2,
                                         "vocab_size": 97}),
         "qwen3moe-aux0": ("qwen3-moe-30b-a3b",
                           {"moe": _moe(router_aux_loss_coef=0.0)})}
# (prompt tokens, cache slots, greedy steps, first of each row)
PROMPTS = {"olmo": (12, 48, 6, (0, 3)), "gemma2": (20, 48, 6, (0, 3)),
           "qwen2vl": (12, 48, 6, (0, 0)), "kv2": (270, 1040, 6, (0, 3)),
           "kv2-local": (1060, 1100, 6, (0, 3)),
           "hymba": (20, 48, 6, (0, 3)), "hymba-h5": (20, 48, 6, (0, 3))}
TRAIN, INFER = {"train": True, "infer": False}, {"train": False,
                                                 "infer": True}
BOTH = {"train": True, "infer": True}
NEW = ("qwen2moe", "qwen3moe", "hymba", "xlstm", "whisper")
RUNS = {("olmo", (1, 2), False): BOTH, ("gemma2", (1, 2), False): BOTH,
        ("qwen2vl", (1, 2), False): BOTH, ("olmo", (2, 1), True): BOTH,
        ("gemma2", (2, 1), True): TRAIN, ("qwen2vl", (2, 1), True): BOTH,
        ("olmo", (2, 2), False): BOTH, ("gemma2", (2, 2), False): BOTH,
        ("qwen2vl", (2, 2), True): BOTH, ("kv2", (1, 4), False): BOTH,
        ("kv2-local", (1, 4), False): INFER,
        ("kv2", (2, 2), False): dict(INFER, shard_seq=True),
        **{(n, (1, 2), False): BOTH for n in NEW},
        **{(n, (2, 2), False): BOTH for n in NEW},
        **{(n, (2, 1), True): BOTH for n in NEW},
        ("hymba-h5", (1, 4), False): BOTH, ("xlstm-h2", (1, 4), False): BOTH,
        ("qwen2moe-e6", (1, 4), False): BOTH,
        ("qwen2moe-e6", (1, 2), False): INFER,
        ("whisper-h2", (1, 4), False): BOTH,
        ("qwen3moe-aux0", (1, 2), False): TRAIN,
        # hymba's rolling buffer split by sequence over `data`
        ("hymba", (2, 2), True): dict(INFER, shard_seq=True)}
WORLDS = (2, 4)
LR = 1e-3
LOSS_TOL, PARAM_RTOL, LOGIT_TOL = 1e-5, 1e-4, 1e-5
GRAD_RTOL = 1e-5          # first moments, gradients, the squared norm
B1 = 0.9                  # AdamW's: mu = (1 - B1) g after one step
LAUNCH = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--steps", "2",
          "--batch", "4", "--seq", "16"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(name):
    arch, kw = CASES[name]

    def one(cfg):
        return dataclasses.replace(cfg, **{k: v(cfg) if callable(v) else v
                                           for k, v in kw.items()})
    return (one(get_smoke_config(arch, **SMOKE)),
            one(port_smoke(arch, **SMOKE)))


def _frames(rng, cfg, B):
    """Stub encoder frames [B, Se, D] of an encoder-decoder config."""
    return rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model)
                               ).astype(np.float32)


def _train_batch(cfg):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.use_mrope:
        St = 16 + cfg.num_vision_tokens
        b["vision_embeds"] = rng.standard_normal(
            (4, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
        b["positions"] = np.broadcast_to(np.arange(St, dtype=np.int32),
                                         (3, 4, St)).copy()
    else:
        b["positions"] = np.broadcast_to(np.arange(16, dtype=np.int32),
                                         (4, 16)).copy()
    if cfg.is_encoder_decoder:
        b["encoder_frames"] = _frames(rng, cfg, 4)
    return b


def _prompt(cfg, name):
    L, max_len, steps, first = PROMPTS.get(name, (12, 48, 6, (0, 3)))
    rng = np.random.default_rng(7)
    first = np.asarray(first, np.int32)
    p = {"tokens": rng.integers(0, cfg.vocab_size, (2, L)).astype(np.int32)}
    if cfg.use_mrope:
        St = cfg.num_vision_tokens + L
        p["vision_embeds"] = rng.standard_normal(
            (2, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
        p["positions"] = np.broadcast_to(np.arange(St, dtype=np.int32),
                                         (3, 2, St)).copy()
    else:
        p["positions"] = np.where(np.arange(L)[None] >= first[:, None],
                                  np.arange(L)[None], -1).astype(np.int32)
    if cfg.is_encoder_decoder:
        p["encoder_frames"] = _frames(rng, cfg, 2)
    return p, first, max_len, steps


def _ref_infer(jm, jparams, prompt, first, max_len, steps):
    c = jm.init_cache(2, max_len, jnp.float32)
    c["first"] = jnp.asarray(first)
    logits, c = jm.prefill(jparams, jax.tree.map(jnp.asarray, prompt), c)
    step = jax.jit(jm.decode_step)
    tok, toks = jnp.argmax(logits, -1)[:, None].astype(jnp.int32), []
    for _ in range(steps):
        toks.append(np.asarray(tok))
        lg, c = step(jparams, tok, c)
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
    return np.asarray(logits), np.concatenate(toks, axis=1)


def _port_infer(cfg, params, prompt, first, max_len, steps):
    case = {"prompt": {k: _t(v) for k, v in prompt.items()},
            "first": _t(first), "max_len": max_len, "steps": steps}
    lg, toks, cache = _torch_tp_worker.infer(Model(cfg), params, case,
                                             (0, 1), False)
    return lg.numpy(), toks.numpy(), cache


@pytest.fixture(scope="module")
def reference():
    """Per case: configs, params (both layouts), the reference's and the
    one-process port's train step and prefill + greedy decode."""
    names = {n for n, _, _ in RUNS}
    out = {}
    for name in sorted(names):
        jcfg, cfg = _cfgs(name)
        jm = JModel(jcfg)
        jparams = jm.init_params(jax.random.PRNGKey(0), max_seq=64)
        params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          cfg, device="cpu")
        r = dict(jcfg=jcfg, cfg=cfg, params=params,
                 jshape=jax.eval_shape(lambda: jparams))
        if any(k[0] == name and v["train"] for k, v in RUNS.items()):
            batch = _train_batch(cfg)
            step = jax.jit(jts.make_train_step(jm, lr=LR, remat=True))
            jb = jax.tree.map(jnp.asarray, batch)
            p, jopt, m = step(jparams, jts.init_opt_state(jparams), jb)
            r["jloss"] = float(m["loss"])
            r["jfinal"] = [np.asarray(a, np.float32)
                           for a in jax.tree.leaves(p)]
            r["jmu"] = [np.asarray(a) for a in jax.tree.leaves(jopt.mu)]
            _, g = jax.jit(jax.value_and_grad(
                jts.make_loss_fn(jm, remat=True), has_aux=True))(jparams, jb)
            r["jgrads"] = [np.asarray(a) for a in jax.tree.leaves(g)]
            r["jsq"] = float(sum(np.sum(np.square(a, dtype=np.float64))
                                 for a in r["jgrads"]))
            tb = {k: _t(v) for k, v in batch.items()}
            pstep = ts.make_train_step(Model(cfg), lr=LR, remat=True)
            pp, popt, pm = pstep(params, ts.init_opt_state(params), tb)
            r["ploss"], r["pfinal"] = float(pm["loss"]), tree_leaves(pp)
            r["pmu"] = tree_leaves(popt.mu)
            r["batch"] = tb
        if any(k[0] == name and v["infer"] for k, v in RUNS.items()):
            prompt, first, max_len, steps = _prompt(cfg, name)
            r["jinfer"] = _ref_infer(jm, jparams, prompt, first, max_len,
                                     steps)
            r["pinfer"] = _port_infer(cfg, params, prompt, first, max_len,
                                      steps)
            r["prompt"] = {"prompt": {k: _t(v) for k, v in prompt.items()},
                           "first": _t(first), "max_len": max_len,
                           "steps": steps, "cache": r["pinfer"][2]}
        out[name] = r
    from repro_torch.launch import train
    out["launcher"] = train.main(LAUNCH)
    return out


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    """{world: every rank's results}, one spawn a world."""
    import torch.multiprocessing as mp
    cases = {}
    for name, r in reference.items():
        if name == "launcher":
            continue
        c = {"cfg": r["cfg"], "params": r["params"]}
        c["batch"] = r.get("batch")
        c.update(r.get("prompt", {}))
        cases[name] = c
    out = {}
    for w in WORLDS:
        d = tmp_path_factory.mktemp(f"tp{w}")
        torch.save({"cases": cases, "runs": RUNS, "lr": LR,
                    "launch_args": LAUNCH, "tmp": str(d)}, d / "inputs.pt")
        mp.spawn(_torch_tp_worker.run,
                 args=(w, str(d / "store"), str(d / "inputs.pt"), str(d)),
                 nprocs=w, join=True)
        out[w] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                  for r in range(w)]
        out[(w, "ckpt")] = d / f"tp{w}.npz"
    return out


def _ranks(worlds, key):
    w = key[1][0] * key[1][1]
    return [o[key] for o in worlds[w]]


def _ids(keys):
    return [f"{n}-{s[0]}x{s[1]}" + ("-fsdp" if f else "") for n, s, f in keys]


TRAIN_KEYS = [k for k, v in RUNS.items() if v["train"]]
INFER_KEYS = [k for k, v in RUNS.items() if v["infer"]]


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


@pytest.mark.parametrize("key", TRAIN_KEYS, ids=_ids(TRAIN_KEYS))
def test_sharded_train_step_matches_one_device(key, reference, worlds):
    r = reference[key[0]]
    theirs = r["jfinal"]
    mine = jax.tree.leaves(bridge.params_to_numpy(
        _unflatten(r["params"], r["pfinal"]), r["cfg"]))
    for res in _ranks(worlds, key):
        assert res["loss"] == pytest.approx(r["jloss"], abs=LOSS_TOL)
        assert res["loss"] == pytest.approx(r["ploss"], abs=LOSS_TOL)
        ours = jax.tree.leaves(bridge.params_to_numpy(
            _unflatten(r["params"], res["params"]), r["cfg"]))
        assert len(ours) == len(theirs) == len(mine)
        for g, j, p in zip(ours, theirs, mine):
            tol = PARAM_RTOL * max(1.0, float(np.abs(j).max()))
            np.testing.assert_allclose(g, j, rtol=0, atol=tol)
            np.testing.assert_allclose(g, p, rtol=0, atol=tol)


def _as_reference(r, leaves):
    """Port leaves of ``r``'s param tree, in the reference's layout and
    leaf order."""
    return jax.tree.leaves(bridge.params_to_numpy(
        _unflatten(r["params"], leaves), r["cfg"]))


def _close(got, want, rtol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rtol * float(np.abs(w).max()))


@pytest.mark.parametrize("key", TRAIN_KEYS, ids=_ids(TRAIN_KEYS))
def test_sharded_first_moments_match_one_device(key, reference, worlds):
    """The first moments carry the clipped gradient: with the clip
    active (the reference's gradient norm above 1) their global norm is
    (1 - B1) exactly, so a wrong ``grad_sq_norm`` moves every leaf."""
    r = reference[key[0]]
    assert r["jsq"] > 1.0
    mine = _as_reference(r, r["pmu"])
    for res in _ranks(worlds, key):
        ours = _as_reference(r, res["mu"])
        assert len(ours) == len(r["jmu"]) == len(mine)
        _close(ours, r["jmu"], GRAD_RTOL)
        _close(ours, mine, GRAD_RTOL)
        norm = np.sqrt(sum(np.sum(np.square(a, dtype=np.float64))
                           for a in ours))
        assert norm == pytest.approx(1 - B1, rel=GRAD_RTOL)


@pytest.mark.parametrize("key", TRAIN_KEYS, ids=_ids(TRAIN_KEYS))
def test_sharded_gradient_and_norm_match_one_device(key, reference, worlds):
    """The gradient ``sync_grads`` completes from the rank's batch shard
    (gathered) and ``grad_sq_norm`` of its shards, before the clip: the
    reference's unclipped gradient and squared global norm, so a scale
    error in either shows though the clip would hide it."""
    r = reference[key[0]]
    for res in _ranks(worlds, key):
        ours = _as_reference(r, res["grads"])
        assert len(ours) == len(r["jgrads"])
        _close(ours, r["jgrads"], GRAD_RTOL)
        assert res["sq_norm"] == pytest.approx(r["jsq"], rel=GRAD_RTOL)


def _ref_local_shapes(r, shape, fsdp, moe_ep=False):
    """The reference's ``param_specs`` local shape of each port leaf, in
    the port's leaf order."""
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty(shape))
    sizes = dict(zip(("data", "model"), shape))
    specs = jsh.param_specs(r["jcfg"], r["jshape"], mesh, fsdp=fsdp,
                            moe_ep=moe_ep)
    flat = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]:
        flat[jsh._path_str(path)] = spec
    leaves = {jsh._path_str(p): l for p, l in
              jax.tree_util.tree_flatten_with_path(r["jshape"])[0]}
    cfg, out = r["cfg"], []

    def local(path, stacked):
        spec = tuple(flat[path]) + (None,) * (len(leaves[path].shape)
                                              - len(tuple(flat[path])))
        dims = []
        for n, e in zip(leaves[path].shape, spec):
            k = 1
            for a in ((e,) if isinstance(e, str) else e or ()):
                k *= sizes[a]
            dims.append(n // k)
        return tuple(dims[1:] if stacked else dims)

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"blocks/{sh._slot(cfg, i)}")
        else:
            out.append(local(path, path.startswith("blocks/")))
    walk(r["params"], "")
    return out


@pytest.mark.parametrize("key", list(RUNS), ids=_ids(RUNS))
def test_local_shapes_are_the_reference_specs(key, reference, worlds):
    name, shape, fsdp = key
    want = _ref_local_shapes(reference[name], shape, fsdp)
    # the reference's build_step: expert parallelism at inference where
    # the experts divide `model`
    cfg = reference[name]["jcfg"]
    ep = cfg.moe is not None and cfg.moe.num_experts % shape[1] == 0
    infer = _ref_local_shapes(reference[name], shape, fsdp, moe_ep=ep)
    for res in _ranks(worlds, key):
        assert res["shapes"] == want
        if "moments" in res:
            assert res["moments"] == want
        if "infer_shapes" in res:
            assert res["infer_shapes"] == infer
            assert res["ep"] == ep
    # something is split on every mesh with a `model` axis > 1
    whole = [tuple(t.shape) for t in tree_leaves(reference[name]["params"])]
    assert (want != whole) == (shape != (1, 1))


@pytest.mark.parametrize("key", INFER_KEYS, ids=_ids(INFER_KEYS))
def test_sharded_prefill_and_greedy_decode(key, reference, worlds):
    r = reference[key[0]]
    (jl, jt), (pl, pt, _) = r["jinfer"], r["pinfer"]
    np.testing.assert_array_equal(jt, pt)
    for res in _ranks(worlds, key):
        i, n = res["rows"]
        rows = slice(i * 2 // n, (i + 1) * 2 // n)
        lg, toks = res["infer"]
        np.testing.assert_allclose(lg.numpy(), jl[rows], rtol=0,
                                   atol=LOGIT_TOL)
        np.testing.assert_allclose(lg.numpy(), pl[rows], rtol=0,
                                   atol=LOGIT_TOL)
        np.testing.assert_array_equal(toks.numpy(), jt[rows])
        assert all(res["init_cut"])
        assert res["gathered"]


@pytest.mark.parametrize("key", INFER_KEYS, ids=_ids(INFER_KEYS))
def test_sharded_cache_equals_one_process_cache(key, reference, worlds):
    """After prefill and greedy decode every rank's cache is its part of
    the one-process cache: its rows, slots and KV heads of the K/V
    buffers (rolling and cross-attention ones too) and the whole
    recurrent state (Mamba ``h`` / ``conv``, mLSTM and sLSTM), which each
    rank advances in part and gathers after every step."""
    for res in _ranks(worlds, key):
        assert res["cache_err"] < LOGIT_TOL, res["cache_err"]


def test_cache_layouts(worlds):
    """kv2 over `model` 4: the 1040-slot buffer by sequence (260 a rank);
    kv2-local: its 1032-slot rolling buffer too (258); kv2's long_500k
    layout on (2, 2): KV heads over `model`, the sequence over `data`."""
    assert {tuple(res["layout"]) for res in _ranks(
        worlds, ("kv2", (1, 4), False))} == {(("model",), 260, None)}
    assert {tuple(res["layout"]) for res in _ranks(
        worlds, ("kv2-local", (1, 4), False))} == {
            (("model",), 275, (("model",), 258))}
    assert {tuple(res["layout"]) for res in _ranks(
        worlds, ("kv2", (2, 2), False))} == {(("data",), 520, None)}
    assert {tuple(res["layout"]) for res in _ranks(
        worlds, ("olmo", (1, 2), False))} == {((), 48, None)}


@pytest.mark.parametrize("w", WORLDS)
def test_production_mesh_launcher_runs_the_sharded_step(w, reference,
                                                        worlds):
    from repro_torch.train import checkpoint
    want = reference["launcher"]
    for rank, o in enumerate(worlds[w]):
        losses, params = o["launcher"]
        np.testing.assert_allclose(losses, want["losses"], rtol=0,
                                   atol=LOSS_TOL)
        # the whole tree on rank 0's host, nothing on the others
        assert (params is None) == (rank > 0)
        for g, p in zip(params or [], tree_leaves(want["params"])):
            assert g.device.type == "cpu"
            tol = PARAM_RTOL * max(1.0, float(p.abs().max()))
            np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=0,
                                       atol=tol)
    saved = checkpoint.load(str(worlds[(w, "ckpt")]), want["params"],
                            want["cfg"])
    for g, p in zip(tree_leaves(saved), tree_leaves(want["params"])):
        tol = PARAM_RTOL * max(1.0, float(p.abs().max()))
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("w", WORLDS)
def test_production_mesh_launcher_without_ckpt_gathers_nothing(w, reference,
                                                               worlds):
    """Without ``--ckpt`` the sharded launcher calls no
    ``gather_params``: every rank returns its own shards (at qwen2-vl-72b
    a whole tree would not fit a card)."""
    want = reference["launcher"]
    mesh = MeshShape(("data", "model"), (1, w))
    shards = [tuple(t.shape) for t in tree_leaves(tpl.shard_params(
        want["params"], want["cfg"], mesh))]
    assert shards != [tuple(t.shape) for t in tree_leaves(want["params"])]
    for o in worlds[w]:
        gathers, losses, shapes = o["launcher_no_ckpt"]
        assert gathers == 0
        assert shapes == shards
        np.testing.assert_allclose(losses, want["losses"], rtol=0,
                                   atol=LOSS_TOL)


# --------------------------------------------------- no process group


@pytest.mark.parametrize("full,n", [(8, 1), (12, 2), (16, 4)])
def test_shard_runs_cover_each_slot_once(full, n):
    """``_shard_runs`` against a slot-by-slot walk: every kept token of a
    segment lands in the chunk that holds its slot, once."""
    for idx in range(n):
        shard = tpl.SeqShard(("model",), n, idx, full)
        for start in (0, 3, 7, 13, 20):
            for S in (1, 5, 8, 13, 17, 30):
                want = {}
                for t in range(max(0, S - full), S):
                    s = (start + t) % full - shard.off
                    if 0 <= s < shard.local:
                        want[t] = s
                got = {}
                for t0, t1, s0 in _shard_runs(start, S, shard):
                    for t in range(t0, t1):
                        assert t not in got
                        got[t] = s0 + t - t0
                assert got == want, (start, S, idx)


@functools.lru_cache(maxsize=None)
def _tp(arch, shape, **kw):
    cfg = dataclasses.replace(port_smoke(arch, **SMOKE), **kw)
    return tpl.TensorParallel(cfg, MeshShape(("data", "model"), shape))


def test_rank_plan_and_supported_archs():
    """Rank 0's heads, KV heads and vocab rows, and the new layouts: MoE
    experts by FFN column or whole under EP, Mamba channels, mLSTM heads,
    sLSTM units, whole attention and vocab; all ten archs are supported;
    a head map that is not one KV group a query run raises, as does a
    hymba whose rolling buffer would hold KV heads its queries do not
    read."""
    from repro_torch.configs import ARCH_IDS, get_config
    assert all(tpl.supported(get_config(a)) for a in ARCH_IDS)
    assert len(ARCH_IDS) == 10
    tp = _tp("llama3-8b", (1, 4), num_kv_heads=2)
    assert (tp.heads, tp.kv_split, tp.h_local, tp.kv0, tp.kv_local,
            tp.v_local) == (True, False, 1, 0, 1, 24)
    tp = _tp("olmo-1b", (2, 2))
    assert (tp.kv_split, tp.h_local, tp.kv_local) == (True, 2, 2)
    with pytest.raises(NotImplementedError, match="KV groups"):
        _tp("nemotron-4-15b", (1, 2), num_heads=6, num_kv_heads=3)
    with pytest.raises(NotImplementedError, match="rolling buffer"):
        _tp("hymba-1.5b", (1, 4), num_kv_heads=2)
    # hymba at the published layout: attention and vocab whole, the
    # Mamba channels and the MLP cut
    tp = _tp("hymba-1.5b", (1, 4), num_heads=5, num_kv_heads=1,
             vocab_size=97)
    assert (tp.heads, tp.vocab, tp.mamba, tp.mlp, tp.v_local) == \
        (False, False, True, True, 97)
    # xlstm: cells by heads and sLSTM out rows where the heads divide,
    # else the mLSTM whole and the sLSTM units cut, out whole
    tp = _tp("xlstm-350m", (1, 2))
    assert (tp.mlstm, tp.slstm, tp.slstm_out, tp.mlp) == \
        (True, True, True, False)
    tp = _tp("xlstm-350m", (1, 4), num_heads=2, num_kv_heads=2)
    assert (tp.mlstm, tp.slstm, tp.slstm_out) == (False, True, False)
    # MoE: FFN columns in training, whole experts under EP where the
    # experts divide `model`, FFN columns where they do not
    cfg = port_smoke("qwen2-moe-a2.7b", **SMOKE)
    m2 = MeshShape(("data", "model"), (1, 2))
    tp = tpl.TensorParallel(cfg, m2)
    assert (tp.experts, tp.moe_ffn, tp.moe_ep, tp.shared) == \
        (True, True, False, True)
    tp = tpl.TensorParallel(cfg, m2, moe_ep=True)
    assert (tp.moe_ffn, tp.moe_ep) == (False, True)
    e6 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=6))
    m4 = MeshShape(("data", "model"), (1, 4))
    assert not tpl.infer_moe_ep(e6, m4) and tpl.infer_moe_ep(e6, m2)
    tp = tpl.TensorParallel(e6, m4, moe_ep=tpl.infer_moe_ep(e6, m4))
    assert (tp.moe_ffn, tp.moe_ep) == (True, False)
    # whisper at 2 heads on 4 ranks: attention whole, the MLP cut
    tp = _tp("whisper-base", (1, 4), num_heads=2, num_kv_heads=2,
             vocab_size=97)
    assert (tp.heads, tp.mlp, tp.vocab) == (False, True, False)
    # the router and the shared gate are partial per rank; so are the
    # mLSTM's whole gate projections
    tp = tpl.TensorParallel(cfg, m2)
    part = dict(zip(_paths(tp.partial), sh.leaves(tp.partial)))
    assert part["blocks/0/moe/router"]
    assert part["blocks/0/moe/shared/gate"]
    assert not part["blocks/0/moe/wi"]
    tp = _tp("xlstm-350m", (1, 2))
    part = dict(zip(_paths(tp.partial), sh.leaves(tp.partial)))
    assert part["blocks/0/cell/wi"] and \
        not part["blocks/1/cell/w"]


def _paths(tree):
    out = []
    sh._map(lambda p, _: out.append(p), tree)
    return out


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_fused_cut_is_each_ranks_own_columns(parts):
    """``cut`` of a fused leaf takes the rank's chunk of every part (rank
    0 of 4 on a ``MeshShape``: the first quarter of each part), which
    leaves name by path."""
    m = MeshShape(("data", "model"), (1, 4))
    t = torch.arange(2 * 8 * parts, dtype=torch.float32).reshape(2, -1)
    got = tpl.cut(t, sh.Spec(None, "model"), m, parts)
    n = t.shape[1] // (4 * parts)
    want = torch.cat([t[:, p * 4 * n:p * 4 * n + n] for p in range(parts)],
                     dim=1)
    assert torch.equal(got, want)
    assert tpl.fused_parts("blocks/0/mamba/in_proj") == 2
    assert tpl.fused_parts("blocks/1/cell/w") == 4
    assert tpl.fused_parts("blocks/1/cell/r") == 4
    assert tpl.fused_parts("blocks/0/cell/wq") == 1


def test_fsdp_rules_are_the_reference_thresholds():
    from repro_torch.configs import get_config
    m16 = MeshShape(("data", "model"), (16, 16))
    for arch, train, infer in (("olmo-1b", False, False),
                               ("llama3-8b", False, False),
                               ("gemma2-9b", False, False),
                               ("nemotron-4-15b", True, False),
                               ("qwen2-vl-72b", True, True),
                               ("qwen2-moe-a2.7b", True, False),
                               ("qwen3-moe-30b-a3b", True, False),
                               ("hymba-1.5b", False, False),
                               ("xlstm-350m", False, False),
                               ("whisper-base", False, False)):
        n = tpl.param_count(get_config(arch))
        assert (tpl.train_fsdp(n, m16), tpl.infer_fsdp(n, m16)) == \
            (train, infer), arch
