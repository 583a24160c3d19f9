"""The port's distributed layer on gloo process groups on the CPU, held to
the reference.

One ``torch.multiprocessing.spawn`` per world size (2 and 4 ranks, each on
one torch thread, meeting through a ``FileStore`` under ``tmp_path``) runs
every check in ``_torch_dist_worker.checks`` and hands its results back;
the reference's side runs here, on one device:

  * ``distributed_topk`` over a corpus split into rank-ordered shards,
    with duplicate rows inside and across shards (ties) and k up to past
    a shard: ids exactly the reference's one-device ``distributed_topk``
    and ``ref.topk_ref``'s, scores within 1e-5; the same for the plain
    version (``use_kernel=False``);
  * ``flash_decode_seq_sharded``: a query position in each shard, with
    and without a softcap, within 1e-5 of the reference's one-device
    result;
  * expert-parallel MoE over `model` (``apply_moe(tp=TensorParallel(
    moe_ep=True))`` on the rank's whole experts), dropless, at capacity
    factor 1.25 and at 0.5 (drops checked to happen): y within 1e-5 of
    the reference's ``apply_moe``, aux within 1e-6; a dict of every
    expert refused; and ``Model(tp=)``'s forward with experts whole over
    `model` against the one-process forward, its ``init_params`` drawing
    the slice of the whole draw;
  * the train step over a mesh (``make_train_step(mesh=)``, the sharded
    program of ``distributed.tensor_parallel``) on meshes (2, 1) (data
    parallel: `model` is 1) and (2, 2), for olmo-1b (a dense decoder)
    and qwen2-moe-a2.7b (its aux loss a product of batch means), and
    on (2, 1) for qwen2-moe-a2.7b with
    every layer checkpointed (its aux collectives run again in the
    backward's recompute): two steps' losses within 1e-5 and the
    parameters after them within 1e-4 of their largest magnitude, against
    the reference's one-device step and the port's one-process step
    (with the same ``remat``);
  * ``launch.train --production-mesh`` of qwen2-moe-a2.7b (the sharded
    program), its mesh shrunk to (2, 1) and (2, 2): the one-process
    launcher's losses within 1e-5;
  * the host meshes, DTensor placements of ``param_shardings`` and
    ``maybe_constrain`` on a real 2x2 mesh, the size check of
    ``make_mesh``; every rank's results equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_thread  # noqa: E402,F401  (autouse)

import _torch_dist_worker  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.distributed.collectives import (  # noqa: E402
    distributed_topk as j_topk, flash_decode_seq_sharded as j_decode)
from repro.kernels import ref as jref  # noqa: E402
from repro.launch.mesh import make_host_mesh as j_host_mesh  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.moe import apply_moe as j_apply_moe  # noqa: E402
from repro.models.moe import init_moe as j_init_moe  # noqa: E402
from repro.train import train_step as jts  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke  # noqa: E402
from repro_torch.models import Model, moe  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

WORLDS = (2, 4)
KS = (1, 5, 16, 40)               # 40: past a 4-rank shard of 24
SOFTCAPS = (None, 30.0)
CFS = (4.0, 1.25, 0.5)            # dropless (num_experts), default, drops
TRAIN_ARCHS = ("olmo-1b", "qwen2-moe-a2.7b")
TRAIN_MESHES = {2: (2, 1), 4: (2, 2)}
REMAT_CASES = {2: ("qwen2-moe-a2.7b",)}     # also run with remat=True
SMOKE = dict(max_d_model=64, vocab=96)
LR, STEPS = 1e-3, 2
TOL, AUX_TOL, PARAM_RTOL = 1e-5, 1e-6, 1e-4
LAUNCH = ["--arch", "qwen2-moe-a2.7b", "--smoke", "--device", "cpu",
          "--steps", "3", "--batch", "4", "--seq", "16"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _topk_inputs(rng):
    q = rng.standard_normal((6, 16)).astype(np.float32)
    c = rng.standard_normal((96, 16)).astype(np.float32)
    c[3] = 10 * q[0]              # query 0's top three: a tie across
    c[50] = c[3]                  # shards
    c[60] = c[3]
    c[7] = c[5]                   # and one inside a shard
    return q, c


def _decode_inputs(rng, world):
    B, H, KV, hd, S = world, 4, 2, 16, 32 * world
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    # row r's position inside shard r, past its first key
    qp = np.array([r * 32 + 5 + 7 * r for r in range(B)], np.int32)
    return q, kc, vc, qp


@pytest.fixture(scope="module")
def reference():
    """The reference's one-device train steps and the port's one-process
    steps, shared by both world sizes; the train inputs."""
    out = {}
    for arch in TRAIN_ARCHS:
        cfg = get_smoke_config(arch, **SMOKE)
        jm = JModel(cfg)
        jparams = jm.init_params(jax.random.PRNGKey(0), max_seq=64)
        rng = np.random.default_rng(3)
        toks = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 "positions": np.broadcast_to(np.arange(16, dtype=np.int32),
                                              (4, 16)).copy()}
        step = jax.jit(jts.make_train_step(jm, lr=LR, remat=False))
        opt = jts.init_opt_state(jparams)
        p, jmetrics = jparams, []
        for _ in range(STEPS):
            p, opt, m = step(p, opt, jax.tree.map(jnp.asarray, batch))
            jmetrics.append({k: float(v) for k, v in m.items()})
        jfinal = [np.asarray(a, np.float32) for a in jax.tree.leaves(
            jax.tree.map(np.asarray, p))]
        pcfg = port_smoke(arch, **SMOKE)
        params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          pcfg, device="cpu")
        tb = {k: _t(v) for k, v in batch.items()}
        port = {}
        for remat in (False, True):
            if remat and not any(arch in a for a in REMAT_CASES.values()):
                continue
            pstep = ts.make_train_step(Model(pcfg), lr=LR, remat=remat)
            popt = ts.init_opt_state(params)
            pp, pmetrics = params, []
            for _ in range(STEPS):
                pp, popt, m = pstep(pp, popt, tb)
                pmetrics.append({k: float(v) for k, v in m.items()})
            port[remat] = (pmetrics, tree_leaves(pp))
        out[arch] = dict(cfg=pcfg, params=params, batch=tb,
                         jmetrics=jmetrics, jfinal=jfinal, port=port)
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request, reference, tmp_path_factory):
    """(world size, inputs, every rank's results) of one spawn."""
    import torch.multiprocessing as mp
    w = request.param
    rng = np.random.default_rng(w)
    q, c = _topk_inputs(rng)
    dq, kc, vc, qp = _decode_inputs(rng, w)
    mcfg = port_smoke("qwen3-moe-30b-a3b")
    jp = j_init_moe(jax.random.PRNGKey(w), get_smoke_config(
        "qwen3-moe-30b-a3b"), jnp.float32)
    mp_np = jax.tree.map(np.asarray, jp)
    x = rng.standard_normal((2, 12, mcfg.d_model)).astype(np.float32)
    fcfg = port_smoke("qwen2-moe-a2.7b", **SMOKE)
    fparams = Model(fcfg).init_params(seed=w, device="cpu", max_seq=64)
    toks = _t(rng.integers(0, fcfg.vocab_size, (2, 10)).astype(np.int64))
    pos = torch.arange(10, dtype=torch.int32).expand(2, 10)
    inp = {"queries": _t(q), "corpus": _t(c), "ks": KS,
           "q": _t(dq), "k_cache": _t(kc), "v_cache": _t(vc),
           "q_position": _t(qp), "softcaps": SOFTCAPS,
           "moe_cfg": mcfg, "moe_params": jax.tree.map(_t, mp_np),
           "x": _t(x), "capacity_factors": CFS,
           "model_cfg": fcfg, "model_params": fparams, "tokens": toks,
           "positions": pos, "lr": LR, "steps": STEPS,
           "launch_args": LAUNCH,
           "train": {(a, TRAIN_MESHES[w], remat): (r["cfg"], r["params"],
                                                   r["batch"])
                     for a, r in reference.items() for remat in (False, True)
                     if not remat or a in REMAT_CASES.get(w, ())}}
    d = tmp_path_factory.mktemp(f"world{w}")
    torch.save(inp, d / "inputs.pt")
    mp.spawn(_torch_dist_worker.run,
             args=(w, str(d / "store"), str(d / "inputs.pt"), str(d)),
             nprocs=w, join=True)
    outs = [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(w)]
    return w, inp, outs


def _same_on_every_rank(outs, key):
    first = outs[0][key]
    for o in outs[1:]:
        a, b = (jax.tree.leaves(jax.tree.map(
            lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, x))
            for x in (first, o[key]))
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v, err_msg=str(key))
    return first


def test_distributed_topk_matches_reference(world):
    w, inp, outs = world
    q, c = inp["queries"].numpy(), inp["corpus"].numpy()
    mesh = j_host_mesh(1, 1)
    for k in KS:
        ws, wi = jref.topk_ref(jnp.asarray(q), jnp.asarray(c), k)
        if k <= c.shape[0] // w:      # the reference's lax.top_k needs k <= shard
            js, ji = j_topk(jnp.asarray(q), jnp.asarray(c), k, mesh)
            np.testing.assert_array_equal(np.asarray(ji), np.asarray(wi))
        for name in ("topk", "topk_plain"):
            s, i = _same_on_every_rank(outs, (name, k))
            np.testing.assert_array_equal(i.numpy(), np.asarray(wi),
                                          err_msg=f"{name} k={k}")
            np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=0,
                                       atol=TOL)
    # the tie: docs 3, 50 and 60 (other shards) score equal for query 0
    s, i = outs[0][("topk", 5)]
    assert i[0, :3].tolist() == [3, 50, 60]


def test_flash_decode_seq_sharded_matches_reference(world):
    w, inp, outs = world
    mesh = j_host_mesh(1, 1)
    args = [jnp.asarray(inp[n].numpy()) for n in
            ("q", "k_cache", "v_cache", "q_position")]
    assert sorted(int(p) // (inp["k_cache"].shape[1] // w)
                  for p in inp["q_position"]) == list(range(w))
    for cap in SOFTCAPS:
        want = np.asarray(j_decode(*args, mesh, softcap=cap))
        got = _same_on_every_rank(outs, ("decode", cap))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL,
                                   err_msg=f"softcap {cap}")


def test_expert_parallel_moe_matches_reference(world):
    w, inp, outs = world
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    assert cfg.moe.num_experts % w == 0 and CFS[0] == cfg.moe.num_experts
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), inp["moe_params"])
    x = jnp.asarray(inp["x"].numpy())
    top_idx, _ = moe.route(inp["moe_params"], inp["x"],
                           cfg.moe.num_experts_per_tok)
    for cf in CFS:
        y, aux = j_apply_moe(jp, x, cfg, capacity_factor=cf)
        keep = moe.capacity_keep(top_idx, cfg.moe.num_experts, moe.capacity(
            12, cfg.moe.num_experts_per_tok, cfg.moe.num_experts, cf))
        if cf != 1.25:               # dropless keeps all; 0.5 drops
            assert bool(keep.all()) == (cf == CFS[0])
        gy, ga = _same_on_every_rank(outs, ("ep", cf))
        np.testing.assert_allclose(gy.numpy(), np.asarray(y), rtol=0,
                                   atol=TOL, err_msg=f"cf {cf}")
        assert abs(float(ga) - float(aux)) < AUX_TOL
    n = cfg.moe.num_experts // w
    for o in outs:
        assert o["ep_whole"] is not None and \
            f"holds {cfg.moe.num_experts} experts" in o["ep_whole"] and \
            f"this rank's {n} expected" in o["ep_whole"]
        assert o["ep_init"] is True
    # Model(tp=) with experts whole over `model`: the one-process
    # forward's logits and aux
    with torch.no_grad():
        logits, aux = Model(inp["model_cfg"], moe_capacity_factor=1.25
                            ).forward(inp["model_params"], inp["tokens"],
                                      inp["positions"], return_aux=True)
    gl, ga = _same_on_every_rank(outs, "ep_model")
    np.testing.assert_allclose(gl.numpy(), logits.numpy(), rtol=0, atol=TOL)
    assert abs(float(ga) - float(aux)) < AUX_TOL


def test_data_parallel_step_matches_one_device(world, reference):
    w, inp, outs = world
    shape = TRAIN_MESHES[w]
    cases = [(a, False) for a in TRAIN_ARCHS] \
        + [(a, True) for a in REMAT_CASES.get(w, ())]
    for arch, remat in cases:
        r = reference[arch]
        pmetrics, pfinal = r["port"][remat]
        metrics, final = _same_on_every_rank(outs, ("train", arch, shape,
                                                    remat))
        for got, want, mine in zip(metrics, r["jmetrics"], pmetrics):
            for key in ("loss", "aux_loss", "total_loss"):
                assert got[key] == pytest.approx(want[key], abs=TOL), key
                assert got[key] == pytest.approx(mine[key], abs=TOL), key
        if arch == "qwen2-moe-a2.7b":
            assert metrics[0]["aux_loss"] > 0
        ours = bridge.params_to_numpy(
            _unflatten(r["params"], final), r["cfg"])
        theirs = [np.asarray(a) for a in r["jfinal"]]
        for g, j, p in zip(jax.tree.leaves(ours), theirs,
                           jax.tree.leaves(bridge.params_to_numpy(
                               _unflatten(r["params"], pfinal), r["cfg"]))):
            tol = PARAM_RTOL * max(1.0, float(np.abs(j).max()))
            np.testing.assert_allclose(g, j, rtol=0, atol=tol)
            np.testing.assert_allclose(g, p, rtol=0, atol=tol)


def _unflatten(tree, leaves):
    from repro_torch.train.optimizer import tree_map
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def test_meshes_and_placements(world):
    w, inp, outs = world
    for o in outs:
        assert o["host_mesh"] == (w, 1)
        assert o["mismatch"] is not None and f"{w + 1} ranks" in \
            o["mismatch"] and f"has {w}" in o["mismatch"]
    if w != 4:
        return
    from torch.distributed.tensor import Replicate, Shard
    p = inp["model_params"]
    cfg = inp["model_cfg"]
    emb, wq = p["embed"], p["blocks"][0]["attn"]["wq"]
    for r, o in enumerate(outs):
        assert o["host_mesh_2x2"] == (2, 2)
        dr, mr = divmod(r, 2)
        # embed ("model", None): rows split over model, data replicated
        n = emb.shape[0] // 2
        np.testing.assert_array_equal(o["embed_local"].numpy(),
                                      emb[mr * n:(mr + 1) * n].numpy())
        # attn/wq (None, "model") when the heads divide the axis
        assert cfg.num_heads % 2 == 0
        n = wq.shape[1] // 2
        np.testing.assert_array_equal(o["wq_local"].numpy(),
                                      wq[:, mr * n:(mr + 1) * n].numpy())
        pl, local = o["constrained"]
        assert pl == (Shard(0), Shard(2)) and pl[0] != Replicate()
        x = inp["x"]
        b, d = x.shape[0] // 2, x.shape[2] // 2
        np.testing.assert_array_equal(
            local.numpy(), x[dr * b:(dr + 1) * b, :, mr * d:(mr + 1) * d])


def test_production_mesh_launcher_matches_one_process(world, capsys):
    """launch.train --production-mesh, its mesh shrunk to (2, world/2)
    over the spawned world, trains as the one-process launcher on the
    same batches."""
    w, inp, outs = world
    from repro_torch.launch import train
    want = train.main(LAUNCH)["losses"]
    got = _same_on_every_rank(outs, "launcher")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
