"""One gloo rank of ``tests/test_torch_tensor_parallel.py`` (imports no
JAX).

``run`` is the target of ``torch.multiprocessing.spawn``: it joins a
world of ``world`` CPU processes through a ``FileStore``, loads the
inputs the parent saved, runs every case of the sharded program on its
mesh and saves its results for the parent to hold against the reference
and the one-process port.
"""
import datetime
import os

import torch
import torch.distributed as dist


def run(rank: int, world: int, store: str, inputs: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    out = checks(world, torch.load(inputs, weights_only=False))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _rows(t: torch.Tensor, key: str, i: int, n: int) -> torch.Tensor:
    """Batch shard i of n (axis 1 of M-RoPE positions [3, B, S])."""
    dim = 1 if key == "positions" and t.dim() == 3 else 0
    return t.chunk(n, dim=dim)[i]


def infer(model, params, case: dict, rows: tuple, shard_seq: bool):
    """Prefill of this rank's rows (``rows`` = (shard, shards)), then
    greedy decode: (prefill logits, greedy tokens [b, steps], the
    cache)."""
    i, n = rows
    inp = {k: _rows(v, k, i, n) for k, v in case["prompt"].items()}
    first = _rows(case["first"], "first", i, n)
    c = model.init_cache(first.shape[0], case["max_len"], "cpu",
                         shard_seq=shard_seq)
    c.first = first.clone()
    with torch.no_grad():
        logits = model.prefill(params, inp["tokens"], inp["positions"], c,
                               vision_embeds=inp.get("vision_embeds"),
                               encoder_frames=inp.get("encoder_frames"))
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        toks = []
        for _ in range(case["steps"]):
            toks.append(tok)
            tok = model.decode_step(params, tok, c).argmax(
                -1, keepdim=True).to(torch.int32)
    return logits, torch.cat(toks, dim=1), c


def cache_error(tp, c, want, rows: tuple) -> float:
    """The largest difference between this rank's cache ``c`` and its
    part of the one-process cache ``want`` (every row), over the largest
    magnitude of that part (at least 1): the rank's rows, and of the K/V
    buffers its slots (a buffer split by sequence) and KV heads (split
    KV heads); recurrent state whole."""
    i, n = rows
    b = c.first.shape[0]
    lay = c.layout

    def part(t, row_dim, shard, head_dim):
        t = t.narrow(row_dim, i * b, b)
        if shard is not None and shard.axes:
            t = t.narrow(row_dim + 1, shard.off, shard.local)
        if tp.kv_split and head_dim is not None:
            t = t.narrow(head_dim, tp.kv0, tp.kv_local)
        return t

    pairs = [(c.k, part(want.k, 1, lay.attn, 3)),
             (c.v, part(want.v, 1, lay.attn, 3))]
    for layer, st in c.state.items():
        for name, t in st.items():
            w = want.state[layer][name]
            if name in ("k", "v"):
                w = part(w, 0, lay.rolling, 2)
            elif name in ("xk", "xv"):
                w = part(w, 0, None, 2)
            else:
                w = part(w, 0, None, None)
            pairs.append((t, w))
    assert c.length == want.length
    err = 0.0
    for got, w in pairs:
        assert got.shape == w.shape, (got.shape, w.shape)
        if w.numel():
            err = max(err, float((got.float() - w.float()).abs().max())
                      / max(1.0, float(w.float().abs().max())))
    return err


def checks(world: int, inp: dict) -> dict:
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import Model
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_step import batch_rank
    out = {}
    for key, run_ in inp["runs"].items():
        name, shape, fsdp = key
        if shape[0] * shape[1] != world:
            continue
        case = inp["cases"][name]
        cfg, whole = case["cfg"], case["params"]
        mesh = mesh_lib.make_mesh(shape, ("data", "model"), "cpu")
        local = tpl.shard_params(whole, cfg, mesh, fsdp)
        res = {"shapes": [tuple(t.shape) for t in tree_leaves(local)]}
        if run_["train"]:
            # the gradient as the step has it before AdamW: this rank's
            # batch shard's, completed by sync_grads; its squared norm
            tp = tpl.TensorParallel(cfg, mesh, fsdp)
            loss_fn = ts.make_loss_fn(Model(cfg, batch_mesh=mesh, tp=tp),
                                      remat=True)
            (_, (loss, _)), g = ts.value_and_grad(
                loss_fn, local, ts.shard_batch(case["batch"], mesh))
            g, _ = tp.sync_grads(g, loss)
            res["sq_norm"] = float(tp.grad_sq_norm(g))
            res["grads"] = tree_leaves(tpl.gather_params(g, cfg, mesh, fsdp))
            step = ts.make_train_step(Model(cfg), lr=inp["lr"], remat=True,
                                      mesh=mesh, fsdp=fsdp)
            opt = ts.init_opt_state(local)
            p, opt, m = step(local, opt, case["batch"])
            res["loss"] = float(m["loss"])
            res["params"] = tree_leaves(tpl.gather_params(p, cfg, mesh,
                                                          fsdp))
            res["mu"] = tree_leaves(tpl.gather_params(opt.mu, cfg, mesh,
                                                      fsdp))
            res["moments"] = [tuple(t.shape) for t in tree_leaves(opt.mu)]
        if run_["infer"]:
            # the reference's inference layout: whole experts over `model`
            # where they divide it
            ep = tpl.infer_moe_ep(cfg, mesh)
            tp = tpl.TensorParallel(cfg, mesh, fsdp, moe_ep=ep)
            model = Model(cfg, tp=tp)
            local = tpl.shard_params(whole, cfg, mesh, fsdp, moe_ep=ep)
            res["ep"] = tp.moe_ep
            res["infer_shapes"] = [tuple(t.shape)
                                   for t in tree_leaves(local)]
            drawn = model.init_params(seed=0, device="cpu", max_seq=64)
            res["init_cut"] = [torch.equal(a, b) for a, b in zip(
                tree_leaves(drawn), tree_leaves(tpl.shard_params(
                    Model(cfg).init_params(seed=0, device="cpu", max_seq=64),
                    cfg, mesh, fsdp, moe_ep=ep)))]
            res["gathered"] = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(tpl.gather_params(local, cfg, mesh, fsdp,
                                              moe_ep=ep)),
                tree_leaves(whole)))
            shard_seq = run_.get("shard_seq", False)
            rows = (0, 1) if shard_seq else batch_rank(mesh)
            res["rows"] = rows
            logits, toks, c = infer(model, local, case, rows, shard_seq)
            res["infer"] = (logits, toks)
            res["cache_err"] = cache_error(tp, c, case["cache"], rows)
            lay = model.init_cache(1, case["max_len"], "cpu",
                                   shard_seq=shard_seq).layout
            res["layout"] = (lay.attn.axes, lay.attn.local,
                             None if lay.rolling is None else
                             (lay.rolling.axes, lay.rolling.local))
        out[key] = res
    # launch.train --production-mesh over a (1, world) stand-in of the
    # 16x16 mesh: the sharded step, a checkpoint gathered to rank 0's host
    from repro_torch.launch import train
    mesh_lib.PRODUCTION_SHAPE = (1, world)
    got = train.main(inp["launch_args"] + [
        "--production-mesh", "--ckpt",
        os.path.join(inp["tmp"], f"tp{world}.npz")])
    out["launcher"] = (got["losses"], None if got["params"] is None
                       else tree_leaves(got["params"]))
    # without --ckpt: nothing gathered, every rank keeps its shards
    gathers, gather = [], tpl.gather_params
    tpl.gather_params = lambda *a, **k: gathers.append(a) or gather(*a, **k)
    try:
        got = train.main(inp["launch_args"] + ["--production-mesh"])
    finally:
        tpl.gather_params = gather
    out["launcher_no_ckpt"] = (len(gathers), got["losses"], [
        tuple(t.shape) for t in tree_leaves(got["params"])])
    return out
