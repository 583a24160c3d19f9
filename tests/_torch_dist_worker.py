"""One gloo rank of ``tests/test_torch_distributed.py`` (imports no JAX).

``run`` is the target of ``torch.multiprocessing.spawn``: it joins a
world of ``world`` CPU processes through a ``FileStore``, loads the
inputs the parent saved, runs every check of the port's distributed layer
on its meshes and saves its results for the parent to hold against the
reference.
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
    out = checks(rank, world, torch.load(inputs, weights_only=False))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _shard(t: torch.Tensor, rank: int, world: int, dim: int):
    n = t.shape[dim] // world
    return t.narrow(dim, rank * n, n).contiguous()


def checks(rank: int, world: int, inp: dict) -> dict:
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding, tensor_parallel
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import Model, moe
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import tree_leaves
    out = {}
    line = mesh_lib.make_mesh((world,), ("data",), "cpu")
    # the corpus-sharded top-k, kernel wrapper and plain version
    shard = _shard(inp["corpus"], rank, world, 0)
    for k in inp["ks"]:
        out[("topk", k)] = collectives.distributed_topk(
            inp["queries"], shard, k, line)
        out[("topk_plain", k)] = collectives.distributed_topk(
            inp["queries"], shard, k, line, use_kernel=False)
    # the sequence-sharded decode
    ks, vs = (_shard(inp[n], rank, world, 1) for n in ("k_cache", "v_cache"))
    for cap in inp["softcaps"]:
        out[("decode", cap)] = collectives.flash_decode_seq_sharded(
            inp["q"], ks, vs, inp["q_position"], line, softcap=cap)
    # expert-parallel MoE over `model`: the sharded program's inference
    # layout (each rank its whole experts); a dict with every expert is
    # refused
    ep = mesh_lib.make_mesh((1, world), ("data", "model"), "cpu")
    cfg = inp["moe_cfg"]
    tp = tensor_parallel.TensorParallel(cfg, ep, moe_ep=True)
    local = tensor_parallel.cut_tree(inp["moe_params"],
                                     tp.specs["blocks"][0]["moe"], ep)
    with torch.no_grad():
        for cf in inp["capacity_factors"]:
            out[("ep", cf)] = moe.apply_moe(local, inp["x"], cfg,
                                            capacity_factor=cf,
                                            return_aux=True, tp=tp)
        try:
            moe.apply_moe(inp["moe_params"], inp["x"], cfg, tp=tp)
            out["ep_whole"] = None
        except ValueError as e:   # the message is the result
            out["ep_whole"] = str(e)
        # Model(tp=) with experts whole over `model` on a whole tree cut
        # to this rank, and its own draw: the same slice
        mcfg = inp["model_cfg"]
        m = Model(mcfg, moe_capacity_factor=1.25,
                  tp=tensor_parallel.TensorParallel(mcfg, ep, moe_ep=True))
        mine = tensor_parallel.shard_params(inp["model_params"], mcfg, ep,
                                            moe_ep=True)
        out["ep_model"] = m.forward(mine, inp["tokens"], inp["positions"],
                                    return_aux=True)
        drawn = m.init_params(seed=world, device="cpu", max_seq=64)
        out["ep_init"] = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(drawn), tree_leaves(mine)))
    # the train step over the mesh, the sharded program: this rank's
    # shards in, the whole tree gathered after the steps
    for (arch, shape, remat), (cfg_a, params, batch) in inp["train"].items():
        if shape[0] * shape[1] != world:
            continue
        mesh = mesh_lib.make_mesh(shape, ("data", "model"), "cpu")
        params = tensor_parallel.shard_params(params, cfg_a, mesh)
        step = ts.make_train_step(Model(cfg_a), lr=inp["lr"], remat=remat,
                                  mesh=mesh, fsdp=False)
        opt = ts.init_opt_state(params)
        metrics = []
        for _ in range(inp["steps"]):
            params, opt, mt = step(params, opt, batch)
            metrics.append({n: float(v) for n, v in mt.items()})
        params = tensor_parallel.gather_params(params, cfg_a, mesh)
        out[("train", arch, shape, remat)] = (metrics, tree_leaves(params))
    # host meshes clamp to the world; a mesh of another size raises
    out["host_mesh"] = tuple(mesh_lib.make_host_mesh(8, 8, "cpu").shape)
    if world == 4:
        out["host_mesh_2x2"] = tuple(mesh_lib.make_host_mesh(2, 2,
                                                             "cpu").shape)
        # placements on a real mesh: a DTensor's local shard, and
        # maybe_constrain laying a replicated DTensor out as asked
        from torch.distributed.tensor import Replicate, distribute_tensor
        m22 = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
        p = inp["model_params"]
        pl = sharding.param_shardings(inp["model_cfg"], p, m22)
        emb = distribute_tensor(p["embed"], m22, pl["embed"])
        out["embed_local"] = emb.to_local()
        wq = distribute_tensor(p["blocks"][0]["attn"]["wq"], m22,
                               pl["blocks"][0]["attn"]["wq"])
        out["wq_local"] = wq.to_local()
        rep = distribute_tensor(inp["x"], m22, (Replicate(), Replicate()))
        con = sharding.maybe_constrain(rep, ("pod", "data"), None, "model")
        out["constrained"] = (tuple(con.placements), con.to_local())
    # launch.train --production-mesh over a (2, world/2) stand-in of the
    # 16x16 mesh: the default group is this world
    from repro_torch.launch import train
    mesh_lib.PRODUCTION_SHAPE = (2, world // 2)
    out["launcher"] = train.main(inp["launch_args"]
                                 + ["--production-mesh"])["losses"]
    try:
        mesh_lib.make_mesh((world + 1,), ("data",), "cpu")
        out["mismatch"] = None
    except RuntimeError as e:     # the message is the result
        out["mismatch"] = str(e)
    return out
