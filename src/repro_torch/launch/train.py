"""Training launcher of the port: random token batches through the train
step, on the card.

Counterpart of ``repro/launch/train.py`` (every flag with its default,
plus ``--device``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --steps 20 --batch 8 --seq 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --steps 6 --batch 4 --seq 256          # published width, one card

The model is drawn from seed 0 and step t's batch from a
``torch.Generator`` seeded with t (not ``jax.random``'s draws).  The full
config trains with ``remat`` (each layer's activations recomputed in the
backward pass), the smoke config without, as in the reference.  It
prints the reference's step lines, then the median step time, tokens per
second and peak device memory; ``--ckpt`` saves the trained parameters
(``train.checkpoint``, the reference's format).

``--production-mesh`` runs the production program over the 16x16
("data", "model") mesh of ``launch.mesh.make_production_mesh``: 256
ranks started by ``torchrun``, whose environment initialises the default
group (NCCL on the card, gloo with ``--device cpu``).  Each data rank
takes its 1/16 of every global batch.  For every arch that is the
reference's sharded step (``make_train_step(mesh=)``): each rank keeps
its shard of the params and AdamW state (``init_params`` under
``tensor_parallel.TensorParallel`` cuts the seed-0 draw layer by layer),
tensor-parallel over `model` (heads, FFN and expert FFN columns, Mamba
channels, xLSTM heads and units, vocab), FSDP over `data` where the
reference's rule turns it on (both MoE archs); ``--ckpt`` saves the
whole params, as the reference's launcher saves its global arrays: they
are gathered one leaf at a time into rank 0's host memory
(``tensor_parallel.gather_params(dst=0)``), and without ``--ckpt``
nothing is gathered.  Rank 0 prints and saves.  Any other world
size raises before the model is built, naming it:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --smoke \
        --device cpu --production-mesh        # the world-size error
"""
import argparse
import os
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import Model
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import cosine_schedule
from repro_torch.train.train_step import init_opt_state, make_train_step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (requires 256 ranks, from torchrun)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default, needs a GPU) or cpu")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def production_mesh(dev: torch.device):
    """The 16x16 mesh over the default group, initialised from
    ``torchrun``'s environment (WORLD_SIZE, RANK, MASTER_ADDR, ...; NCCL
    on the card, gloo on the CPU).  A world of any other size raises
    first, naming it: nothing is initialised or allocated then."""
    want = mesh_lib.production_shape()
    n = dist.get_world_size() if dist.is_initialized() \
        else int(os.environ.get("WORLD_SIZE", "1"))
    if n != want.size:
        raise RuntimeError(
            f"--production-mesh needs a world of {want.size} ranks (the "
            f"{'x'.join(map(str, want.shape))} {want.axis_names} mesh); "
            f"this world has {n} (start it with torchrun "
            f"--nproc-per-node ... so that WORLD_SIZE is {want.size})")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return mesh_lib.make_production_mesh(device_type=dev.type)


def main(argv=None) -> dict:
    """Run the launcher; returns {"losses", "step_ms", "tokens_per_s",
    "peak_gib" (None on the CPU), "params", "cfg"} for callers that drive
    it.  "params" are whole, but under the sharded program: there they
    are this rank's shards, or with ``--ckpt`` the whole tree on rank 0's
    host (None on the other ranks)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    mesh = production_mesh(dev) if args.production_mesh else None
    lead = mesh is None or dist.get_rank() == 0
    if mesh is not None and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    sharded = mesh is not None and tpl.supported(cfg)
    fsdp = sharded and tpl.train_fsdp(tpl.param_count(cfg), mesh)
    # under the sharded program each rank keeps its shards of the draw
    model = Model(cfg, tp=tpl.TensorParallel(cfg, mesh, fsdp)
                  if sharded else None)
    params = model.init_params(seed=0, device=dev, max_seq=args.seq)
    opt = init_opt_state(params)
    lr = cosine_schedule(args.lr, warmup=max(2, args.steps // 10),
                         total=args.steps)
    step_fn = make_train_step(model, lr=lr, remat=not args.smoke,
                              microbatch=args.microbatch, mesh=mesh,
                              fsdp=fsdp)
    B, S = args.batch, args.seq
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    gen = torch.Generator(device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    t0 = time.perf_counter()
    for step in range(args.steps):
        gen.manual_seed(step)
        toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                             device=dev)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 "positions": pos}
        ts = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        _sync(dev)
        times.append(time.perf_counter() - ts)
        losses.append(float(m["loss"]))
        if lead and (step % 5 == 0 or step == args.steps - 1):
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"({time.perf_counter()-t0:.1f}s)", flush=True)
    # the first step also builds the kernels: the median of the rest
    step_s = statistics.median(times[1:] if len(times) > 1 else times)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 \
        if dev.type == "cuda" else None
    if lead:
        print(f"train: {cfg.name} {args.steps} steps of {B}x{S} on {dev}: "
              f"step {step_s * 1e3:.1f} ms (median; first "
              f"{times[0] * 1e3:.1f} ms), {B * S / step_s:.0f} tokens/s, "
              "peak " + (f"{peak:.2f} GiB" if peak is not None
                         else "n/a (cpu)"), flush=True)
    if args.ckpt and sharded:
        params = tpl.gather_params(params, cfg, mesh, fsdp, dst=0)
    if args.ckpt and lead:
        checkpoint.save(args.ckpt, params, cfg)
        print("saved", args.ckpt, flush=True)
    return {"losses": losses, "step_ms": step_s * 1e3,
            "tokens_per_s": B * S / step_s, "peak_gib": peak,
            "params": params, "cfg": cfg}


if __name__ == "__main__":
    main()
