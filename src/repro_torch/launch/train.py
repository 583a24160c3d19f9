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
(``train.checkpoint``, the reference's format).  ``--production-mesh``
needs the distributed port (ROADMAP A7) and raises
``NotImplementedError`` before anything is built.
"""
import argparse
import statistics
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
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
                    help="16x16 mesh (not ported: ROADMAP A7)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default, needs a GPU) or cpu")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Run the launcher; returns {"losses", "step_ms", "tokens_per_s",
    "peak_gib" (None on the CPU), "params"} for callers that drive it."""
    args = _parser().parse_args(argv)
    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh: the distributed train step is not ported "
            "yet (ROADMAP A7)")
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg)
    params = model.init_params(seed=0, device=dev, max_seq=args.seq)
    opt = init_opt_state(params)
    lr = cosine_schedule(args.lr, warmup=max(2, args.steps // 10),
                         total=args.steps)
    step_fn = make_train_step(model, lr=lr, remat=not args.smoke,
                              microbatch=args.microbatch)
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
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"({time.perf_counter()-t0:.1f}s)", flush=True)
    # the first step also builds the kernels: the median of the rest
    step_s = statistics.median(times[1:] if len(times) > 1 else times)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 \
        if dev.type == "cuda" else None
    print(f"train: {cfg.name} {args.steps} steps of {B}x{S} on {dev}: "
          f"step {step_s * 1e3:.1f} ms (median; first "
          f"{times[0] * 1e3:.1f} ms), {B * S / step_s:.0f} tokens/s, peak "
          + (f"{peak:.2f} GiB" if peak is not None else "n/a (cpu)"),
          flush=True)
    if args.ckpt:
        checkpoint.save(args.ckpt, params, cfg)
        print("saved", args.ckpt, flush=True)
    return {"losses": losses, "step_ms": step_s * 1e3,
            "tokens_per_s": B * S / step_s, "peak_gib": peak,
            "params": params, "cfg": cfg}


if __name__ == "__main__":
    main()
