"""Serving launcher of the port: request-level wave scheduling
(``RequestQueue``) over ``ServeEngine.generate`` for an architecture the
port serves, on the card.

Counterpart of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --batch 4 --requests 8 --prompt-len 256 --new-tokens 16 \\
        --max-len 512 --reference
    ... --arch hymba-1.5b        # or qwen2-moe-a2.7b, xlstm-350m,
                                 # llama3-8b, nemotron-4-15b,
                                 # qwen3-moe-30b-a3b, qwen2-vl-72b,
                                 # whisper-base
    ... --smoke --device cpu     # a tiny config on the plain PyTorch path

Without ``--arch`` it serves gemma2-9b, the reference's default.

Every flag of the reference is accepted, plus ``--device`` (``cuda`` by
default).  Weights are drawn from seed 0 (``Model.init_params``, a
learned position table of ``--max-len`` rows, as the reference's), the
prompts from a seeded numpy generator: request i has ``prompt_len // (1 +
i % 3)`` tokens, so the lengths straddle power-of-two buckets and the
queue schedules across them.  ``--reference`` also times one wave of
``generate`` against the per-token host loop ``generate_reference`` on
the same prompts (each warmed up once first) and reports whether their
tokens agree.  The port serves all ten of the reference's
architectures; ``check_ported`` still guards the command: an
architecture without a port config raises ``NotImplementedError``,
naming its ROADMAP item, before anything is built.
"""
import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.serving import GenerationParams, RequestQueue, ServeEngine
from repro_torch.serving.engine import _sync

# the reference's architectures (repro/configs/__init__.py)
REFERENCE_ARCHS = ("nemotron-4-15b", "qwen3-moe-30b-a3b", "hymba-1.5b",
                   "llama3-8b", "gemma2-9b", "olmo-1b", "qwen2-vl-72b",
                   "whisper-base", "xlstm-350m", "qwen2-moe-a2.7b")


def check_ported(arch: str) -> None:
    """Raise ``NotImplementedError``, naming its ROADMAP item, for an
    architecture the port does not serve yet."""
    if arch not in ARCH_IDS:
        raise NotImplementedError(
            f"--arch {arch}: the port serves {ARCH_IDS} so far (ROADMAP "
            f"A4)")


def make_prompts(n: int, prompt_len: int, vocab: int, seed: int = 1):
    """``n`` prompts of ``max(1, prompt_len // (1 + i % 3))`` tokens drawn
    uniformly from [5, vocab) (L, L/2, L/3: across bucket boundaries)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(5, vocab, max(1, prompt_len // (1 + i % 3))
                         ).tolist() for i in range(n)]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b", choices=REFERENCE_ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--reference", action="store_true",
                    help="also time the per-token host loop")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (the default, needs "
                         "a GPU) or cpu")
    return ap


def main(argv=None) -> dict:
    """Run the launcher; returns what it printed as numbers: tokens,
    seconds, waves, slot utilization, the outputs by request, and with
    ``--reference`` the two loops' tokens/s on one wave."""
    args = _parser().parse_args(argv)
    check_ported(args.arch)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = Model(cfg).init_params(seed=0, device=device,
                                    max_seq=args.max_len)
    eng = ServeEngine(cfg, params, max_len=args.max_len,
                      batch_size=args.batch, device=device)
    gen = GenerationParams(max_new_tokens=args.new_tokens,
                           temperature=args.temperature,
                           top_k=args.top_k, top_p=args.top_p)
    prompts = make_prompts(args.requests, args.prompt_len, cfg.vocab_size)

    queue = RequestQueue(eng, gen)
    rids = queue.submit_all(prompts)
    _sync(device)
    t0 = time.perf_counter()
    outs = queue.run()
    _sync(device)
    dt = time.perf_counter() - t0
    toks = sum(len(outs[r]) for r in rids)
    st = queue.stats
    print(f"generated {toks} tokens for {st.requests} requests in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s incl. first-call setup; {st.waves} "
          f"waves, slot utilization {st.slot_utilization:.0%}) on {device}")
    for i, r in enumerate(rids[:2]):
        print(f"  req{i}: {outs[r]}")
    result = {"tokens": toks, "seconds": dt, "waves": st.waves,
              "slot_utilization": st.slot_utilization,
              "buckets": [queue.result(r).bucket for r in rids],
              "outputs": [outs[r] for r in rids]}

    if args.reference:
        wave = prompts[:args.batch]
        (t_new, t_ref), agree = _time_loops(eng, wave, gen, device)
        n = len(wave) * args.new_tokens
        print(f"generate {n / t_new:.1f} tok/s vs generate_reference "
              f"{n / t_ref:.1f} tok/s -> {t_ref / t_new:.2f}x; tokens "
              f"{'agree' if agree else 'DIFFER'}")
        result.update(generate_tok_s=n / t_new, reference_tok_s=n / t_ref,
                      generate_s=t_new, reference_s=t_ref,
                      loops_agree=agree)
    return result


def _time_loops(eng: ServeEngine, wave, gen: GenerationParams, device):
    """Seconds of one ``generate`` and one ``generate_reference`` call on
    ``wave``, both warmed up first, and whether their tokens agree."""
    eng.generate(wave, gen=gen)
    eng.generate_reference(wave, gen=gen)
    times, outs = [], []
    for fn in (eng.generate, eng.generate_reference):
        _sync(device)
        t0 = time.perf_counter()
        outs.append(fn(wave, gen=gen))
        _sync(device)
        times.append(time.perf_counter() - t0)
    return times, outs[0] == outs[1]


if __name__ == "__main__":
    main()
