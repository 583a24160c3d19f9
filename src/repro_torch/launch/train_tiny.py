"""Train a tiny LM on the synthetic DomainQA corpus (RAG-format
supervision: context + question -> answer) and save it for
``cluster_serve --ckpt``.

The port's counterpart of ``examples/train_tiny.py`` (which stays the
reference's): the same corpus (``generate_corpus(40, seed=0)``),
tokenizer (``max_vocab=4096``), rows (gold document and two shuffled
distractors, loss only on the answer span), ``SEQ`` = 192, the smoke
config at ``max_d_model=256`` and ``cosine_schedule(3e-3, warmup=20)``
without remat; the batches are the reference's (numpy
``default_rng(0)``), the initial weights the port's (seed 0).  It writes
``<out>.npz`` (the reference's checkpoint format) and
``<out>_vocab.json``:

    PYTHONPATH=src python -m repro_torch.launch.train_tiny --steps 300
    PYTHONPATH=src python -m repro_torch.launch.cluster_serve --smoke \\
        --nodes 2 --slots 2 --ckpt experiments/tiny_lm.npz
"""
import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.corpus import generate_corpus
from repro_torch.data.tokenizer import EOS, Tokenizer
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.rag.pipeline import build_prompt
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import cosine_schedule
from repro_torch.train.train_step import init_opt_state, make_train_step

SEQ = 192


def make_dataset(tok, docs, qas, rng):
    """(tokens, mask) rows: loss only on the answer span.  Contexts =
    gold doc + 2 shuffled distractors, matching the serving distribution
    (top-k retrieval returns distractors too)."""
    by_id = {d.doc_id: d for d in docs}
    rows = []
    for qa in qas:
        ctx = [by_id[qa.doc_id].text] + [
            docs[i].text for i in rng.choice(len(docs), 2, replace=False)]
        rng.shuffle(ctx)
        prompt = build_prompt(qa.question, ctx)
        p_ids = tok.encode(prompt, bos=True)
        a_ids = tok.encode(qa.answer) + [EOS]
        ids = (p_ids + a_ids)[:SEQ + 1]
        pad = SEQ + 1 - len(ids)
        mask = [0] * (len(p_ids) - 1) + [1] * len(a_ids)
        mask = (mask + [0] * pad)[:SEQ]
        ids = ids + [0] * pad
        rows.append((ids, mask))
    return rows


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default="experiments/tiny_lm.npz")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default, needs a GPU) or cpu")
    return ap


def main(argv=None) -> dict:
    """Train and save; returns {"losses", "seconds", "out", "cfg"}."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    docs, qas = generate_corpus(40, seed=0)
    texts = [d.text for d in docs] + [q.question for q in qas] \
        + [q.answer for q in qas] + ["context : question : answer : <sep>"]
    tok = Tokenizer.build(texts, max_vocab=4096)
    cfg = get_smoke_config(args.arch, max_d_model=256, vocab=len(tok))
    print(f"model: {cfg.name} d={cfg.d_model} vocab={cfg.vocab_size}")
    model = Model(cfg)
    params = model.init_params(seed=0, device=dev, max_seq=SEQ)
    opt = init_opt_state(params)
    lr = cosine_schedule(3e-3, warmup=20, total=args.steps)
    step_fn = make_train_step(model, lr=lr, remat=False)

    rng = np.random.default_rng(0)
    rows = make_dataset(tok, docs, qas, rng)
    pos = torch.arange(SEQ, dtype=torch.int32, device=dev).expand(
        args.batch, SEQ)
    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        idx = rng.choice(len(rows), args.batch)
        ids = torch.as_tensor(np.stack([rows[i][0] for i in idx]),
                              device=dev)
        msk = torch.as_tensor(np.stack([rows[i][1] for i in idx]),
                              device=dev)
        batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:],
                 "loss_mask": msk, "positions": pos}
        params, opt, m = step_fn(params, opt, batch)
        if step % 25 == 0 or step == args.steps - 1:
            losses.append((step, float(m["loss"])))
            print(f"step {step:4d}  loss {losses[-1][1]:.4f}  "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    seconds = time.perf_counter() - t0
    checkpoint.save(args.out, params, cfg)
    with open(os.path.splitext(args.out)[0] + "_vocab.json", "w") as f:
        json.dump(tok.vocab, f)
    print(f"saved {args.out} (+_vocab.json)")
    return {"losses": losses, "seconds": seconds, "out": args.out,
            "cfg": cfg}


if __name__ == "__main__":
    main()
