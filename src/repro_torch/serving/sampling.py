"""Token sampling shared by prefill and decode.

Counterpart of ``repro/serving/sampling.py``.  Greedy decoding is
``argmax`` with the first index on ties, exactly as the reference.
Sampled decoding draws from a ``torch.Generator``: the filters
(temperature, then top-k, then top-p) match the reference, but the
random stream differs from ``jax.random``, so sampled outputs agree with
the reference only in distribution.  Where the reference folds a step
or wave index into a PRNG key (``jax.random.fold_in``), the port folds
it into an integer seed (``fold_seed``) and draws from a generator
seeded with the result (``step_generator``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

_NEG_INF = -1e30


@dataclass(frozen=True)
class GenerationParams:
    """Generation controls for one request / batch.

    temperature <= 0 means greedy; top_k == 0 and top_p >= 1.0 disable
    the respective filters.  ``eos_id`` is the stop token (None = run to
    ``max_new_tokens``); an emitted EOS is included in the output."""
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None


def fold_seed(seed: int, i: int) -> int:
    """A seed derived from ``seed`` and an index (a decode step, a wave, a
    scheduler slot): the port's counterpart of ``fold_in``."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1)[0])


def step_generator(gp: "GenerationParams", seed: int, i: int,
                   device) -> Optional[torch.Generator]:
    """The generator a sampled draw at index ``i`` uses, seeded with
    ``fold_seed(seed, i)`` on ``device``; None for greedy decoding, which
    draws nothing."""
    if gp.temperature <= 0.0:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(fold_seed(seed, i))
    return g


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit (per row)."""
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < thresh, torch.full_like(logits, _NEG_INF),
                       logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of the sorted
    distribution with cumulative probability >= p (always >= 1 token)."""
    srt = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < p
    keep[..., 0] = True
    thresh = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                         ).min(dim=-1, keepdim=True).values
    return torch.where(logits < thresh, torch.full_like(logits, _NEG_INF),
                       logits)


def sample_token(logits: torch.Tensor, gp: GenerationParams,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """[B,V] logits -> [B,1] int32 next token."""
    if gp.temperature <= 0.0:
        return torch.argmax(logits, dim=-1, keepdim=True).to(torch.int32)
    lg = logits.float() / gp.temperature
    if gp.top_k > 0:
        lg = apply_top_k(lg, min(gp.top_k, lg.shape[-1]))
    if gp.top_p < 1.0:
        lg = apply_top_p(lg, gp.top_p)
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)
