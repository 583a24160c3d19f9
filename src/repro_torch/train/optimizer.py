"""AdamW and the cosine learning-rate schedule, from scratch.

Counterpart of ``repro/train/optimizer.py``, line for line: a global-norm
clip over every gradient leaf in f32, f32 moments (b1 0.9, b2 0.95, eps
1e-8), bias correction, decoupled weight decay on the f32 parameter, then
a cast back to the parameter's dtype.  The schedule is computed in f32
from the step count, as the reference's ``step.astype(float32)``.

Parameters, gradients and moments are trees of dicts and lists of
tensors (the model's parameter layout).  ``adamw_update`` is functional:
it returns new parameters and a new state and leaves its inputs alone.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Union

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar: the updates taken
    mu: dict
    nu: dict


def adamw_init(params) -> AdamWState:
    """Zero f32 moments shaped like ``params`` and step 0."""
    zeros = lambda: tree_map(lambda a: torch.zeros(
        a.shape, dtype=torch.float32, device=a.device), params)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros(), nu=zeros())


def adamw_update(grads, state: AdamWState, params, *,
                 lr: Union[float, Callable], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0,
                 sq_norm: Callable = None):
    """Returns (new_params, new_state).  ``lr`` is a number or a
    callable of the (incremented) step tensor.  ``sq_norm(grads)`` gives
    the clip's squared global norm when ``grads`` are a rank's shards of
    the whole gradient (``TensorParallel.grad_sq_norm``); by default
    the sum of every leaf's squares."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    # global-norm clip
    if sq_norm is None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in tree_leaves(grads)))
    else:
        gnorm = torch.sqrt(sq_norm(grads))
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    grads = tree_map(lambda g: g.float() * scale, grads)

    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, m, v):
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        u = u + weight_decay * p.float()
        return (p.float() - lr_t * u).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, AdamWState(step=step, mu=mu, nu=nu)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    to ``floor_frac * peak_lr`` at ``total``; a function of the step
    tensor, in f32."""
    def lr(step):
        step = step.float()
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr
