"""The train step: loss, gradients and the AdamW update.

Counterpart of ``repro/train/train_step.py``.  ``make_train_step(model)``
returns ``train_step(params, opt_state, batch) -> (params, opt_state,
metrics)``; PyTorch runs it eagerly (there is no ``jit``).  A batch is a
dict of tensors: ``tokens`` and ``labels`` [B, S], ``positions`` [B, S]
(or M-RoPE's [3, B, S]), optionally ``loss_mask`` [B, S],
``vision_embeds`` [B, Nv, D] and ``encoder_frames`` [B, Se, D].

On the card every attention of the forward launches
``csrc/flash_attention.cu`` and its gradient ``csrc/flash_attention_bwd.cu``
(``kernels.ops.FlashAttention``); the head, the fused cross-entropy's
chunked products, the MoE products and the optimizer are PyTorch
operators, as the reference leaves them to XLA.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.model import Model
from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                         tree_leaves, tree_map)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token NLL.  logits [B,S,V] (cast to f32), labels [B,S]."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# fused, sequence-chunked cross entropy
#
# Loss AND gradients chunk by chunk over the sequence: never more than
# [B, CE_CHUNK, V] logits at once (at olmo-1b's vocab of 50304 the full
# [B, S, V] f32 logits of a 4 x 256 batch would be 206 MB, of a 4k
# sequence 3.3 GB a row).

CE_CHUNK = 256


def _ce_chunks(x, labels, mask):
    """Pad S to a multiple of CE_CHUNK (labels 0, mask 0) and cut into
    n chunks -> (xs [n,B,C,D], ls [n,B,C], ms [n,B,C])."""
    B, S, _ = x.shape
    pad = (-S) % CE_CHUNK
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    n = x.shape[1] // CE_CHUNK
    rs = lambda a: a.reshape((B, n, CE_CHUNK) + a.shape[2:]).transpose(0, 1)
    return rs(x), rs(labels), rs(mask)


def _chunk_logits(xc, head, softcap):
    """(f32 logits of a chunk, tanh(raw / softcap) or None)."""
    raw = (xc @ head).float()
    if not softcap:
        return raw, None
    th = torch.tanh(raw / softcap)
    return softcap * th, th


class FusedCrossEntropy(torch.autograd.Function):
    """x [B,S,D], head [D,V], labels [B,S], mask [B,S] -> mean NLL over
    the masked positions; the gradients of x and head, computed chunk by
    chunk in the backward pass (f32 products, the softcap's chain rule),
    as the reference's custom VJP."""

    @staticmethod
    def forward(ctx, x, head, labels, mask, softcap):
        xs, ls, ms = _ce_chunks(x, labels, mask)
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for xc, lc, mc in zip(xs, ls, ms):
            logits, _ = _chunk_logits(xc, head, softcap)
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
            m = mc.float()
            tot = tot + ((lse - gold) * m).sum()
            cnt = cnt + m.sum()
        ctx.save_for_backward(x, head, labels, mask)
        ctx.softcap = softcap
        return tot / torch.clamp(cnt, min=1.0)

    @staticmethod
    def backward(ctx, g):
        x, head, labels, mask = ctx.saved_tensors
        softcap = ctx.softcap
        xs, ls, ms = _ce_chunks(x, labels, mask)
        cnt = torch.clamp(mask.float().sum(), min=1.0)
        head32 = head.float()
        dhead = torch.zeros(head.shape, dtype=torch.float32,
                            device=head.device)
        dxs = []
        for xc, lc, mc in zip(xs, ls, ms):
            logits, th = _chunk_logits(xc, head, softcap)
            dl = torch.softmax(logits, dim=-1)
            dl.scatter_add_(-1, lc.long()[..., None],
                            torch.full(lc.shape + (1,), -1.0,
                                       device=dl.device))   # p - one_hot
            dl = dl * (mc.float() * g / cnt)[..., None]
            if th is not None:
                dl = dl * (1.0 - torch.square(th))
            dxs.append((dl @ head32.T).to(x.dtype))
            dhead = dhead + torch.einsum("bcd,bcv->dv", xc.float(), dl)
        B, S, D = x.shape
        dx = torch.stack(dxs).transpose(0, 1).reshape(B, -1, D)[:, :S]
        return dx, dhead.to(head.dtype), None, None, None


def fused_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                        labels: torch.Tensor, mask: torch.Tensor,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """x [B,S,D], head [D,V], labels [B,S], mask [B,S] -> mean NLL."""
    return FusedCrossEntropy.apply(x, head, labels, mask, softcap)


def _forward_kw(batch: dict) -> dict:
    return {k: batch[k] for k in ("vision_embeds", "encoder_frames")
            if batch.get(k) is not None}


def make_loss_fn(model: Model, remat: bool = False,
                 fused_ce: bool = True) -> Callable:
    """``loss_fn(params, batch) -> (loss + aux, (loss, aux))``: the mean
    NLL of ``labels`` at the last S columns (after a vision prefix) plus
    the MoE load-balance loss."""
    softcap = model.cfg.final_logit_softcap

    def loss_fn(params, batch):
        labels = batch["labels"]
        S = labels.shape[1]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones_like(labels)
        if fused_ce:
            feats, aux = model.forward(params, batch["tokens"],
                                       batch["positions"],
                                       return_features=True, return_aux=True,
                                       remat=remat, **_forward_kw(batch))
            loss = fused_cross_entropy(feats[:, -S:], model.lm_head(params),
                                       labels, mask, softcap)
        else:
            logits, aux = model.forward(params, batch["tokens"],
                                        batch["positions"], return_aux=True,
                                        remat=remat, **_forward_kw(batch))
            loss = cross_entropy(logits[:, -S:], labels,
                                 batch.get("loss_mask"))
        return loss + aux, (loss, aux)
    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch):
    """((total, (loss, aux)), grads): ``jax.value_and_grad(loss_fn,
    has_aux=True)``'s counterpart.  Gradients take each parameter's
    shape and dtype; a parameter the loss does not reach gets zeros."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    total, (loss, aux) = loss_fn(live, batch)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return ((total.detach(), (loss.detach(), aux.detach())),
            tree_map(lambda _: next(it), params))


def _split(key: str, a: torch.Tensor, n: int):
    """``a`` cut into ``n`` microbatches along the batch axis: axis 0,
    or axis 1 of M-RoPE positions [3, B, S]."""
    dim = 1 if key == "positions" and a.dim() == 3 and a.shape[0] == 3 \
        else 0
    return a.chunk(n, dim=dim)


def make_train_step(model: Model, lr=3e-4, weight_decay: float = 0.1,
                    remat: bool = True, microbatch: int = 1) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics {"loss", "aux_loss", "total_loss"} (f32
    scalars).  ``microbatch`` > 1 splits the batch into that many
    gradient-accumulation steps (f32 sums, divided by their count),
    which bounds live activation memory to one microbatch.  ``remat``
    checkpoints each decoder layer."""
    loss_fn = make_loss_fn(model, remat=remat)

    def train_step(params, opt_state, batch):
        if microbatch == 1:
            (total, (loss, aux)), grads = value_and_grad(loss_fn, params,
                                                         batch)
        else:
            B = batch["labels"].shape[0]
            if B % microbatch:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatch} microbatches")
            parts = {k: _split(k, a, microbatch) for k, a in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            total = loss = aux = torch.zeros((), dtype=torch.float32,
                                             device=batch["labels"].device)
            for i in range(microbatch):
                mb = {k: v[i] for k, v in parts.items()}
                (t, (l, a)), g = value_and_grad(loss_fn, params, mb)
                grads = tree_map(torch.add, grads, g)
                total, loss, aux = total + t, loss + l, aux + a
            grads = tree_map(lambda g: g / microbatch, grads)
            total, loss, aux = (total / microbatch, loss / microbatch,
                                aux / microbatch)
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr,
                                         weight_decay=weight_decay)
        metrics = {"loss": loss, "aux_loss": aux, "total_loss": total}
        return params, opt_state, metrics

    return train_step


def init_opt_state(params):
    return adamw_init(params)
