"""Policy-only PPO for online query identification (paper §IV-A).

The port of ``repro/core/ppo.py``.  Architecture (paper §V-A): four
fully-connected layers (256-128-64-action_dim) with batch normalization
and residual connections.  No critic/value network: the advantage
signal is the batch-standardized composite quality feedback (Eq. 10):

    f̄_i = (f_i - μ) / (σ + c),         c = 1e-8

and the objective is the clipped surrogate with an entropy bonus
(Eq. 11):

    L_f = E[min(ρ_i f̄_i, clip(ρ_i, 1±ε) f̄_i)] + β H(π_θ)

with ρ_i = π_θ(a_i|e_i) / π_θold(a_i|e_i).  Defaults follow the paper:
lr 3e-4, ε = 0.02.

What the reference does and this module keeps, exactly: weights in the
``[d_in, d_out]`` layout (``x @ w + b``); a hand-written batch norm
whose batch variance is ``ddof=0`` and already holds ``+1e-5``, to which
eval mode adds ``1e-5`` again; running stats kept with momentum 0.9 on
the old value (``nn.BatchNorm1d`` uses the opposite convention and an
unbiased running variance, so it is not used); the old policy's
log-probs from eval mode; after an update, the running stats of that
epoch's train forward; Adam with b1 0.9, b2 0.999, eps 1e-8.  The
policy is drawn from a seeded CPU ``torch.Generator`` and then moved to
its device, so a seed gives the same policy on the CPU and the card (not
the reference's numbers: ``bridge.policy_from_numpy`` carries those).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device

HIDDEN = (256, 128, 64)
BN_MOMENTUM = 0.9     # weight of the old running stat
BN_EPS = 1e-5


class PolicyLayer(nn.Module):
    """``x @ w + b``; a hidden layer adds batch norm, ReLU and a residual
    projection of its input (dims shrink, so the skip path is projected).
    Parameter and buffer names are the reference's pytree keys."""

    def __init__(self, d_in: int, d_out: int, hidden: bool,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden = hidden
        self.w = nn.Parameter(torch.randn(d_in, d_out, generator=generator)
                              * math.sqrt(2.0 / d_in))
        self.b = nn.Parameter(torch.zeros(d_out))
        if hidden:
            self.bn_g = nn.Parameter(torch.ones(d_out))
            self.bn_b = nn.Parameter(torch.zeros(d_out))
            self.register_buffer("bn_mu", torch.zeros(d_out))
            self.register_buffer("bn_var", torch.ones(d_out))
            self.res = nn.Parameter(
                torch.randn(d_in, d_out, generator=generator)
                * math.sqrt(1.0 / d_in))

    def forward(self, h: torch.Tensor, train: bool = False) -> torch.Tensor:
        z = h @ self.w + self.b
        if not self.hidden:
            return z
        if train:
            mu = z.mean(0)
            var = z.var(0, unbiased=False) + BN_EPS
            with torch.no_grad():
                self.bn_mu.copy_(BN_MOMENTUM * self.bn_mu
                                 + (1 - BN_MOMENTUM) * mu)
                self.bn_var.copy_(BN_MOMENTUM * self.bn_var
                                  + (1 - BN_MOMENTUM) * var)
        else:
            mu, var = self.bn_mu, self.bn_var + BN_EPS
        hn = (z - mu) / torch.sqrt(var)
        return torch.relu(hn * self.bn_g + self.bn_b) + h @ self.res


class Policy(nn.Module):
    """The identifier's policy network: embeddings [B, D] -> logits
    [B, N].  ``forward(e, train=True)`` normalizes by the batch's stats
    and updates the running stats in place, as the reference's train
    forward returns them."""

    def __init__(self, embed_dim: int, n_actions: int,
                 hidden: Sequence[int] = HIDDEN,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = (embed_dim,) + tuple(hidden) + (n_actions,)
        self.layers = nn.ModuleList(
            PolicyLayer(dims[i], dims[i + 1], i < len(dims) - 2, generator)
            for i in range(len(dims) - 1))

    def forward(self, e: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = e
        for layer in self.layers:
            h = layer(h, train)
        return h


def init_policy(seed: int, embed_dim: int, n_actions: int,
                device: DeviceLike = "cuda") -> Policy:
    """A policy drawn from ``seed`` on the CPU, then moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    return Policy(embed_dim, n_actions, generator=gen).to(
        resolve_device(device))


def policy_logits(policy: Policy, e: torch.Tensor, train: bool = False
                  ) -> torch.Tensor:
    """e: [B, D] -> logits [B, N]; train mode also updates the running
    batch-norm stats (the reference returns them as new params)."""
    return policy(e, train=train)


@torch.no_grad()
def act_probs(policy: Policy, e: torch.Tensor) -> torch.Tensor:
    return torch.softmax(policy(e, train=False), dim=-1)


def standardize_feedback(f: torch.Tensor, c: float = 1e-8) -> torch.Tensor:
    """Eq. 10 — batch-standardized reward (population std)."""
    return (f - f.mean()) / (f.std(unbiased=False) + c)


def init_adam(policy: Policy, lr: float = 3e-4) -> torch.optim.Adam:
    """Adam over the policy's parameters (the paper's 3e-4 is an
    Adam-scale learning rate); the running stats are buffers, not
    parameters, as their zero gradients leave them alone in the
    reference's Adam."""
    return torch.optim.Adam(policy.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def ppo_update(policy: Policy, old_policy: Policy, opt: torch.optim.Adam,
               e: torch.Tensor, actions: torch.Tensor, f: torch.Tensor, *,
               eps: float = 0.02, beta: float = 0.01) -> Dict[str, float]:
    """One clipped-surrogate Adam step on a feedback batch, in place.

    e [B,D], actions [B] int, f [B] raw composite quality scores.  The
    gradient comes from autograd; the running stats end as this train
    forward left them.  Returns {"loss", "entropy", "rho"}."""
    adv = standardize_feedback(f)
    rows = actions.long()[:, None]
    with torch.no_grad():
        old_logp = torch.log_softmax(old_policy(e, train=False), dim=-1
                                     ).gather(1, rows)[:, 0]
    logp_all = torch.log_softmax(policy(e, train=True), dim=-1)
    logp = logp_all.gather(1, rows)[:, 0]
    rho = torch.exp(logp - old_logp)
    surr = torch.minimum(rho * adv, torch.clamp(rho, 1 - eps, 1 + eps) * adv)
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    loss = -(surr.mean() + beta * entropy)
    opt.zero_grad()
    loss.backward()
    opt.step()
    return {"loss": loss.item(), "entropy": entropy.item(),
            "rho": rho.mean().item()}
