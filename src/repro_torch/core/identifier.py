"""Online query identifier (paper §IV-A): PPO policy + feedback buffer.

The port of ``repro/core/identifier.py``.  Maps query embeddings to
node-relevance probability vectors s_i in Δ^N, samples routing actions,
accumulates (embedding, action, feedback) triples in a memory buffer,
and triggers a batched PPO update whenever the buffer passes a threshold
(decoupling updates from transient fluctuations; paper: ~30 ms per 1000
queries, threshold set from the long-horizon average query load).

The policy and its Adam state live on ``device``.  Action sampling keeps
the reference's numpy ``default_rng(seed)``, so both packages sample the
same actions from the same probabilities.
"""
from __future__ import annotations

import copy
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import ppo
from repro_torch.device import DeviceLike, resolve_device


class OnlineQueryIdentifier:
    def __init__(self, embed_dim: int, n_nodes: int, *, seed: int = 0,
                 update_threshold: int = 256, update_epochs: int = 4,
                 lr: float = 3e-4, clip_eps: float = 0.02,
                 entropy_beta: float = 0.01, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.n_nodes = n_nodes
        self.update_threshold = update_threshold
        self.update_epochs = update_epochs
        self.lr, self.clip_eps, self.entropy_beta = lr, clip_eps, entropy_beta
        self.load_policy(ppo.init_policy(seed, embed_dim, n_nodes,
                                         device=self.device))
        self._buf_e: List[np.ndarray] = []
        self._buf_a: List[np.ndarray] = []
        self._buf_f: List[np.ndarray] = []
        self.updates_done = 0
        self._rng = np.random.default_rng(seed)

    def load_policy(self, policy: ppo.Policy) -> None:
        """Serve ``policy`` (moved to the identifier's device) with a
        fresh Adam state, as a new identifier starts."""
        self.policy = policy.to(self.device)
        self.old_policy = copy.deepcopy(self.policy)
        self.opt = ppo.init_adam(self.policy, self.lr)

    # -------------------------------------------------------------- routing

    def identify(self, embeddings: np.ndarray) -> np.ndarray:
        """[B, D] -> probability vectors S^t [B, N] (Σ_n s_in = 1)."""
        e = torch.as_tensor(np.asarray(embeddings, np.float32),
                            device=self.device)
        return ppo.act_probs(self.policy, e).cpu().numpy()

    def sample_actions(self, probs: np.ndarray) -> np.ndarray:
        cum = probs.cumsum(axis=1)
        r = self._rng.random((probs.shape[0], 1))
        return (r > cum).sum(axis=1).clip(0, self.n_nodes - 1)

    # ------------------------------------------------------------- feedback

    def feedback(self, embeddings: np.ndarray, actions: np.ndarray,
                 scores: np.ndarray) -> None:
        """Record composite quality feedback f_i (Eq. 9) for routed queries."""
        self._buf_e.append(np.asarray(embeddings, np.float32))
        self._buf_a.append(np.asarray(actions, np.int32))
        self._buf_f.append(np.asarray(scores, np.float32))

    def buffered(self) -> int:
        return int(sum(len(a) for a in self._buf_a))

    def maybe_update(self) -> Optional[dict]:
        if self.buffered() < self.update_threshold:
            return None
        dev = self.device
        e = torch.as_tensor(np.concatenate(self._buf_e), device=dev)
        a = torch.as_tensor(np.concatenate(self._buf_a), device=dev)
        f = torch.as_tensor(np.concatenate(self._buf_f), device=dev)
        self._buf_e, self._buf_a, self._buf_f = [], [], []
        self.old_policy = copy.deepcopy(self.policy)
        metrics = {}
        for _ in range(self.update_epochs):   # batch reuse via CLIP (Eq. 11)
            metrics = ppo.ppo_update(self.policy, self.old_policy, self.opt,
                                     e, a, f, eps=self.clip_eps,
                                     beta=self.entropy_beta)
        self.updates_done += 1
        return metrics
