"""AdamW with optax's semantics (the JAX package's `make_optimizer`,
training/train_step.py: `optax.adamw` with `mu_dtype`).

torch.optim.AdamW cannot store the first moment in another dtype than the
parameter, and applies the weight decay in another order. This one follows
`optax.chain(scale_by_adam(mu_dtype), add_decayed_weights, scale(-lr))`
step for step:
    mu    = (1 - b1) g + b1 mu            (b1 mu in mu's stored dtype)
    nu    = (1 - b2) g^2 + b2 nu          (fp32)
    u     = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
    p    <- p - lr u,      mu stored in mu_dtype
The parameters are updated in place.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..core.config import TrainConfig
from ..core.dtypes import resolve_dtype


class AdamW:
    def __init__(self, params: Sequence[torch.Tensor], learning_rate: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4,
                 mu_dtype: torch.dtype = torch.float32):
        self.params: List[torch.Tensor] = list(params)
        self.lr = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def _bias_correction(self, decay: float) -> float:
        # optax: 1 - decay ** count in fp32
        return float(np.float32(1.0) - np.float32(decay) ** np.float32(
            self.count))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.count += 1
        c1 = self._bias_correction(self.b1)
        c2 = self._bias_correction(self.b2)
        lr = float(np.float32(self.lr))
        # jax rounds a Python scalar to the array's dtype before using it:
        # b1 * mu is a product of two bf16 numbers when mu is stored in bf16
        b1_mu = float(torch.tensor(self.b1, dtype=self.mu[0].dtype)) \
            if self.mu else self.b1
        for i, (p, g) in enumerate(zip(self.params, grads)):
            mu = (1 - self.b1) * g + b1_mu * self.mu[i]
            nu = (1 - self.b2) * g.square() + self.b2 * self.nu[i]
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            u = u + self.weight_decay * p
            p.copy_(p + (-lr) * u)
            self.mu[i] = mu.to(self.mu[i].dtype)
            self.nu[i] = nu


def make_optimizer(config: TrainConfig,
                   params: Sequence[torch.Tensor]) -> AdamW:
    return AdamW(params, config.learning_rate, b1=config.adam_b1,
                 b2=config.adam_b2, eps=config.adam_eps,
                 weight_decay=config.weight_decay,
                 mu_dtype=resolve_dtype(config.mu_dtype))
