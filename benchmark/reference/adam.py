"""Adam written out, as the program's optimizer is configured
(train/optimizer.py: torch.optim.Adam with the decay folded into the
gradient, or AdamW with the decay applied to the parameter; beta1, beta2
and eps from the configuration; one learning rate per leaf, the step's rate
times the leaf's scale)."""

from __future__ import annotations

import torch


class PlainAdam:
    def __init__(self, leaves: dict, b1: float, b2: float, eps: float,
                 weight_decay: float, mode: str):
        if mode not in ("folded", "decoupled"):
            raise ValueError(f"unknown weight_decay_mode {mode!r}")
        self.leaves, self.mode = leaves, mode
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.m = {k: torch.zeros_like(p) for k, p in leaves.items()}
        self.v = {k: torch.zeros_like(p) for k, p in leaves.items()}
        self.t = 0

    def moment_grad(self, key: str) -> torch.Tensor:
        """The gradient as the first moment holds it after the first step:
        m / (1 - beta1) (with the folded decay inside)."""
        return self.m[key] / (1.0 - self.b1)

    @torch.no_grad()
    def step(self, lrs: dict) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for k, p in self.leaves.items():
            g = p.grad
            lr = lrs[k]
            if self.mode == "folded":
                g = g + self.wd * p
            else:
                p.mul_(1.0 - lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k] / bc2).sqrt() + self.eps
            p.sub_(lr / bc1 * self.m[k] / denom)
