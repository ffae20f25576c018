"""AdamUniform, the reference trainer's optimizer (utils/optimizer.py):
Adam's moments with bias correction, the step divided by the largest
sqrt of the second moment over each leaf, rescaled so that its largest
component is at most the grad limit, times a cosine-annealed learning rate
(eta_min 1e-4). The limit's stage pointer never moves in three steps."""

from __future__ import annotations

import math

import torch


class AdamUniform:
    def __init__(self, lr: float, total_steps: int, limit: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr0, self.T, self.limit = float(lr), max(int(total_steps), 1), \
            float(limit)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.m = self.v = None

    def lr(self, count: int) -> torch.Tensor:
        t = torch.tensor(float(min(count, self.T)), dtype=torch.float32)
        phase = math.pi * t / torch.tensor(float(self.T))
        return 1e-4 + (self.lr0 - 1e-4) * 0.5 * (1.0 + torch.cos(phase))

    def step(self, params: list, grads: list) -> list:
        """New parameters (a list of leaves) after one step."""
        if self.m is None:
            self.m = [torch.zeros_like(g) for g in grads]
            self.v = [torch.zeros_like(g) for g in grads]
        lr = self.lr(self.count).to(grads[0].device)
        self.count += 1
        b1c = 1.0 - torch.pow(torch.tensor(self.b1), float(self.count))
        b2c = 1.0 - torch.pow(torch.tensor(self.b2), float(self.count))
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.m[i] = self.b1 * self.m[i] + (1.0 - self.b1) * g
            self.v[i] = self.b2 * self.v[i] + (1.0 - self.b2) * g * g
            step = (self.m[i] / b1c.to(g.device)) / (
                self.eps + torch.sqrt(torch.max(self.v[i] / b2c.to(g.device))))
            s = torch.max(torch.abs(step))
            step = torch.where(s > self.limit,
                               step * (self.limit / torch.clamp_min(s, 1e-30)),
                               step)
            out.append(p - lr * step)
        return out
