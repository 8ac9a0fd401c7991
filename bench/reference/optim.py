"""AdamW and DiLoCo's Nesterov outer step, as the configuration states.

Parameters are held in the configuration's dtype; every update is
worked out in float32 and cast to that dtype before it is added (a
bfloat16 parameter gets a bfloat16 add).  AdamW: m = b1 m + (1 - b1) g,
v = b2 v + (1 - b2) g^2, bias corrections 1 / (1 - b^t) in float32,
update -lr (m_hat / (sqrt(v_hat) + eps) + wd p).  Outer: the
pseudo-gradient delta = x - mean_m(x_m) in float32, momentum
m = mu m + delta, update -lr (mu m + delta).
"""
from __future__ import annotations

from typing import Dict, List

import torch

Leaves = Dict[str, torch.Tensor]


class AdamW:
    def __init__(self, params: Leaves, lr: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = (lr, weight_decay,
                                                        b1, b2, eps)
        self.m = {k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for k, p in params.items()}
        self.v = {k: torch.zeros_like(t) for k, t in self.m.items()}
        self.t = 0

    def _corr(self, b: float) -> float:
        t = torch.tensor(float(self.t), dtype=torch.float32)
        return float(1.0 / (1.0 - torch.pow(torch.tensor(b), t)))

    @torch.no_grad()
    def step(self, params: Leaves, grads: Leaves) -> Leaves:
        """New parameters (the configured dtype) from f32 ``grads``."""
        self.t += 1
        mh, vh = self._corr(self.b1), self._corr(self.b2)
        out = {}
        for k, p in params.items():
            g = grads[k].float()
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = self.m[k] * mh / (torch.sqrt(self.v[k] * vh) + self.eps)
            upd = -self.lr * (upd + self.wd * p.float())
            out[k] = p + upd.to(p.dtype)
        return out


@torch.no_grad()
def nesterov_first(x: Leaves, workers: List[Leaves], lr: float,
                   momentum: float) -> Leaves:
    """The first outer step (zero momentum state) from ``x`` and the
    workers' parameters."""
    out = {}
    for k, p in x.items():
        mean = sum(w[k].float() for w in workers) / len(workers)
        delta = p.float() - mean
        upd = -lr * (momentum * delta + delta)
        out[k] = p + upd.to(p.dtype)
    return out
