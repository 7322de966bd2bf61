"""AdamW with decoupled weight decay (the paper's Fig. 13 comparison
optimizer). Counterpart of ``repro.optim.adamw`` with ``zero1=False``: fp32
``m``/``v``, the update computed in fp32 and cast into the parameter's
dtype, in place under ``torch.no_grad()``."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .. import tree
from ..core.optrace import scope


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    zero1: bool = True


def init(cfg: AdamWConfig, params) -> Dict:
    if cfg.zero1:
        raise NotImplementedError("AdamW zero1=True: the ZeRO layout not "
                                  "ported")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = tree.leaves(params)[0]
    return {"m": tree.map(zeros, params), "v": tree.map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def update(cfg: AdamWConfig, grads, state: Dict, params) -> Tuple:
    with scope("adamw"):
        return _update(cfg, grads, state, params)


@torch.no_grad()
def _update(cfg: AdamWConfig, grads, state: Dict, params) -> Tuple:
    state["step"].add_(1)
    t = state["step"].float()
    c1 = 1.0 / (1.0 - torch.pow(cfg.beta1, t))
    c2 = 1.0 / (1.0 - torch.pow(cfg.beta2, t))
    for p, g, m, v in zip(*(tree.leaves(x) for x in (params, grads,
                                                     state["m"],
                                                     state["v"]))):
        w32, g32 = p.float(), g.float()
        m.copy_(cfg.beta1 * m + (1 - cfg.beta1) * g32)
        v.copy_(cfg.beta2 * v + (1 - cfg.beta2) * torch.square(g32))
        u = (m * c1) / (torch.sqrt(v * c2) + cfg.eps)
        p.copy_(w32 - cfg.learning_rate * (u + cfg.weight_decay * w32))
    return params, state
