"""Plain SGD with momentum (the minimal-traffic reference point of the
paper's optimizer characterization). Counterpart of ``repro.optim.sgd``;
updates in place under ``torch.no_grad()``."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .. import tree


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    learning_rate: float = 1e-2
    momentum: float = 0.9
    zero1: bool = False
    weight_decay: float = 0.0


def init(cfg: SGDConfig, params) -> Dict:
    first = tree.leaves(params)[0]
    state = {"step": torch.zeros((), dtype=torch.int32, device=first.device)}
    if cfg.momentum != 0.0:
        state["m"] = tree.map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state


@torch.no_grad()
def update(cfg: SGDConfig, grads, state: Dict, params) -> Tuple:
    ms = tree.leaves(state["m"]) if "m" in state else None
    for i, (p, g) in enumerate(zip(tree.leaves(params),
                                   tree.leaves(grads))):
        g32 = g.float() + cfg.weight_decay * p.float()
        if ms is not None:
            ms[i].copy_(cfg.momentum * ms[i] + g32)
            g32 = ms[i]
        p.copy_(p.float() - cfg.learning_rate * g32)
    state["step"].add_(1)
    return params, state
