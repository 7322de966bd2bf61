"""AdamW with decoupled weight decay (the paper's Fig. 13 comparison
optimizer). Counterpart of ``repro.optim.adamw``: fp32 ``m``/``v``, the
update computed in fp32 and cast into the parameter's dtype, in place
under ``torch.no_grad()``. With ``zero1`` (JAX's default) ``m`` and ``v``
are held in the ZeRO flat layout with one row a JAX leaf (``zero.Plan``
with ``layer_rows=False``), or a data-parallel rank's columns of it; as in
JAX there is no master copy: each step flattens the parameters into fp32,
updates the rank's columns and the plan's ``all_gather`` writes them back
into every rank's parameters."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .. import tree
from ..core.optrace import scope
from . import zero


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    zero1: bool = True


def _plan(params, plan: Optional[zero.Plan]) -> zero.Plan:
    return plan or zero.Plan(params, layer_rows=False)


def init(cfg: AdamWConfig, params, plan: Optional[zero.Plan] = None) -> Dict:
    first = tree.leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if cfg.zero1:
        plan = _plan(params, plan)
        return {"m": plan.zeros(first.device),
                "v": plan.zeros(first.device), "step": step}

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree.map(zeros, params), "v": tree.map(zeros, params),
            "step": step}


def update(cfg: AdamWConfig, grads, state: Dict, params,
           plan: Optional[zero.Plan] = None) -> Tuple:
    """One AdamW step, in place; with ``zero1`` ``grads`` as
    ``zero.Plan.grad_shards`` takes them."""
    with scope("adamw"):
        return _update(cfg, grads, state, params,
                       _plan(params, plan) if cfg.zero1 else None)


@torch.no_grad()
def _update(cfg: AdamWConfig, grads, state: Dict, params,
            plan: Optional[zero.Plan]) -> Tuple:
    state["step"].add_(1)
    t = state["step"].float()
    c1 = 1.0 / (1.0 - torch.pow(cfg.beta1, t))
    c2 = 1.0 / (1.0 - torch.pow(cfg.beta2, t))
    if plan is not None:        # this rank's columns of the flat leaves
        ws, gs = plan.shards(params), plan.grad_shards(grads)
    else:
        ws, gs = tree.leaves(params), tree.leaves(grads)
    for i, (w, g, m, v) in enumerate(zip(ws, gs, tree.leaves(state["m"]),
                                         tree.leaves(state["v"]))):
        w32, g32 = w.float(), g.float()
        m.copy_(cfg.beta1 * m + (1 - cfg.beta1) * g32)
        v.copy_(cfg.beta2 * v + (1 - cfg.beta2) * torch.square(g32))
        u = (m * c1) / (torch.sqrt(v * c2) + cfg.eps)
        w_new = w32 - cfg.learning_rate * (u + cfg.weight_decay * w32)
        if plan is None:
            w.copy_(w_new)
        else:
            ws[i] = w_new
    if plan is not None:
        plan.gather_params_(params, ws)
    return params, state
