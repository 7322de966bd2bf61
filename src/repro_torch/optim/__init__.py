"""Optimizer registry: ``make_optimizer(run)`` -> an ``Optimizer`` with
``init(params)`` and ``update(grads, state, params)``. Counterpart of
``repro.optim``; LAMB and AdamW with ``zero1`` take the ZeRO layout's
``plan`` (``zero.Plan``: the trainer's, or one device by default)."""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from ..configs.base import RunConfig
from . import adamw, grad, lamb, sgd, zero

_MODS = {"lamb": lamb, "adamw": adamw, "sgd": sgd}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    cfg: Any

    def init(self, params, plan=None):
        kw = {} if plan is None else {"plan": plan}
        return _MODS[self.name].init(self.cfg, params, **kw)

    def update(self, grads, state, params, plan=None) -> Tuple:
        kw = {} if plan is None else {"plan": plan}
        return _MODS[self.name].update(self.cfg, grads, state, params, **kw)


def make_optimizer(run: RunConfig) -> Optimizer:
    if run.optimizer == "lamb":
        cfg = lamb.LambConfig(learning_rate=run.learning_rate,
                              weight_decay=run.weight_decay, zero1=run.zero1,
                              use_fused_kernel=run.fused_optimizer_kernel,
                              master_weights=run.master_weights)
    elif run.optimizer == "adamw":
        cfg = adamw.AdamWConfig(learning_rate=run.learning_rate,
                                weight_decay=run.weight_decay,
                                zero1=run.zero1)
    elif run.optimizer == "sgd":
        cfg = sgd.SGDConfig(learning_rate=run.learning_rate,
                            weight_decay=run.weight_decay)
    else:
        raise ValueError(run.optimizer)
    return Optimizer(run.optimizer, cfg)


__all__ = ["Optimizer", "make_optimizer", "adamw", "grad", "lamb", "sgd",
           "zero"]
