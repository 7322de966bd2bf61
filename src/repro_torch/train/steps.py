"""Building the train step. Counterpart of ``repro.train.steps``
(``StepBundle``, ``build_train_step``) on one device.

Mixed precision (paper section 3.2.1): the parameters are initialized in
``arch.param_dtype`` (fp32); with ``run.master_weights`` the optimizer
keeps that fp32 copy and the model runs on a bf16 cast of it, updated by
the optimizer after each step. A step is grads -> global-norm clip ->
``opt.update``. JAX's jitted step returns a new state and donates the old
one; here the optimizer updates the parameters and its state in place under
``torch.no_grad()``, and ``fn`` returns the same state object. The three
parts of a step are ``torch.profiler.record_function`` ranges
(``train_step/grads``, ``/clip``, ``/update``), so a profile splits the
host's time between them; with no profiler running they cost about a
microsecond each.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch
from torch.profiler import record_function

from .. import resolve_device, tree
from ..configs.base import RunConfig, torch_dtype
from ..models import model as model_lib
from ..optim import grad as grad_lib
from ..optim import make_optimizer


@dataclasses.dataclass
class StepBundle:
    fn: Callable        # (state, batch) -> (state, metrics on the device)
    init: Callable      # (seed=0, params=None) -> state


def build_train_step(run: RunConfig, device="cuda") -> StepBundle:
    arch, shape = run.arch, run.shape
    if run.zero1:
        raise NotImplementedError("zero1=True: the ZeRO layout not ported "
                                  "(launch/train.py passes zero1=False)")
    device = resolve_device(device)
    opt = make_optimizer(run)

    def loss_fn(params, batch):
        return model_lib.loss(arch, params, batch)

    def to_device(v: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(v)
        if device.type != "cuda":
            return t
        # from pinned memory the copy is queued behind the card's work
        # instead of waiting for it
        return t.pin_memory().to(device, non_blocking=True)

    def step(state: Dict, batch: Dict[str, np.ndarray]):
        batch = {k: to_device(v) for k, v in batch.items()}
        params = state["params"]
        with record_function("train_step/grads"):
            grads, metrics = grad_lib.accumulate_microbatches(
                loss_fn, params, batch, shape.microbatches)
        if run.grad_clip > 0:
            with record_function("train_step/clip"):
                grads, gnorm = grad_lib.clip_by_global_norm(grads,
                                                            run.grad_clip)
            metrics = dict(metrics, grad_norm=gnorm)
        with record_function("train_step/update"):
            opt.update(grads, state["opt"], params)
        return state, metrics

    def init(seed: int = 0, params=None) -> Dict:
        """Seeded random parameters in ``arch.param_dtype``, or a copy of
        ``params`` (the port's layout, e.g. converted JAX weights)."""
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = model_lib.init_params(arch, gen, device,
                                           torch_dtype(arch.param_dtype))
        state = {"opt": opt.init(params)}
        dtype = torch_dtype(arch.dtype) if run.master_weights else None
        state["params"] = tree.map(
            lambda p: p.detach().to(device=device, dtype=dtype or p.dtype,
                                    copy=True).requires_grad_(True), params)
        return state

    return StepBundle(fn=step, init=init)
