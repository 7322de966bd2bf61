"""Building the train step. Counterpart of ``repro.train.steps``
(``StepBundle``, ``build_train_step``) on one device.

Mixed precision (paper section 3.2.1): the parameters are initialized in
``arch.param_dtype`` (fp32); with ``run.master_weights`` the optimizer
keeps that fp32 copy and the model runs on a bf16 cast of it, updated by
the optimizer after each step. A step is grads -> global-norm clip ->
``opt.update``. JAX's jitted step returns a new state and donates the old
one; here the optimizer updates the parameters and its state in place under
``torch.no_grad()``, so every state tensor keeps its address from step to
step. That is what lets ``bundle.fn`` (a ``StepGraph``), the counterpart of
JAX's ``jax.jit(fn, donate_argnums=(0,))``, replay the whole step as one
CUDA graph on the card. ``bundle.eager`` is the same step uncaptured, each
batch copied into new device tensors. The three parts of a step are
``torch.profiler.record_function`` ranges (``train_step/grads``,
``/clip``, ``/update``; a replay's host work is ``/stage`` and
``/replay``), so a profile splits the host's time between them; with no
profiler running they cost about a microsecond each.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import graphs, resolve_device, tree
from ..configs.base import RunConfig, torch_dtype
from ..graphs import Captured
from ..models import model as model_lib
from ..optim import grad as grad_lib
from ..optim import make_optimizer


class StepGraph:
    """The train step ``step(state, inputs) -> metrics`` over static input
    buffers, called as ``(state, batch of numpy arrays) -> (state,
    metrics)``.

    Each call copies the batch into the static buffers (on the card from
    pinned memory, queued behind the card's work). On a CUDA device the
    first call runs the step eagerly on a side stream (the warm-up, a real
    step), the second captures it into a ``torch.cuda.CUDAGraph`` and
    replays it, and every later call is one replay: no Python-issued launch
    and no host read. On the CPU every call runs the step eagerly on the
    same buffers. The metrics land in one static buffer that the next step
    overwrites, so each call returns its own copy of them (one launch).

    A graph belongs to one state and one batch shape: a call with another
    state's tensors (their addresses) or another shape starts again from
    the warm-up. ``captures`` and ``replays`` count graphs captured and
    replayed, ``pool_bytes`` the device memory their captures reserved."""

    def __init__(self, step: Callable, device: torch.device):
        self.step, self.device = step, device
        self.inputs: Dict[str, torch.Tensor] = {}
        self.names: List[str] = []
        self.out: Optional[torch.Tensor] = None
        self.entry: Optional[Captured] = None
        self.captures = self.replays = self.pool_bytes = 0
        self._key = None
        self._pool = None
        self._stream = None

    def __call__(self, state: Dict, batch: Dict[str, np.ndarray]):
        host = {k: torch.as_tensor(v) for k, v in batch.items()}
        key = (tuple(t.data_ptr() for t in tree.leaves(state)),
               tuple((k, t.shape, t.dtype) for k, t in host.items()))
        fresh = key != self._key
        if fresh:
            self._key, self.entry, self.out = key, None, None
            self.inputs = {k: torch.empty(t.shape, dtype=t.dtype,
                                          device=self.device)
                           for k, t in host.items()}
        cuda = self.device.type == "cuda"
        with record_function("train_step/stage"):
            for k, t in host.items():
                self.inputs[k].copy_(t.pin_memory() if cuda else t,
                                     non_blocking=cuda)
        if not cuda:
            self._run(state)
        elif fresh:
            graphs.warm_up(lambda: self._run(state), self._side_stream())
        else:
            if self.entry is None:
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                self.entry, added = graphs.capture(
                    lambda: self._run(state), pool=self._pool,
                    stream=self._side_stream(), device=self.device)
                self.captures += 1
                self.pool_bytes += added
            with record_function("train_step/replay"):
                graphs.replay(self.entry)
            self.replays += 1
        return state, dict(zip(self.names, self.out.clone().unbind()))

    def _run(self, state: Dict) -> None:
        metrics = self.step(state, self.inputs)
        if self.out is None:
            self.names = list(metrics)
            self.out = torch.empty(len(self.names), dtype=torch.float32,
                                   device=self.device)
        torch.stack([metrics[k].float() for k in self.names], out=self.out)

    def _side_stream(self) -> "torch.cuda.Stream":
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream


@dataclasses.dataclass
class StepBundle:
    fn: StepGraph       # (state, batch) -> (state, metrics on the device)
    init: Callable      # (seed=0, params=None) -> state
    eager: Callable     # fn's step uncaptured, on new device tensors


def build_train_step(run: RunConfig, device="cuda") -> StepBundle:
    arch, shape = run.arch, run.shape
    if run.zero1:
        raise NotImplementedError("zero1=True: the ZeRO layout not ported "
                                  "(launch/train.py passes zero1=False)")
    device = resolve_device(device)
    opt = make_optimizer(run)

    def loss_fn(params, batch):
        return model_lib.loss(arch, params, batch)

    def step(state: Dict, batch: Dict[str, torch.Tensor]) -> Dict:
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
        return metrics

    def to_device(v: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(v)
        if device.type != "cuda":
            return t
        # from pinned memory the copy is queued behind the card's work
        # instead of waiting for it
        return t.pin_memory().to(device, non_blocking=True)

    def eager(state: Dict, batch: Dict[str, np.ndarray]):
        return state, step(state, {k: to_device(v) for k, v in batch.items()})

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

    return StepBundle(fn=StepGraph(step, device), init=init, eager=eager)
