"""Building the train step. Counterpart of ``repro.train.steps``
(``StepBundle``, ``build_train_step``), on one device or, with ZeRO-1, on
the data axis of a mesh.

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

With ``run.zero1`` (JAX's default) LAMB and AdamW keep their state in the
ZeRO flat layout (``optim.zero.Plan``, made by ``init``), and the
gradients accumulate in it. Given a ``mesh`` whose ``data`` axis holds dp
ranks, each rank runs the step on the same global batch: micro-batch i is
JAX's (rows ``[i B / M, (i + 1) B / M)``), and the rank takes its 1 / dp
of its rows (``sharding.batch_pspecs``); the masked mean of the loss
divides by the whole micro-batch's mask count (one ``all_reduce`` of the
counts before the forwards). Then one ``reduce_scatter`` sums the flat
gradients and leaves each rank its columns, the clip and the optimizer run
on those shards (LAMB's norms summed across the ranks), and one
``all_gather`` of the updated parameters, in their dtype, makes every
rank's parameters whole again: ``zero_collectives`` states the count.
The metrics (``ce``, ``accuracy``, ``loss``) are the global batch's. On the
card over nccl the step is captured as ever; a gloo group's collectives run
on the host and cannot be captured, so there ``bundle.fn`` runs every step
eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from .. import graphs, resolve_device, tree
from ..configs.base import RunConfig, torch_dtype
from ..graphs import Captured
from ..launch import mesh as mesh_lib
from ..models import model as model_lib
from ..models.transformer import period_length
from ..optim import grad as grad_lib
from ..optim import make_optimizer, zero
from ..parallel import collectives, sharding


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
    replayed, ``pool_bytes`` the device memory their captures reserved.
    With ``capture=False`` (a step whose collectives run on the host)
    every call runs the step eagerly on the buffers, as on the CPU."""

    def __init__(self, step: Callable, device: torch.device,
                 capture: bool = True):
        self.step, self.device = step, device
        self.capture = capture
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
        if not (cuda and self.capture):
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
    plan: Optional[zero.Plan] = None    # the ZeRO layout, set by init


def zero_collectives(run: RunConfig, dp: int) -> Dict[str, int]:
    """The collectives one ZeRO step runs on each rank of a data group of
    dp ranks, by kind: ``all_reduce`` for the micro-batches' mask counts
    (1), the clip's norm (1 where ``grad_clip`` > 0), LAMB's gradient norm
    and its partial norms (2), the metrics (1), and one a MoE layer a
    micro-batch for the Switch loss's sums, twice under ``remat`` (the
    recompute runs it again); one ``reduce_scatter`` and one
    ``all_gather``. None at dp = 1."""
    if dp == 1:
        return {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0}
    arch = run.arch
    moe = sum(arch.is_moe_layer(i) for i in range(arch.num_layers))
    return {"all_reduce": 2 + (run.grad_clip > 0)
            + 2 * (run.optimizer == "lamb") + moe * run.shape.microbatches
            * (2 if arch.remat else 1),
            "reduce_scatter": 1, "all_gather": 1}


def _data_axis(run: RunConfig, mesh):
    """(dp, this rank's index on the data axis, the data group or None) of
    ``mesh``, refusing what is not ported: another axis of more than one
    rank, or dp > 1 without ZeRO."""
    sizes = mesh_lib.axis_sizes(mesh)
    wide = {a: n for a, n in sizes.items() if a != "data" and n > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: training over the model axis (tensor "
            "parallelism, FSDP, experts) or a pod axis is not ported; the "
            "data axis only")
    dp = sizes.get("data", 1)
    if dp > 1 and not (run.zero1 and run.optimizer in ("lamb", "adamw")):
        raise NotImplementedError(
            f"dp={dp} with zero1={run.zero1} and {run.optimizer}: data "
            "parallelism is ported for ZeRO-1 (zero1=True, lamb or adamw)")
    if dp == 1:
        return 1, 0, None
    return dp, mesh_lib.axis_coords(mesh)["data"], mesh.get_group("data")


def build_train_step(run: RunConfig, device="cuda",
                     mesh=None) -> StepBundle:
    """The train step of ``run`` on ``device``; with ``mesh`` (a
    ``launch.mesh.make_mesh`` mesh) this rank's step on its data axis."""
    arch, shape = run.arch, run.shape
    device = resolve_device(device)
    opt = make_optimizer(run)
    zero1 = run.zero1 and run.optimizer in ("lamb", "adamw")
    dp, rank, group = _data_axis(run, mesh)

    def loss_fn(params, batch):
        if group is None:
            return model_lib.loss(arch, params, batch)
        mb, denom = batch
        return model_lib.loss(arch, params, mb, group, denom)

    def local(micro: List[Dict[str, torch.Tensor]]):
        """This rank's rows of each micro-batch, each with the
        micro-batch's mask count over every rank (one all_reduce)."""
        specs = sharding.batch_pspecs(micro[0])
        mine = [{k: v[sharding.local_slice(specs[k], v.shape, {"data": dp},
                                           {"data": rank})]
                 for k, v in mb.items()} for mb in micro]
        counts = torch.stack([mb["loss_mask"].float().sum()
                              if "loss_mask" in mb else
                              torch.ones_like(mb["targets"],
                                              dtype=torch.float32).sum()
                              for mb in mine])
        denoms = torch.clamp_min(collectives.all_reduce(counts, group), 1.0)
        return list(zip(mine, denoms.unbind()))

    def global_metrics(metrics: Dict) -> Dict:
        """The ranks' shares of ce and accuracy summed (one all_reduce);
        the loss the batch's ce plus its aux."""
        part = collectives.all_reduce(torch.stack(
            [metrics["ce"], metrics["accuracy"]]).float(), group)
        return dict(metrics, loss=part[0] + metrics["aux"], ce=part[0],
                    accuracy=part[1])

    def step(state: Dict, batch: Dict[str, torch.Tensor]) -> Dict:
        params = state["params"]
        plan = bundle.plan
        if zero1 and plan is None:
            raise ValueError("a ZeRO step runs on the state its bundle's "
                             "init made")
        with record_function("train_step/grads"):
            grads, metrics = grad_lib.accumulate_microbatches(
                loss_fn, params, batch, shape.microbatches, plan=plan,
                local=None if group is None else local)
            if plan is not None:        # this rank's chunk, one tensor
                grads = [plan.reduce_scatter(grads)]
            if group is not None:
                metrics = global_metrics(metrics)
        if run.grad_clip > 0:
            with record_function("train_step/clip"):
                grads, gnorm = grad_lib.clip_by_global_norm(
                    grads, run.grad_clip, group)
            metrics = dict(metrics, grad_norm=gnorm)
        with record_function("train_step/update"):
            if plan is not None:
                grads = plan.views(grads[0])
            opt.update(grads, state["opt"], params, plan)
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
        ``params`` (the port's layout, e.g. converted JAX weights); with
        ZeRO the optimizer state is this rank's shards of the flat layout
        (every rank makes the same parameters from the same seed)."""
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = model_lib.init_params(arch, gen, device,
                                           torch_dtype(arch.param_dtype))
        if zero1:
            bundle.plan = zero.Plan(
                params, period=period_length(arch),
                layer_rows=run.optimizer == "lamb", dp=dp, rank=rank,
                group=group)
        state = {"opt": opt.init(params, bundle.plan)}
        dtype = torch_dtype(arch.dtype) if run.master_weights else None
        state["params"] = tree.map(
            lambda p: p.detach().to(device=device, dtype=dtype or p.dtype,
                                    copy=True).requires_grad_(True), params)
        return state

    # gloo's collectives run on the host: no CUDA graph can hold them
    host = group is not None and dist.get_backend(group) == "gloo"
    bundle = StepBundle(fn=StepGraph(step, device, capture=not host),
                        init=init, eager=eager)
    return bundle
