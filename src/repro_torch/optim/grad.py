"""Gradient utilities: global-norm clipping and micro-batch accumulation
(paper section 4.2). Counterpart of ``repro.optim.grad``; with a ZeRO
``plan`` the gradients accumulate in its flat fp32 layout (JAX's
``transform`` of ``train/steps.py``), and with a group the norm of a
rank's shards is summed across the group: on a mesh with a model axis
the whole mesh, each leaf's squares weighed by ``weights`` so that a leaf
every model rank holds whole counts once (``zero.Plan.count``)."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import tree
from ..parallel import collectives

Batch = Dict[str, torch.Tensor]


def global_norm(grads, group=None,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32, on the device;
    with ``group`` (each rank holding its shards of the gradients) the sum
    of squares is summed over the group (one scalar ``all_reduce``), each
    leaf's squares times its entry of ``weights`` (fp32, on the device)
    where given."""
    norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                         for g in tree.leaves(grads)])
    if group is None:
        return torch.linalg.vector_norm(norms)
    sq = torch.square(norms)
    if weights is not None:
        sq = sq * weights
    sq = torch.sum(sq).reshape(1)
    return torch.sqrt(collectives.all_reduce(sq, group)[0])


def clip_by_global_norm(grads, max_norm: float, group=None,
                        weights: Optional[torch.Tensor] = None):
    """-> (grads scaled by min(1, max_norm / norm), each back in its dtype;
    the norm). No host read: the scale stays a device scalar."""
    norm = global_norm(grads, group, weights)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return tree.map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _batch_dim(key: str) -> int:
    return 1 if key == "mrope_positions" else 0


def split_microbatches(batch: Batch, num_micro: int) -> List[Batch]:
    """The batch dim split into ``num_micro`` equal micro-batches, in
    order (the leading dim; axis 1 of ``mrope_positions`` [3, B, S], so
    its three streams stay together), as JAX's ``split``."""
    if num_micro == 1:
        return [batch]
    b = next(v.shape[_batch_dim(k)] for k, v in batch.items())
    if b % num_micro:
        raise ValueError(f"batch {b} is not divisible into {num_micro} "
                         "micro-batches")
    return [{k: v.chunk(num_micro, dim=_batch_dim(k))[i]
             for k, v in batch.items()} for i in range(num_micro)]


def accumulate_microbatches(loss_fn: Callable, params, batch: Batch,
                            num_micro: int, plan=None,
                            local: Optional[Callable] = None,
                            reduce: Optional[Callable] = None
                            ) -> Tuple[object, Dict]:
    """Gradients of ``loss_fn(params, batch) -> (loss, metrics)`` with
    respect to every leaf of ``params``. With ``num_micro > 1`` the batch
    is split (``split_microbatches``), one micro-batch's forward and
    backward run at a time (a Python loop in place of JAX's ``lax.scan``),
    the gradients are averaged in fp32 and the metrics averaged.
    ``local`` maps the list of micro-batches to this rank's (a
    data-parallel step's rows of each). With a ZeRO ``plan`` the
    gradients accumulate into ``plan.accumulator``'s flat fp32 buffer,
    returned as it is (each rank's own sum, not yet reduced). ``reduce``
    maps each micro-batch's gradients (a list in ``tree.leaves`` order)
    before they are added (the model axis's sum of partial gradients)."""
    leaves = tree.leaves(params)

    def grads_of(mb):
        loss, metrics = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, leaves)
        return (grads if reduce is None else reduce(list(grads))), metrics

    micro = split_microbatches(batch, num_micro)
    if local is not None:
        micro = local(micro)
    seen = []
    if plan is not None:
        acc = plan.accumulator(leaves[0].device)
        for mb in micro:
            grads, metrics = grads_of(mb)
            plan.accumulate_(acc, grads, num_micro)
            seen.append(metrics)
        out = acc
    elif num_micro == 1:
        grads, metrics = grads_of(micro[0])
        return tree.unflatten(params, list(grads)), metrics
    else:
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        for mb in micro:
            grads, metrics = grads_of(mb)
            for a, g in zip(acc, grads):
                a.add_(g.float() / num_micro)
            seen.append(metrics)
        out = tree.unflatten(params, acc)
    if num_micro == 1:
        return out, seen[0]
    return out, {k: torch.stack([m[k] for m in seen]).mean()
                 for k in seen[0]}
