"""Gradient utilities: global-norm clipping and micro-batch accumulation
(paper section 4.2). Counterpart of ``repro.optim.grad``."""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from .. import tree

Batch = Dict[str, torch.Tensor]


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32, on the device."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in tree.leaves(grads)]
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled by min(1, max_norm / norm), each back in its dtype;
    the norm). No host read: the scale stays a device scalar."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return tree.map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def accumulate_microbatches(loss_fn: Callable, params, batch: Batch,
                            num_micro: int) -> Tuple[object, Dict]:
    """Gradients of ``loss_fn(params, batch) -> (loss, metrics)`` with
    respect to every leaf of ``params``. With ``num_micro > 1`` the batch
    dim is split (the leading one; axis 1 of ``mrope_positions`` [3, B,
    S], so its three streams stay together), one micro-batch's forward and
    backward run at a time (a Python loop in place of JAX's ``lax.scan``),
    the gradients are averaged in fp32 and the metrics averaged."""
    leaves = tree.leaves(params)

    def grads_of(mb):
        loss, metrics = loss_fn(params, mb)
        return torch.autograd.grad(loss, leaves), metrics

    if num_micro == 1:
        grads, metrics = grads_of(batch)
        return tree.unflatten(params, list(grads)), metrics
    def batch_dim(k):
        return 1 if k == "mrope_positions" else 0

    b = next(v.shape[batch_dim(k)] for k, v in batch.items())
    if b % num_micro:
        raise ValueError(f"batch {b} is not divisible into {num_micro} "
                         "micro-batches")
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    seen = []
    for i in range(num_micro):
        mb = {k: v.chunk(num_micro, dim=batch_dim(k))[i]
              for k, v in batch.items()}
        grads, metrics = grads_of(mb)
        for a, g in zip(acc, grads):
            a.add_(g.float() / num_micro)
        seen.append(metrics)
    metrics = {k: torch.stack([m[k] for m in seen]).mean() for k in seen[0]}
    return tree.unflatten(params, acc), metrics
