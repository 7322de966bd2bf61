"""GPipe pipeline parallelism over a process group. Counterpart of
``repro.parallel.pipeline`` (``pipeline_apply``, ``bubble_fraction``):
each rank of ``group`` is a stage holding a contiguous group of layers;
the batch is split into micro-batches that stream through the stages
with the GPipe schedule, whose bubble is (S - 1) / (M + S - 1). JAX's
``ppermute`` ring becomes a ``batch_isend_irecv`` to the next rank and
from the previous one each tick, and its final ``psum`` (only the last
stage holds the output) a broadcast from the last stage.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                   *, num_stages: int, num_micro: int,
                   group) -> torch.Tensor:
    """This rank's stage of a GPipe pipeline: ``stage_fn(stage_params, x)
    -> x`` (the same shape) is its layer group, ``x`` the whole batch on
    every rank. At tick t (of S + M - 1) stage s applies its layers to
    micro-batch t - s (stage 0 takes it from ``x``, the others from the
    stage before) and hands the result on. Returns the whole processed
    batch on every rank."""
    b = x.shape[0]
    if b % num_micro:
        raise ValueError(f"batch {b} does not split into {num_micro} "
                         "micro-batches")
    if dist.get_world_size(group) != num_stages:
        raise ValueError(f"{num_stages} stages over a group of "
                         f"{dist.get_world_size(group)} ranks")
    micro = x.reshape(num_micro, b // num_micro, *x.shape[1:])
    stage = dist.get_rank(group)
    peer = lambda s: dist.get_global_rank(group, s % num_stages)  # noqa
    buf = torch.zeros_like(micro[0])
    out = torch.zeros_like(micro)
    for t in range(num_stages + num_micro - 1):
        i = t - stage
        y = buf
        if 0 <= i < num_micro:
            y = stage_fn(stage_params, micro[i] if stage == 0 else buf)
            if stage == num_stages - 1:
                out[i] = y
        if num_stages == 1:
            buf = y
            continue
        nxt = torch.empty_like(buf)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y.contiguous(), peer(stage + 1),
                           group),
                dist.P2POp(dist.irecv, nxt, peer(stage - 1), group)]):
            req.wait()
        buf = nxt
    dist.broadcast(out, peer(num_stages - 1), group=group)
    return out.reshape(b, *x.shape[1:])


def bubble_fraction(num_stages: int, num_micro: int) -> float:
    return (num_stages - 1) / (num_micro + num_stages - 1)
