"""Collectives of the training path. Counterpart of
``repro.parallel.collectives`` (``quantize_int8``, ``dequantize_int8``,
``compressed_psum``, ``hierarchical_psum``), whose ``axis_name`` becomes a
process group: the group of a mesh axis (``mesh.get_group(axis)``).

Besides, the three collectives the data-parallel step runs
(``all_reduce``, ``reduce_scatter``, ``all_gather``) go through the
wrappers here, which count each call and the bytes a rank sends for it
under the ring algorithm in ``COUNTS``: (n - 1) / n of the buffer for a
reduce-scatter (of its input) and an all-gather (of its output), twice
that for an all-reduce, n the group's size. The counts are taken in
Python, so a CUDA graph that captured a collective does not count its
replays. ``global_sum`` is the all-reduce inside a loss (the MoE
auxiliary loss's router sums).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

COUNTS: Dict[str, int] = {"all_reduce": 0, "reduce_scatter": 0,
                          "all_gather": 0, "all_reduce_bytes": 0,
                          "reduce_scatter_bytes": 0, "all_gather_bytes": 0}


def _count(kind: str, nbytes: int, group) -> None:
    n = dist.get_world_size(group)
    COUNTS[kind] += 1
    COUNTS[f"{kind}_bytes"] += (2 if kind == "all_reduce" else 1) \
        * (n - 1) * nbytes // n


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns it."""
    _count("all_reduce", t.numel() * t.element_size(), group)
    dist.all_reduce(t, group=group)
    return t


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``out`` = rank r's r-th slice of the sum of ``inp`` over ``group``."""
    _count("reduce_scatter", inp.numel() * inp.element_size(), group)
    dist.reduce_scatter_tensor(out, inp, group=group)


def all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``out`` = every rank's ``inp``, in rank order."""
    _count("all_gather", out.numel() * out.element_size(), group)
    dist.all_gather_into_tensor(out, inp, group=group)


class _GlobalSum(torch.autograd.Function):
    """The sum of x over a group; the gradient passes through to the
    rank's own x, as a rank's loss is its share of a loss whose gradients
    the step sums over the group."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group``, differentiable (see ``_GlobalSum``)."""
    return _GlobalSum.apply(x, group)


# ------------------------------------------------- JAX's collectives.py ----

def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization -> (q, scale): q = x / scale
    rounded half to even (``jnp.round``), clipped to +-127; scale =
    max(|x|, 1e-12) / 127."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(x: torch.Tensor, group,
                    error: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce with fp32 error feedback -> (the mean over
    ``group`` of each rank's dequantized x + error, the new residual
    x + error - dequantized, to carry to the next call)."""
    x32 = x.to(torch.float32)
    if error is not None:
        x32 = x32 + error
    q, scale = quantize_int8(x32)
    new_error = x32 - dequantize_int8(q, scale)
    total = all_reduce(q.to(torch.int32).to(torch.float32) * scale, group)
    return total / dist.get_world_size(group), new_error


def hierarchical_psum(x: torch.Tensor, inner, outer) -> torch.Tensor:
    """A pod-hierarchical all-reduce over ``inner`` x ``outer``: a
    reduce-scatter of dim 0 inside ``inner``, an all-reduce of the shard
    across ``outer``, an all-gather inside ``inner``, so each rank moves
    only its shard across the outer links."""
    n = dist.get_world_size(inner)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over "
                         f"{n} ranks")
    x = x.contiguous()
    shard = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                        dtype=x.dtype, device=x.device)
    reduce_scatter(shard, x, inner)
    all_reduce(shard, outer)
    out = torch.empty_like(x)
    all_gather(out, shard, inner)
    return out
