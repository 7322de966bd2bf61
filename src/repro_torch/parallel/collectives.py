"""Collectives of the training path. Counterpart of
``repro.parallel.collectives`` (``quantize_int8``, ``dequantize_int8``,
``compressed_psum``, ``hierarchical_psum``), whose ``axis_name`` becomes a
process group: the group of a mesh axis (``mesh.get_group(axis)``).

Besides, every collective a training step runs goes through the wrappers
here (``all_reduce``, ``reduce_scatter``, ``all_gather``), which count
each call and the bytes a rank sends for it under the ring algorithm in
``COUNTS``: (n - 1) / n of the buffer for a reduce-scatter (of its input)
and an all-gather (of its output), twice that for an all-reduce, n the
group's size. The counts are taken in Python, so a CUDA graph that
captured a collective does not count its replays. ``global_sum`` is the
all-reduce inside a loss (the MoE auxiliary loss's router sums).

On a mesh with a model axis, GSPMD derives the collectives of JAX's step
from its specs; here they are written out as autograd functions, each
with the collective its gradient needs:

- ``copy_to`` (identity forward, all-reduce backward) and its conjugate
  ``reduce_from`` (all-reduce forward, identity backward): the entry and
  exit of Megatron's tensor-parallel region where the residual stream is
  whole on every model rank;
- ``gather_seq`` (all-gather of the sequence over the model axis forward,
  reduce-scatter backward) and its conjugate ``scatter_seq``: the same
  entry and exit under sequence parallelism, the residual stream a rank's
  1 / tp of the rows;
- ``gather_fsdp``: FSDP's weight gather, an all-gather over the data axis
  forward and a reduce-scatter of the gradient backward;
- ``Parallel.column`` / ``Parallel.row``: the entry and the exit fused
  with the product they meet, so that the partial sums the model axis
  adds are the ranks' fp32 products, rounded once after the sum (the
  mamba mixer's ``in_proj`` and ``out_proj``, whose 48-layer stack
  carries any extra rounding of a layer into every other).

A reduce of a 16-bit tensor runs in fp32 and is rounded once; the
gathered and scattered tensors come back contiguous (the kernels take
nothing else).
``Parallel`` is the mesh as the layers see it: its groups, this rank's
coordinates, whether the sequence is split, whether the experts are, and
which parameter tensors hold an FSDP slice (their split dim).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

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


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """Sum (or ``op``) ``t`` over ``group`` in place; returns it."""
    _count("all_reduce", t.numel() * t.element_size(), group)
    dist.all_reduce(t, op=op, group=group)
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


# ---------------------------------------- the model axis's autograd ops ----

def _wide(t: torch.Tensor) -> torch.Tensor:
    """t as a reduce takes it: fp32 for a 16-bit tensor, contiguous."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.float()
    return t.contiguous()


def _reduce(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over ``group`` (a new tensor, t's dtype)."""
    return all_reduce(_wide(t).clone(), group).to(t.dtype)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's x concatenated along ``dim`` in rank order."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    all_gather(out, xt, group)
    return out.movedim(0, dim).contiguous()


def _scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Rank r's r-th block along ``dim`` of the sum of x over ``group``."""
    n = dist.get_world_size(group)
    xt = _wide(x.movedim(dim, 0))
    if xt.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                      dtype=xt.dtype, device=x.device)
    reduce_scatter(out, xt.contiguous(), group)
    return out.to(x.dtype).movedim(0, dim).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


def wide_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w over x's last dim in fp32: a 16-bit x and w on the card meet
    in one tensor-core GEMM with an fp32 output (their products are exact
    in fp32, so only the order of the sum differs from one GEMM over the
    whole dim), elsewhere the fp32 product."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16) and \
            w.dtype == x.dtype:
        return torch.mm(x.reshape(-1, x.shape[-1]), w,
                        out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    return x.float() @ w.float()


def _weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient of w in x @ w: x^T g over every leading dim."""
    return x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])


class _ColumnProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, seq):
        ctx.group, ctx.seq = group, seq
        xs = _gather(x, 1, group) if seq else x
        ctx.save_for_backward(xs, w)
        return xs @ w

    @staticmethod
    def backward(ctx, g):
        xs, w = ctx.saved_tensors
        part = wide_product(g, w.t())
        gx = _scatter(part, 1, ctx.group) if ctx.seq \
            else _reduce(part, ctx.group)
        return gx.to(xs.dtype), _weight_grad(xs, g), None, None


class _WideProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, w):
        ctx.save_for_backward(y, w)
        return wide_product(y, w)

    @staticmethod
    def backward(ctx, g):
        y, w = ctx.saved_tensors
        g = g.to(y.dtype)
        return g @ w.t(), _weight_grad(y, g)


class _Exit(torch.autograd.Function):
    # saves nothing, so a block's recompute stops before it
    @staticmethod
    def forward(ctx, part, group, seq, dtype):
        ctx.group, ctx.seq = group, seq
        out = _scatter(part, 1, group) if seq else _reduce(part, group)
        return out.to(dtype)

    @staticmethod
    def backward(ctx, g):
        return (_gather(g, 1, ctx.group) if ctx.seq else g), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """x as it is; its gradient summed over ``group``."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group``; the gradient passed through."""
    return _ReduceFrom.apply(x, group)


def gather_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Every rank's rows of ``dim`` gathered; the gradient reduce-
    scattered back to each rank's rows."""
    return _Gather.apply(x, dim, group)


def scatter_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The sum over ``group`` of x, each rank keeping its rows of
    ``dim``; the gradient all-gathered."""
    return _Scatter.apply(x, dim, group)


def gather_fsdp(w: torch.Tensor, dim: int, group) -> torch.Tensor:
    """A weight's FSDP slices gathered along ``dim`` over the data
    ``group``; its gradient reduce-scattered, so each rank keeps the
    group's sum for its slice."""
    return _Gather.apply(w, dim, group)


@dataclasses.dataclass
class Parallel:
    """The training mesh as the layers see it. ``model`` and ``data`` are
    this rank's groups along the two axes (None where the axis has one
    rank), ``tp`` / ``dp`` their sizes and ``mrank`` this rank's
    coordinate on the model axis; ``pods`` is the pod axis's size (the
    batch rows split over pod x data); ``seq`` says the residual stream
    is split over the model axis by sequence (``rules["seq"]``),
    ``experts`` that a MoE layer's experts are (``rules["experts"]``);
    ``fsdp`` maps the id of every parameter tensor that holds an FSDP
    slice to its split dim (over the data axis, within a pod)."""
    model: Any = None
    tp: int = 1
    mrank: int = 0
    data: Any = None
    dp: int = 1
    pods: int = 1
    seq: bool = False
    experts: bool = False
    fsdp: Dict[int, int] = dataclasses.field(default_factory=dict)

    def full(self, w: torch.Tensor) -> torch.Tensor:
        """w whole along its FSDP dim (this rank's model block of it)."""
        dim = self.fsdp.get(id(w))
        return w if dim is None else gather_fsdp(w, dim, self.data)

    def gather_params(self, p: Any) -> Any:
        """A block's parameter dict with every FSDP slice gathered: one
        gather a weight a use, inside the block, so a recomputed block
        gathers again."""
        if isinstance(p, dict):
            return {k: self.gather_params(v) for k, v in p.items()}
        if isinstance(p, list):
            return [self.gather_params(v) for v in p]
        return self.full(p)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Into a tensor-parallel region: the whole sequence (gathered
        under sequence parallelism), the gradient summed over the model
        axis."""
        if self.model is None:
            return x
        return gather_seq(x, self.model) if self.seq \
            else copy_to(x, self.model)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """Out of a tensor-parallel region: the ranks' partial sums summed
        (each rank keeping its rows under sequence parallelism)."""
        if self.model is None:
            return y
        return scatter_seq(y, self.model) if self.seq \
            else reduce_from(y, self.model)

    def column(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``enter(x) @ w`` for the rank's columns ``w``, with the
        gradient of x summed over the model axis from the ranks' fp32
        partial products, so it is rounded to x's dtype once, as one
        device's product over every column is."""
        if self.model is None:
            return x @ w
        return _ColumnProduct.apply(x, w, self.model, self.seq)

    def row(self, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``exit(y @ w)`` for the rank's rows ``w``, the ranks' partial
        products summed in fp32 and rounded to y's dtype once, as one
        device's product over every row is (``exit`` of a 16-bit product
        rounds each rank's partial first)."""
        if self.model is None:
            return y @ w
        return _Exit.apply(_WideProduct.apply(y, w), self.model,
                           self.seq, y.dtype)

    def rows(self, s: int) -> Tuple[int, int]:
        """This rank's rows [s0, s1) of a sequence of ``s`` rows in the
        residual stream (all of them without sequence parallelism)."""
        if self.model is None or not self.seq:
            return 0, s
        if s % self.tp:
            raise ValueError(f"sequence {s} does not split over "
                             f"{self.tp} model ranks")
        per = s // self.tp
        return self.mrank * per, (self.mrank + 1) * per


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
