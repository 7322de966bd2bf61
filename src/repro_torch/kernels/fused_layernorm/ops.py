"""Wrappers of the fused norm kernels: the decode residual stream's add +
norm (``csrc/residual_norm.cu``), the training block's post-norm site
(``csrc/residual_layernorm.cu``) and the mamba mixer's SiLU-gated RMSNorm
(``csrc/gated_rmsnorm.cu``).

CPU tensors take the plain versions in ``ref.py``; CUDA tensors launch the
hand-written sm_90a kernels or raise. ``LAUNCHES`` counts kernel launches.
``norm_plan`` splits a row of the two decode-shaped kernels
(``decode_residual_norm``, ``gated_rmsnorm``) over threads, registers and
CTAs, from the shape alone.
Every wrapper has a gradient on the card: ``fused_residual_layernorm``
always, ``decode_residual_norm`` and ``gated_rmsnorm`` whenever an input
requires one (the fused pre-norm training block, the mamba mixer in
training); the backward is the plain version's (``_grad.PlainBackward``),
as JAX differentiates its reference.

On a training mesh's model axis a rank holds ``inner / tp`` columns of
each row of the gated norm, whose statistic is the whole row's:
``gated_rmsnorm(..., group=)`` runs it in two launches of two more entries
of ``gated_rmsnorm.cu`` (``gated_rmsnorm_partial``: each row's fp32 sum of
squares over the rank's columns; ``gated_rmsnorm_apply``: the rank's
columns scaled by the sum over the group), with one all-reduce of the
[rows] partials between them. Its backward (``_SplitNorm``) is the plain
version's autograd written out over the rank's columns
(``ref.gated_rmsnorm_split_grads``), with one all-reduce of each row's sum
of g * scale * gate: it rounds as the whole row's backward rounds.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ...core import optrace
from .. import _build
from .._grad import PlainBackward, refuse_grad, wants_grad
from . import ref

LAUNCHES = {"decode_residual_norm": 0, "fused_residual_layernorm": 0,
            "gated_rmsnorm": 0, "gated_rmsnorm_partial": 0,
            "gated_rmsnorm_apply": 0}

_LIB = "residual_norm"
_TRAIN_LIB = "residual_layernorm"
_GATED_LIB = "gated_rmsnorm"
_SMEM = 227 * 1024               # Hopper's shared memory a block can use
# the wide variants keep the row in shared memory: decode_residual_norm's
# in fp32 beside 64 bytes of static shared memory (its two sums' warp
# partials); gated_rmsnorm's in bf16 beside 32, whose limit stays at the
# v1 kernel's (36 bytes of scratch then)
_RESNORM_MAX_D = (_SMEM - 64) // 4
_GATED_MAX_C = (_SMEM - 36) // 2 // 8 * 8
# the register path (norm_plan): vectors of 8 bf16 values a thread (the
# kernels' template instantiations), CTAs of 32-512 threads, 1-8 CTAs a row
# (a thread block cluster); NORM_WIDE, 0 vectors: the wide variant
NORM_VECTORS = (1, 2, 3, 4)
NORM_MAX_THREADS = 512
NORM_THREADS = 256
NORM_CTAS = (1, 2, 4, 8)
NORM_GATED_CTAS = (8, 4, 1, 2)  # the gated norm's order of preference
NORM_SMS = 132                  # an H100's SMs: one wave of CTAs
NORM_WIDE = (256, 0, 1)
_TRAIN_DIMS = (256, 512, 768, 1024, 1536, 2048, 3072, 4096)
_KINDS = {"rmsnorm": 0, "layernorm": 1}


def _fits(vecs: int, ctas: int, v: int) -> int:
    """Threads a CTA when ``ctas`` CTAs of ``v`` vectors a thread cover
    ``vecs`` vectors exactly in whole warps, else 0."""
    t, rem = divmod(vecs, ctas * v)
    return t if not rem and t % 32 == 0 and 32 <= t <= NORM_MAX_THREADS \
        else 0


@functools.lru_cache(maxsize=None)
def norm_plan(rows: int, d: int, gated: bool = False) -> Tuple[int, int, int]:
    """``(threads, vectors_a_thread, ctas_a_row)`` for ``rows`` rows of
    ``d`` bf16 values: ``ctas_a_row`` CTAs of ``threads`` threads, each
    thread holding ``vectors_a_thread`` 16-byte vectors, cover the row
    exactly (``threads * vectors * ctas * 8 == d``). A pure function of its
    arguments: it reads no tensor and nothing back from the card. The rules
    follow ``norm_ablations.py``'s device times (``PERF.md`` §6):

    - the add + norm (``gated=False``) costs a launch and a trip to memory:
      one CTA a row with at most ``NORM_THREADS`` threads of at most 2
      vectors; a wider row spreads over the fewest CTAs (a cluster) that
      allow it while the rows' clusters fill at most ``NORM_SMS`` SMs;
      else one CTA of the fewest threads;
    - the gated norm (``gated=True``) adds a chain of IEEE expf and
      division a thread: the fewest vectors a thread, then a row over 8
      CTAs where 8 a row fill at most ``NORM_SMS`` SMs, else 4, else 1
      (``NORM_GATED_CTAS``; 2 was slower than 1 at [64, 4096]).

    ``NORM_WIDE`` where no plan covers the row (``d`` not a multiple of 8,
    or too wide): one CTA of 256 threads, the row in shared memory."""
    if d % 8:
        return NORM_WIDE
    vecs = d // 8
    fits = [(t, v, c) for c in NORM_CTAS for v in NORM_VECTORS
            if (t := _fits(vecs, c, v))
            and (c == 1 or rows * c <= NORM_SMS)]
    if gated:
        return min(fits, key=lambda f: (f[1], NORM_GATED_CTAS.index(f[2])),
                   default=NORM_WIDE)
    small = [f for f in fits if f[0] <= NORM_THREADS and f[1] <= 2]
    if small:
        return min(small, key=lambda f: (f[2], f[1]))
    ones = [f for f in fits if f[2] == 1]
    return min(ones) if ones else NORM_WIDE


def _norm_flops(x: torch.Tensor, rms: bool, bias) -> float:
    """FLOPs of the add + norm's plain version over ``x``'s rows, as
    ``core/characterize.py`` counts them: the add, then for an RMSNorm
    square, mean, normalize and scale (4 an element), for a LayerNorm mean,
    centre, square, mean, centre, normalize and scale (7), one more an
    element with a bias, and eps and rsqrt once a row."""
    n = x.numel()
    rows = n // max(x.shape[-1], 1)
    return (5.0 if rms else 8.0) * n + 2.0 * rows \
        + (n if bias is not None else 0)


def decode_residual_norm_flops(y, x, scale, bias=None, *,
                               kind: str = "rmsnorm", eps: float = 1e-5
                               ) -> float:
    return _norm_flops(x, kind == "rmsnorm", bias)


def fused_residual_layernorm_flops(x, residual, scale, bias=None, *,
                                   eps: float = 1e-5,
                                   rms: bool = False) -> float:
    return _norm_flops(x, rms, bias)


def gated_rmsnorm_flops(y, z, scale, *, eps: float = 1e-5) -> float:
    """The gate (sigmoid and two products) and the RMSNorm (square, mean,
    normalize, scale): 7 an element, eps and rsqrt once a row."""
    n = y.numel()
    return 7.0 * n + 2.0 * (n // max(y.shape[-1], 1))


@optrace.kernel_op("decode_residual_norm", decode_residual_norm_flops)
def decode_residual_norm(y: torch.Tensor, x: torch.Tensor,
                         scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, *,
                         kind: str = "rmsnorm", eps: float = 1e-5
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``x += y; h = norm(x)`` -> ``(h, x + y)``, any leading shape
    with D last (reshaped to ``[R, D]`` for the kernel); ``scale`` and
    ``bias`` are ``[D]`` in the activations' dtype (bfloat16 on the card).
    On the card any D up to ``_RESNORM_MAX_D``: the register path where
    ``norm_plan`` finds one and every base is 16-byte aligned, else the
    wide variant. Differentiable where an input requires a gradient (the
    fused pre-norm training block): backward is the plain version's."""
    if x.device.type == "cpu":
        return ref.decode_residual_norm(y, x, scale, bias, kind=kind, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if kind not in _KINDS:
        raise ValueError(kind)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16, got {x.dtype}")
    shape, d = x.shape, x.shape[-1]
    vecs = [scale] + ([] if bias is None else [bias])
    if y.shape != shape or y.dtype != x.dtype or y.device != x.device:
        raise ValueError(f"y {y.dtype} {tuple(y.shape)} must match x "
                         f"{x.dtype} {tuple(shape)}")
    for v in vecs:
        if v.dtype != x.dtype or tuple(v.shape) != (d,) \
                or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"scale/bias must be contiguous {x.dtype} [{d}] "
                             f"on {x.device}")
    if d > _RESNORM_MAX_D:
        raise ValueError(f"D = {d} does not fit the kernel's shared row")
    kernel = functools.partial(_resnorm_kernel, kind=kind, eps=eps)
    if wants_grad(y, x, scale, bias):
        plain = functools.partial(ref.decode_residual_norm, kind=kind,
                                  eps=eps)
        return PlainBackward.apply(kernel, plain, y, x, scale, bias)
    return kernel(y, x, scale, bias)


def _resnorm_kernel(y: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                    bias: Optional[torch.Tensor], *, kind: str,
                    eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    shape, d = x.shape, x.shape[-1]
    x2d = x.reshape(-1, d).contiguous()
    y2d = y.reshape(-1, d).contiguous()
    h = torch.empty_like(x2d)
    xo = torch.empty_like(x2d)
    rows = x2d.shape[0]
    if rows:
        _launch_resnorm(y2d, x2d, scale, bias, h, xo, kind, eps,
                        norm_plan(rows, d))
        LAUNCHES["decode_residual_norm"] += 1
    return h.reshape(shape), xo.reshape(shape)


def _launch_resnorm(y2d, x2d, scale, bias, h, xo, kind: str, eps: float,
                    plan: Tuple[int, int, int], lib: str = _LIB) -> None:
    """One launch of library ``lib``'s add + norm on checked [R, D]
    tensors with ``plan`` (``norm_ablations.py`` passes other plans and
    libraries). A base that is not 16-byte aligned takes the wide
    variant, whose loads are scalar."""
    ptrs = (y2d.data_ptr(), x2d.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), h.data_ptr(),
            xo.data_ptr())
    if any(p % 16 for p in ptrs if p):
        plan = NORM_WIDE
    fn = _build.bind(lib, "decode_residual_norm", 6, 6, 1)
    _build.check(fn(*ptrs, x2d.shape[0], x2d.shape[1], _KINDS[kind], *plan,
                    float(eps), torch.cuda.current_stream(
                        x2d.device).cuda_stream), "decode_residual_norm")


def _residual_layernorm_kernel(x: torch.Tensor, residual: torch.Tensor,
                               scale: torch.Tensor,
                               bias: Optional[torch.Tensor], *, eps: float,
                               rms: bool) -> torch.Tensor:
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    y = torch.empty_like(x2d)
    rows = x2d.shape[0]
    if rows:
        fn = _build.bind(_TRAIN_LIB, "fused_residual_layernorm", 5, 4, 1)
        err = fn(x2d.data_ptr(), residual.data_ptr(), scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), y.data_ptr(),
                 rows, d, int(scale.dtype == torch.float32), int(rms),
                 float(eps), torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "fused_residual_layernorm")
        LAUNCHES["fused_residual_layernorm"] += 1
    return y.reshape(x.shape)


@optrace.kernel_op("fused_residual_layernorm",
                   fused_residual_layernorm_flops)
def fused_residual_layernorm(x: torch.Tensor, residual: torch.Tensor,
                             scale: torch.Tensor,
                             bias: Optional[torch.Tensor] = None, *,
                             eps: float = 1e-5,
                             rms: bool = False) -> torch.Tensor:
    """``y = norm(x + residual) * scale (+ bias)`` with an fp32 add and
    statistics, in ``x``'s dtype; any leading shape with D last. On the
    card x and residual are contiguous bfloat16, scale and bias ``[D]`` in
    bfloat16 or float32, and D one of 256, 512, ..., 4096 (``_TRAIN_DIMS``).
    Differentiable: backward is the plain version's gradient."""
    plain = functools.partial(ref.fused_residual_layernorm, eps=eps, rms=rms)
    if x.device.type == "cpu":
        return plain(x, residual, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    d = x.shape[-1]
    if x.dtype != torch.bfloat16 or residual.dtype != x.dtype:
        raise TypeError(f"the kernel takes bfloat16 x and residual, got "
                        f"{x.dtype} and {residual.dtype}")
    if residual.shape != x.shape or residual.device != x.device:
        raise ValueError(f"residual {tuple(residual.shape)} must match x "
                         f"{tuple(x.shape)} on {x.device}")
    if d not in _TRAIN_DIMS:
        raise ValueError(f"D = {d}: the kernel is built for D in "
                         f"{_TRAIN_DIMS}")
    vecs = [scale] + ([] if bias is None else [bias])
    for v in vecs:
        if v.dtype not in (torch.bfloat16, torch.float32) \
                or v.dtype != scale.dtype or tuple(v.shape) != (d,) \
                or v.device != x.device:
            raise ValueError(f"scale/bias must be [{d}] tensors of one dtype"
                             f" (bfloat16 or float32) on {x.device}")
    for name, t in (("x", x), ("residual", residual), ("scale", scale),
                    ("bias", bias)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned"
                             " (the kernel moves 16 bytes a lane)")
    kernel = functools.partial(_residual_layernorm_kernel, eps=eps, rms=rms)
    return PlainBackward.apply(kernel, plain, x, residual, scale, bias)


def _rows(t: torch.Tensor, name: str, c: int) -> torch.Tensor:
    """``t`` as a ``[R, C]`` view with unit column stride, a row stride
    that is a multiple of 8 and a 16-byte aligned base; raises otherwise
    (the kernel moves 8 bf16 values a lane). Leading dims are merged
    without a copy where the strides allow it, so a column slice of a
    wider row (z inside the in_proj output) keeps its row stride."""
    t2 = t.reshape(-1, c)
    if t2.stride(1) != 1 or (t2.shape[0] > 1 and t2.stride(0) % 8) \
            or t2.data_ptr() % 16:
        raise ValueError(f"{name} must have unit column stride, a row stride "
                         f"that is a multiple of 8 and a 16-byte aligned "
                         f"base, got strides {t2.stride()}")
    return t2


def _check_gated(y: torch.Tensor, z: torch.Tensor,
                 scale: Optional[torch.Tensor]) -> None:
    """The gated kernels' checks on card tensors (``scale`` None: the
    partial sums, which read no scale)."""
    c = y.shape[-1]
    for name, t in (("y", y), ("z", z), ("scale", scale)):
        if t is not None and (t.dtype != torch.bfloat16
                              or t.device != y.device):
            raise TypeError(f"the kernel takes bfloat16 tensors on "
                            f"{y.device}; {name} is {t.dtype} on {t.device}")
    if z.shape != y.shape or (scale is not None
                              and tuple(scale.shape) != (c,)):
        raise ValueError(f"y {tuple(y.shape)}, z {tuple(z.shape)} and scale "
                         f"{None if scale is None else tuple(scale.shape)} "
                         "must be [..., C], [..., C] and [C]")
    if c % 8 or c > _GATED_MAX_C:
        raise ValueError(f"C = {c}: the kernel takes a multiple of 8 up to "
                         f"{_GATED_MAX_C} (its shared row)")
    _rows(y, "y", c)             # the kernel's stride checks, raised here
    _rows(z, "z", c)
    if scale is not None and (not scale.is_contiguous()
                              or scale.data_ptr() % 16):
        raise ValueError("scale must be contiguous and 16-byte aligned")


@optrace.kernel_op("gated_rmsnorm", gated_rmsnorm_flops)
def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-5, group=None) -> torch.Tensor:
    """SiLU-gated RMSNorm (the mamba mixer epilogue): ``rmsnorm(y *
    silu(z)) * scale``, any leading shape with the channel dim C last. On
    the card y, z and scale are bfloat16, C a multiple of 8, and y and z
    may be row-strided views (z is a column slice of the in_proj
    output); the result is a new contiguous tensor of y's shape.
    Differentiable where an input requires a gradient (the mamba mixer in
    training): backward is the plain version's.

    With ``group`` (a model axis's group of tp > 1 ranks) y, z and scale
    are this rank's C columns of rows of ``tp C``: the row statistic is
    summed over the group between ``gated_rmsnorm_partial`` and
    ``gated_rmsnorm_apply``, and the backward sums each row's sum of g *
    scale * gate over it too (``_SplitNorm``). Without it, the one-launch
    kernel."""
    if group is not None and dist.get_world_size(group) > 1:
        return _SplitNorm.apply(y, z, scale, group, eps)
    if y.device.type == "cpu":
        return ref.gated_rmsnorm(y, z, scale, eps=eps)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    _check_gated(y, z, scale)
    kernel = functools.partial(_gated_kernel, eps=eps)
    if wants_grad(y, z, scale):
        plain = functools.partial(ref.gated_rmsnorm, eps=eps)
        return PlainBackward.apply(kernel, plain, y, z, scale)
    return kernel(y, z, scale)


def _gated_kernel(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, *,
                  eps: float) -> torch.Tensor:
    c = y.shape[-1]
    y2d, z2d = _rows(y, "y", c), _rows(z, "z", c)
    out = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    rows = y2d.shape[0]
    if rows:
        _launch_gated(y2d, z2d, scale, out, eps, norm_plan(rows, c, True))
        LAUNCHES["gated_rmsnorm"] += 1
    return out


def _launch_gated(y2d, z2d, scale, out, eps: float,
                  plan: Tuple[int, int, int], lib: str = _GATED_LIB) -> None:
    """One launch of library ``lib``'s gated RMSNorm on checked [R, C]
    views with ``plan`` (``norm_ablations.py`` passes other plans and
    libraries)."""
    fn = _build.bind(lib, "gated_rmsnorm", 4, 7, 1)
    _build.check(fn(y2d.data_ptr(), z2d.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), y2d.shape[0], y2d.shape[1],
                    y2d.stride(0), z2d.stride(0), *plan, float(eps),
                    torch.cuda.current_stream(y2d.device).cuda_stream),
                 "gated_rmsnorm")


class _SplitNorm(torch.autograd.Function):
    """``gated_rmsnorm`` over a rank's columns (its ``group`` path):
    forward the two split entries with one all-reduce of the row sums
    between them; backward ``ref.gated_rmsnorm_split_grads`` with one
    all-reduce of each row's sum of g * scale * gate."""

    @staticmethod
    def forward(ctx, y, z, scale, group, eps):
        from ...parallel import collectives
        c = y.shape[-1] * dist.get_world_size(group)
        sq = collectives.all_reduce(gated_rmsnorm_partial(y, z), group)
        ctx.save_for_backward(y, z, scale, sq)
        ctx.group, ctx.c, ctx.eps = group, c, eps
        return gated_rmsnorm_apply(y, z, sq, scale, c=c, eps=eps)

    @staticmethod
    def backward(ctx, g):
        from ...parallel import collectives
        y, z, scale, sq = ctx.saved_tensors
        dy, dz, dscale = ref.gated_rmsnorm_split_grads(
            y, z, scale, sq, g, ctx.c, ctx.eps,
            psum=lambda t: collectives.all_reduce(t, ctx.group))
        return dy, dz, dscale, None, None


def gated_rmsnorm_partial(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Each row's fp32 sum of squares of ``y * silu(z)`` (the gate rounded
    as ``gated_rmsnorm`` rounds it) over the columns given: [..., C] ->
    [...] float32. On the card the kernel entry of the same name, with
    ``gated_rmsnorm``'s checks and plan. Not differentiable by itself:
    ``gated_rmsnorm(..., group=)`` differentiates the pair."""
    if y.device.type == "cpu":
        return ref.gated_rmsnorm_partial(y, z)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    refuse_grad("gated_rmsnorm_partial", y, z)
    _check_gated(y, z, None)
    return _partial_kernel(y, z)


def gated_rmsnorm_apply(y: torch.Tensor, z: torch.Tensor, sq: torch.Tensor,
                        scale: torch.Tensor, *, c: int,
                        eps: float = 1e-5) -> torch.Tensor:
    """The columns given of rows of ``c`` columns in all, normed by each
    row's sum of squares over all of them, ``sq`` [...] float32:
    ``y * silu(z) * rsqrt(sq / c + eps) * scale`` in y's dtype. On the
    card the kernel entry of the same name; not differentiable by itself,
    as ``gated_rmsnorm_partial``."""
    if y.device.type == "cpu":
        return ref.gated_rmsnorm_apply(y, z, sq, scale, c, eps)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    refuse_grad("gated_rmsnorm_apply", y, z, sq, scale)
    _check_gated(y, z, scale)
    if sq.dtype != torch.float32 or sq.shape != y.shape[:-1] \
            or sq.device != y.device:
        raise ValueError(f"sq must be float32 {tuple(y.shape[:-1])} on "
                         f"{y.device}, got {sq.dtype} {tuple(sq.shape)}")
    return _apply_kernel(y, z, sq, scale, c_total=c, eps=eps)


def _split_plan(rows: int, c: int, name: str) -> Tuple[int, int, int]:
    """``norm_plan`` of a split entry, which has no wide variant: a row
    of ``c`` columns without a register plan is refused."""
    plan = norm_plan(rows, c, True)
    if plan == NORM_WIDE:
        raise ValueError(f"{name}: no register plan covers a row of {c} "
                         f"columns (the split entries have no wide variant)")
    return plan


def _partial_kernel(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    c = y.shape[-1]
    y2d, z2d = _rows(y, "y", c), _rows(z, "z", c)
    sq = torch.empty(y.shape[:-1], dtype=torch.float32, device=y.device)
    rows = y2d.shape[0]
    if rows:
        fn = _build.bind(_GATED_LIB, "gated_rmsnorm_partial", 3, 7)
        _build.check(fn(y2d.data_ptr(), z2d.data_ptr(), sq.data_ptr(), rows,
                        c, y2d.stride(0), z2d.stride(0),
                        *_split_plan(rows, c, "gated_rmsnorm_partial"),
                        torch.cuda.current_stream(y.device).cuda_stream),
                     "gated_rmsnorm_partial")
        LAUNCHES["gated_rmsnorm_partial"] += 1
    return sq


def _apply_kernel(y: torch.Tensor, z: torch.Tensor, sq: torch.Tensor,
                  scale: torch.Tensor, *, c_total: int,
                  eps: float) -> torch.Tensor:
    c = y.shape[-1]
    y2d, z2d = _rows(y, "y", c), _rows(z, "z", c)
    sq = sq.contiguous()
    out = torch.empty(y.shape, dtype=y.dtype, device=y.device)
    rows = y2d.shape[0]
    if rows:
        fn = _build.bind(_GATED_LIB, "gated_rmsnorm_apply", 5, 8, 1)
        _build.check(fn(y2d.data_ptr(), z2d.data_ptr(), scale.data_ptr(),
                        sq.data_ptr(), out.data_ptr(), rows, c, c_total,
                        y2d.stride(0), z2d.stride(0),
                        *_split_plan(rows, c, "gated_rmsnorm_apply"),
                        float(eps),
                        torch.cuda.current_stream(y.device).cuda_stream),
                     "gated_rmsnorm_apply")
        LAUNCHES["gated_rmsnorm_apply"] += 1
    return out
