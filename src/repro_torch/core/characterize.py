"""Operator-level cost engine over a recorded trace: the paper's
methodology, ported from ``repro.core.characterize``.

JAX walks the compiled HLO module; the port runs the callable once under
``optrace.Recorder`` and walks the ops it ran, forward, backward and
recomputed (a Python loop is recorded step by step, so there is no trip
count to multiply). Each op is priced, then bucketed by the paper's
taxonomy (``by_category``) and by its scope path (``by_scope``; scopes are
``optrace.scope``, the counterpart of ``jax.named_scope``), which
``bucket_scopes`` folds into the Fig. 4/5 buckets.

Pricing rules, JAX's rule by rule, mapped to ATen (shapes are the
device's own; one device):

  JAX (HLO)        ATen ops (``optrace`` sets)         priced
  dot, conv        mm, addmm, bmm, baddbmm, addbmm,    flops = 2 * prod(out) * K
                   mv, addmv, dot, vdot, convolution   (+ prod(out) for the
                   (``gemm``)                          add of addmm/baddbmm/
                                                       addbmm/addmv); bytes =
                                                       operands + result
  fusion           a hand-written kernel's wrapper     bytes = tensor arguments
                   call (``optrace.kernel_op``; the    + results; flops = its
                   kernel's ops are its body) and      body's: the priced ATen
                   composite kernels: _softmax,        ops of the call on the
                   _log_softmax, their backwards,      CPU, the count its
                   logsumexp, native_layer_norm(_      ``ops.py`` states for
                   backward), nll_loss_forward/        the shapes on the card
                   backward, native_dropout            (and for a call that an
                   (``fusion``)                        early-stopped recompute
                                                       cut short); a composite,
                                                       per element and per row
                                                       as ``optrace.FUSED_OPS``
  elementwise      every op tagged                     flops = prod(result);
                   ``torch.Tag.pointwise``             bytes = operands + result
                   (``elementwise``)
  reduce           sum, mean, amax, max.dim, argmax,   flops = input elements;
                   linalg_vector_norm, var, cumsum,    bytes = input + result
                   ... (``reduction``)
  gather, slice,   index, index_select, gather,        bytes = 2 * result
  dynamic-slice    embedding, ... (read a window)
  scatter, dus     index_put(_), scatter(_add),        bytes = 2 * update
                   index_add(_), slice_scatter,
                   embedding_dense_backward, ...
  copy             copy_, _to_copy, clone              bytes = source + result
  convert          (the same casts: see below)
  broadcast, iota  zeros, full, fill_, arange, ...     bytes = result
  data movement    cat, stack, constant_pad_nd, ...    bytes = operands + result
  sort             sort, topk, searchsorted, ...       bytes = operands + result
  free             views (a schema whose results       nothing
                   alias an input unwritten), empty*,
                   detach, _unsafe_view, profiler ops
  collective       c10d ops (none on one device)       bytes = operands (+ wire
                                                       model in ``optrace``)
  other            any other op                        bytes = operands + result

One stated exception: JAX prices ``convert`` as free, because the TPU
fuses casts into their neighbours. On the card every cast is a kernel of
its own, so the port prices ``_to_copy`` / ``copy_`` as data movement.
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

from . import optrace
from .optrace import CollectiveOp, CollectiveSummary, Op, TensorMeta
from .roofline import H100, DeviceSpec


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    by_category: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    by_category_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    by_scope: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    by_scope_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collectives: List[CollectiveOp] = dataclasses.field(default_factory=list)
    ops: List[Op] = dataclasses.field(default_factory=list)

    def summary(self) -> CollectiveSummary:
        return CollectiveSummary(self.collectives)

    def kernels(self) -> Dict[str, int]:
        """Hand-written kernel calls by name (``optrace.count_fusions``)."""
        return optrace.count_fusions(self.ops)


# -------------------------------------------------------------------- pricing --

def _numel(t) -> int:
    return t.numel if isinstance(t, TensorMeta) else 0


def _nbytes(x) -> float:
    return float(sum(t.nbytes for t in optrace.tensors(x)))


def _rows(op: Op, n: int) -> int:
    """Rows of a composite kernel (the per-row part of its body)."""
    a = op.args
    if op.name in ("_softmax", "_log_softmax"):
        return n // max(a[0].shape[a[1]], 1) if a[0].shape else 1
    if op.name == "logsumexp":
        return _numel(op.outputs[0])
    if op.name == "native_layer_norm":
        inner = 1
        for d in a[1]:
            inner *= d
        return n // max(inner, 1)
    if op.name == "nll_loss_forward":
        return _numel(a[1])
    if op.name == "nll_loss_backward":
        return _numel(a[2])
    return 0


def _gemm_flops(op: Op) -> float:
    a, name = op.args, op.name
    out = _numel(op.outputs[0])
    if name == "convolution":
        k = 1
        for d in a[1].shape[1:]:
            k *= d
        return 2.0 * out * k
    add = name in ("addmm", "baddbmm", "addbmm", "addmv")
    m1, m2 = (a[1], a[2]) if add else (a[0], a[1])
    if name in ("mv", "addmv", "dot", "vdot"):
        f = 2.0 * m1.numel
    else:                                   # [..., M, K] @ [..., K, N]
        f = 2.0 * m1.numel * m2.shape[-1]
    return f + (out if add else 0.0)


def price(op: Op) -> Tuple[float, float]:
    """(flops, bytes) of one op of a trace, by the rules above."""
    cat, name = op.category, op.name
    if cat == "free":
        return 0.0, 0.0
    ins, outs = _nbytes((op.args, op.kwargs)), _nbytes(op.outputs)
    if op.kernel:
        # a call a recompute cut short ran whole on the card (the kernel
        # launches before its arguments are saved); its stated count
        if op.device == "cpu" and op.returned:
            flops = sum(price(o)[0] for o in op.body)
        else:
            flops = op.stated
        return float(flops), ins + outs
    if cat == "gemm":
        return _gemm_flops(op), ins + outs
    if cat == "fusion":
        per_elem, per_row = optrace.FUSED_OPS[name]
        n = _numel(optrace.tensors(op.args)[0])
        return float(per_elem * n + per_row * _rows(op, n)), ins + outs
    if cat == "elementwise":
        return float(sum(_numel(t) for t in optrace.tensors(op.outputs))), \
            ins + outs
    if cat == "reduction":
        first = optrace.tensors(op.args)
        return float(_numel(first[0]) if first else 0), ins + outs
    if cat == "data_movement":
        if name in optrace.WINDOW_READ_OPS:
            return 0.0, 2.0 * outs
        if name in optrace.WINDOW_WRITE_OPS:
            i = optrace.WINDOW_WRITE_OPS[name]
            upd = op.args[i] if i < len(op.args) else None
            return 0.0, 2.0 * (_nbytes(upd) or outs)
        if name == "copy_":
            return 0.0, _nbytes(op.args[1]) + outs
        if name in optrace.FILL_OPS:
            return 0.0, outs
        if name == "_local_scalar_dense":
            return 0.0, ins
        return 0.0, ins + outs
    return 0.0, ins + outs                  # sort, collective, other


def cost_of(ops: List[Op]) -> Cost:
    """Price every op of a trace and bucket the costs."""
    cost = Cost(ops=ops)
    for op in ops:
        if op.category == "free":
            continue
        f, b = price(op)
        key = op.scope or "unscoped"
        cost.flops += f
        cost.bytes += b
        cost.by_category[op.category] += f
        cost.by_category_bytes[op.category] += b
        cost.by_scope[key] += f
        cost.by_scope_bytes[key] += b
    return cost


def analyze(fn: Callable, *args, n_devices: int = 1, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` once under a recorder and price what it
    ran: ``analyze_text``'s counterpart. Put the inputs on the device to
    characterize (``device="cpu"`` entry points for the CPU). ``n_devices``
    is ``analyze_text``'s; a one-device trace holds no collective."""
    _, ops = optrace.record(fn, *args, **kwargs)
    return cost_of(ops)


# ------------------------------------------------------- scope bucketing ----------

_SCOPE_BUCKETS = (
    ("lamb", re.compile(r"lamb|optimizer|adamw|sgd", re.I)),
    ("attn_linear", re.compile(r"attn_qkv|attn_out|qkv_project", re.I)),
    ("attn_bgemm", re.compile(r"attn_core|attn_softmax", re.I)),
    ("moe", re.compile(r"moe", re.I)),
    ("mlp", re.compile(r"mlp|gelu|swiglu", re.I)),
    ("ssm", re.compile(r"mamba|ssd", re.I)),
    ("norm", re.compile(r"norm|ln", re.I)),
    ("embed_or_head", re.compile(r"embed|logits|unembed|head", re.I)),
    ("loss", re.compile(r"loss|cross_entropy|softmax_xent", re.I)),
)


def bucket_of(scope: str) -> str:
    for bucket, pat in _SCOPE_BUCKETS:
        if pat.search(scope):
            return bucket
    return "other"


def bucket_scopes(by_scope: Dict[str, float]) -> Dict[str, float]:
    """Fold fine-grained scopes into paper-style buckets (Fig 4/5)."""
    out: Dict[str, float] = defaultdict(float)
    for scope, v in by_scope.items():
        out[bucket_of(scope)] += v
    return dict(out)


# ------------------------------------------------ the paper's phases ----------

def paper_phase(op: Op) -> str:
    """The ``analytical.phase_times`` phase an op belongs to: its bucket,
    GEMMs split from the rest where the paper splits them (the attention
    core into ``attn_bgemm`` and ``attn_softmax``, the MLP into ``fc`` and
    ``activation``); the norm bucket is ``drn``, the embedding and logits
    bucket ``head``; unscoped work is ``other``."""
    bucket = bucket_of(op.scope)
    gemm = op.category == "gemm"
    if bucket == "attn_bgemm":
        return "attn_bgemm" if gemm else "attn_softmax"
    if bucket == "mlp":
        return "fc" if gemm else "activation"
    return {"norm": "drn", "embed_or_head": "head"}.get(bucket, bucket)


def split(ops: List[Op], values: Dict[int, float]) -> Dict[str, Dict]:
    """Per-op values (e.g. device ms by op index) summed by bucket, by
    category, by bucket and category ("bucket/category"), by phase of the
    paper and by pass (fwd / bwd / remat), plus the Fig. 4 split: GEMMs
    outside LAMB, LAMB, everything else."""
    out = {k: defaultdict(float) for k in ("bucket", "category", "cell",
                                           "paper", "pass", "fig4")}
    for op in ops:
        v = values.get(op.index, 0.0)
        if not v:
            continue
        phase, bucket = paper_phase(op), bucket_of(op.scope)
        out["bucket"][bucket] += v
        out["category"][op.category] += v
        out["cell"][f"{bucket}/{op.category}"] += v
        out["paper"][phase] += v
        out["pass"][op.phase] += v
        out["fig4"]["lamb" if phase == "lamb" else
                    "gemm" if op.category == "gemm" else "non_gemm"] += v
    return {k: dict(v) for k, v in out.items()}


def roofline_ms(ops: List[Op], dev: DeviceSpec = H100) -> Dict[int, float]:
    """Each op's roofline time in ms: max(FLOPs / peak, bytes / HBM)."""
    out = {}
    for op in ops:
        f, b = price(op)
        if f or b:
            out[op.index] = max(f / dev.peak_flops, b / dev.hbm_bw) * 1e3
    return out
