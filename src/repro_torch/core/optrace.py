"""Op recording: the port's counterpart of ``repro.core.hlotext``.

The JAX package reads what a step runs from the compiled HLO text; the port
records it while the step runs. ``Recorder`` (or ``record``) runs a callable
once under PyTorch's own interposition, the way
``torch.utils.flop_counter.FlopCounterMode`` does:

- a ``TorchDispatchMode`` below autograd sees every ATen op, forward,
  backward and recomputed, with its input and output shapes and dtypes;
- a ``TorchFunctionMode`` above autograd notes, on each autograd node the
  forward makes, the scope it was made in, so a backward op carries the
  scope of the forward op it differentiates, as JAX's transposes carry
  ``op_name``. The node that runs is read in backward with
  ``torch._C._current_autograd_node()``;
- ``checkpoint_contexts`` is the ``context_fn`` of the port's
  ``torch.utils.checkpoint`` calls: a block's recompute runs under the
  scopes that were open where the block ran forward, as JAX's
  ``rematted_computation`` keeps its ``op_name``.

``scope(name)`` is the counterpart of ``jax.named_scope``; scopes nest into
a ``/``-joined path. A hand-written kernel's public wrapper is one op of
the trace (``kernel_op``): its own name ends its scope path, as an HLO
``op_name`` ends with its primitive, and the ATen ops inside the call (the
plain version's, on the CPU) are its body. With no recorder active a scope
is one flag check on entry and one on exit, and a wrapper one call and one
flag check; neither enters a profiler range.

With ``profile=True`` every op that can launch device work runs inside a
profiler range ``optrace#<index>``; ``device_times`` then gives each
device kernel of a ``torch.profiler`` window to the op whose range held its
launch.

Also here, as in ``hlotext``: ``tensor_bytes`` (``shape_bytes``), the
collective records with JAX's ring wire model, ``categorize_ops`` and
``count_fusions``. Collective wire bytes (ring algorithms)::

    all-reduce       2 (g-1)/g * bytes      (reduce-scatter + all-gather phases)
    all-gather       (g-1)/g   * out_bytes
    reduce-scatter   (g-1)/g   * in_bytes
    all-to-all       (g-1)/g   * bytes
    collective-permute bytes

On one device a trace holds no collective; recording c10d ops waits for
tensor parallelism.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

# HLO element type -> bytes: ``repro.core.hlotext._DTYPE_BYTES``, copied
_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
}

# torch dtype -> its HLO element type
HLO_TYPES = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.float8_e4m3fn: "f8e4m3fn",
    torch.float8_e5m2: "f8e5m2", torch.int64: "s64", torch.uint64: "u64",
    torch.int32: "s32", torch.uint32: "u32", torch.int16: "s16",
    torch.uint16: "u16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}


def tensor_bytes(shape, dtype) -> int:
    """Bytes of a dense array of ``shape`` and ``dtype`` (a torch dtype or
    an HLO element type such as ``"bf16"``); 0 for a type outside the
    table, as ``shape_bytes`` skips one."""
    name = HLO_TYPES.get(dtype, dtype)
    if name not in _DTYPE_BYTES:
        return 0
    n = 1
    for d in shape:
        n *= int(d)
    return n * _DTYPE_BYTES[name]


# ------------------------------------------------------------ collectives --

@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    operand_bytes: int
    group_size: int
    crosses_pod: bool
    name: str

    @property
    def wire_bytes(self) -> float:
        g = max(self.group_size, 1)
        if g == 1:
            return 0.0
        frac = (g - 1) / g
        if self.kind == "all-reduce":
            return 2.0 * frac * self.operand_bytes
        if self.kind == "all-gather":
            return frac * self.result_bytes
        if self.kind == "reduce-scatter":
            return frac * self.operand_bytes
        if self.kind in ("all-to-all", "ragged-all-to-all"):
            return frac * self.operand_bytes
        if self.kind == "collective-broadcast":
            return self.result_bytes
        return float(self.operand_bytes)   # collective-permute


@dataclasses.dataclass
class CollectiveSummary:
    ops: List[CollectiveOp]

    @property
    def operand_bytes(self) -> float:
        return float(sum(o.operand_bytes for o in self.ops))

    @property
    def result_bytes(self) -> float:
        return float(sum(o.result_bytes for o in self.ops))

    @property
    def wire_bytes_ici(self) -> float:
        return float(sum(o.wire_bytes for o in self.ops if not o.crosses_pod))

    @property
    def wire_bytes_dcn(self) -> float:
        return float(sum(o.wire_bytes for o in self.ops if o.crosses_pod))

    def by_kind(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for o in self.ops:
            d = out.setdefault(o.kind, {"count": 0, "operand_bytes": 0.0,
                                        "wire_bytes": 0.0})
            d["count"] += 1
            d["operand_bytes"] += o.operand_bytes
            d["wire_bytes"] += o.wire_bytes
        return out

    def to_dict(self) -> Dict:
        return {"operand_bytes": self.operand_bytes,
                "result_bytes": self.result_bytes,
                "wire_bytes_ici": self.wire_bytes_ici,
                "wire_bytes_dcn": self.wire_bytes_dcn,
                "count": len(self.ops),
                "by_kind": self.by_kind()}

    def collectives(self):
        """The ``roofline.Collectives`` record ``compute_terms`` reads."""
        from .roofline import Collectives
        return Collectives(operand_bytes=self.operand_bytes,
                           wire_bytes_ici=self.wire_bytes_ici,
                           wire_bytes_dcn=self.wire_bytes_dcn)


# ------------------------------------------------------------ op taxonomy --

GEMM_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "addbmm", "mv",
                      "addmv", "dot", "vdot", "convolution"})
# composite kernels priced as an XLA fusion: (flops per element of the
# first input, flops per row), the elementwise and reduce ops XLA would
# fuse into one body
FUSED_OPS = {
    "_softmax": (5, 0),                     # max, sub, exp, sum, div
    "_log_softmax": (5, 1),                 # max, sub, exp, sum, sub; log
    "_softmax_backward_data": (4, 0),       # mul, sum, sub, mul
    "_log_softmax_backward_data": (4, 0),   # exp, sum, mul, sub
    "logsumexp": (4, 2),                    # max, sub, exp, sum; log, add
    "native_layer_norm": (7, 2),            # mean, sub, sq, mean, 3 affine
    "native_layer_norm_backward": (12, 0),
    "nll_loss_forward": (0, 2),             # gather + negate, sum
    "nll_loss_backward": (0, 1),
    "native_dropout": (2, 0),
}
REDUCTION_OPS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
    "any", "all", "linalg_vector_norm", "norm", "var", "std", "var_mean",
    "std_mean", "cumsum", "cumprod", "count_nonzero", "nansum", "aminmax"})
SORT_OPS = frozenset({"sort", "topk", "kthvalue", "argsort", "msort",
                      "unique", "_unique2", "unique_consecutive",
                      "unique_dim", "median", "mode", "searchsorted",
                      "randperm"})
# data movement: windows read (bytes = 2 x result), windows written (2 x
# the update; the argument index of the update), copies (source + result),
# constructors and fills (the result)
WINDOW_READ_OPS = frozenset({"index", "index_select", "gather", "embedding",
                             "take", "masked_select", "narrow_copy",
                             "_unsafe_index"})
WINDOW_WRITE_OPS = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
                    "scatter": 3, "scatter_": 3, "scatter_add": 3,
                    "scatter_add_": 3, "scatter_reduce": 3,
                    "scatter_reduce_": 3, "index_add": 3, "index_add_": 3,
                    "index_copy": 3, "index_copy_": 3, "slice_scatter": 1,
                    "select_scatter": 1, "diagonal_scatter": 1,
                    "embedding_dense_backward": 0, "masked_scatter": 2,
                    "masked_scatter_": 2}
COPY_OPS = frozenset({"copy_", "_to_copy", "clone", "_copy_from",
                      "lift_fresh_copy", "_pin_memory",
                      "_local_scalar_dense"})
FILL_OPS = frozenset({"zeros", "ones", "full", "zeros_like", "ones_like",
                      "full_like", "fill_", "zero_", "new_zeros",
                      "new_ones", "new_full", "arange", "scalar_tensor",
                      "eye", "linspace", "normal_", "uniform_", "randn",
                      "rand", "randint", "randn_like", "rand_like",
                      "bernoulli_", "bernoulli"})
MOVE_OPS = frozenset({"cat", "stack", "constant_pad_nd", "flip", "roll",
                      "select_backward", "slice_backward",
                      "repeat", "repeat_interleave", "tril", "triu",
                      "expand_copy", "permute_copy", "view_copy",
                      "transpose_copy", "unfold_copy", "split_with_sizes_copy",
                      "_unsafe_view_copy", "pad"})
FREE_OPS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided", "detach", "_unsafe_view",
                      "lift_fresh", "alias", "set_", "resize_",
                      "record_stream", "is_pinned", "is_same_size",
                      "_has_compatible_shallow_copy_type", "sym_size",
                      "sym_stride", "sym_numel", "sym_storage_offset",
                      "resolve_conj", "resolve_neg", "_reshape_alias",
                      "_assert_tensor_metadata", "is_nonzero"})


@functools.lru_cache(maxsize=None)
def category(func) -> str:
    """The taxonomy class of an ATen op (an ``OpOverload``): ``free``,
    ``gemm``, ``fusion`` (a composite kernel priced as an XLA fusion),
    ``collective``, ``sort``, ``data_movement``, ``elementwise``
    (``torch.Tag.pointwise``), ``reduction`` or ``other``."""
    name = func.overloadpacket.__name__
    if func.namespace in ("profiler", "prim") or name in FREE_OPS:
        return "free"
    returns = func._schema.returns
    if returns and all(r.alias_info is not None and not r.alias_info.is_write
                       for r in returns):
        return "free"                           # a view
    if name in GEMM_OPS:
        return "gemm"
    if name in FUSED_OPS:
        return "fusion"
    if func.namespace == "c10d" or name.startswith("_c10d"):
        return "collective"
    if name in SORT_OPS:
        return "sort"
    if (name in WINDOW_READ_OPS or name in WINDOW_WRITE_OPS
            or name in COPY_OPS or name in FILL_OPS or name in MOVE_OPS):
        return "data_movement"
    if torch.Tag.pointwise in func.tags:
        return "elementwise"
    if name in REDUCTION_OPS:
        return "reduction"
    return "other"


# kernel-name fragments of ATen's and cuBLAS's CUDA kernels -> the taxonomy
# class of the op that launches them, first match wins (the functor in an
# at::native kernel's name is its op's)
_KERNEL_CLASSES = (
    ("gemm", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")),
    ("data_movement", ("index_put", "indexing_backward",
                       "embedding_backward")),
    ("sort", ("sort", "radix", "topk", "searchsorted", "bitonic")),
    ("fusion", ("softmax", "layer_norm", "layernorm", "logsumexp",
                "nll_loss")),
    ("reduction", ("reduce_kernel", "argmax", "argmin", "cumsum", "scan",
                   "norm_kernel")),
    ("data_movement", ("copy", "index", "gather", "scatter", "catarray",
                       "fill", "arange", "embedding", "memcpy", "memset",
                       "constant_pad", "flip", "roll", "repeat")),
    ("elementwise", ("elementwise", "functor", "pointwise")),
)


def kernel_category(name: str) -> str:
    """The taxonomy class of the op that launched a CUDA kernel, from the
    kernel's name: for profiles that record the card's activity only, with
    no host op to link a kernel to. ``other`` when the name shows none."""
    low = name.lower()
    for cat, frags in _KERNEL_CLASSES:
        if any(f in low for f in frags):
            return cat
    return "other"


class TensorMeta(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return tensor_bytes(self.shape, self.dtype)


def _meta(x):
    """Tensors -> TensorMeta through lists and tuples; other values kept."""
    if isinstance(x, torch.Tensor):
        return TensorMeta(tuple(x.shape), x.dtype)
    if isinstance(x, list):
        return [_meta(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_meta(v) for v in x)
    return x


def tensors(x) -> List:
    """The TensorMeta (or tensors) in a nest of lists, tuples and dicts."""
    if isinstance(x, (torch.Tensor, TensorMeta)):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in tensors(v)]
    return []


@dataclasses.dataclass
class Op:
    """One op of a trace. ``args`` / ``kwargs`` / ``outputs`` hold
    TensorMeta in place of tensors. A kernel op (``kernel=True``) is one
    hand-written kernel's wrapper call: ``body`` its ATen ops, ``stated``
    the FLOPs its ``ops.py`` states for the call's shapes, ``returned``
    False where a recompute stopped early inside the call."""
    index: int
    name: str
    category: str
    scope: str                  # "/"-joined scope path, "" when unscoped
    phase: str                  # fwd | bwd | remat
    device: str
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)
    outputs: tuple = ()
    kernel: bool = False
    body: List["Op"] = dataclasses.field(default_factory=list)
    stated: float = 0.0
    returned: bool = True


def categorize_ops(ops: List[Op]) -> Dict[str, int]:
    """Count a trace's ops by the taxonomy (free ops left out)."""
    counts: Dict[str, int] = defaultdict(int)
    for op in ops:
        if op.category != "free":
            counts[op.category] += 1
    return dict(counts)


def count_fusions(ops: List[Op]) -> Dict[str, int]:
    """Hand-written kernel calls in a trace, by kernel name (the sum is
    JAX's fusion count's counterpart)."""
    counts: Dict[str, int] = defaultdict(int)
    for op in ops:
        if op.kernel:
            counts[op.name] += 1
    return dict(counts)


# ----------------------------------------------------------------- recorder --

_KEY = "repro_scope"                        # an autograd node's scope
# the recorder of the process: scopes and kernel wrappers are reached from
# model code that takes no recorder argument, as jax.named_scope's context
_ACTIVE: Optional["Recorder"] = None
_RANGE = "optrace#"


class scope:
    """``with scope("mlp"): ...``: ``jax.named_scope``'s counterpart. A
    flag check when no recorder is active."""
    __slots__ = ("name", "_rec")

    def __init__(self, name: str):
        self.name = name
        self._rec = None

    def __enter__(self):
        rec = _ACTIVE
        if rec is not None:
            rec.stack.append(self.name)
            self._rec = rec
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec.stack.pop()
            self._rec = None
        return False


class _Recompute:
    """The recompute half of ``checkpoint_contexts``: the forward's scope
    stack, noted when the block ran forward, set again for its recompute."""

    def __init__(self, stack: List[str]):
        self.saved = list(stack)
        self.rec = None

    def __enter__(self):
        rec = _ACTIVE
        if rec is not None:
            self.rec = rec
            self.outer = (rec.stack, rec.recompute)
            rec.stack, rec.recompute = list(self.saved), True
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.stack, self.rec.recompute = self.outer
            self.rec = None
        return False


def checkpoint_contexts():
    """``context_fn`` for ``torch.utils.checkpoint``: nothing around the
    forward; the recompute under the forward's scopes."""
    rec = _ACTIVE
    if rec is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    return contextlib.nullcontext(), _Recompute(rec.stack)


def kernel_op(name: str, flops: Callable[..., float]):
    """Decorate a hand-written kernel's public wrapper: under a recorder
    the call is one op named ``name``; ``flops(*args, **kwargs)`` is the
    count of FLOPs its ``ops.py`` states for the call's shapes."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            rec = _ACTIVE
            if rec is None:
                return fn(*args, **kwargs)
            return rec.kernel_call(name, flops, fn, args, kwargs)
        return wrapper
    return deco


class _Dispatch(TorchDispatchMode):
    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "profiler":
            return func(*args, **kwargs)
        rec = self.rec
        cat = category(func)
        scope_, phase = rec.where()
        op = Op(index=-1, name=func.overloadpacket.__name__, category=cat,
                scope=scope_, phase=phase, device=_device(args, kwargs),
                args=_meta(args), kwargs=_meta(kwargs))
        if rec.profile and rec.kernel is None and cat != "free":
            op.index = rec.next_index()
            with torch._C._profiler._RecordFunctionFast(
                    f"{_RANGE}{op.index}"):
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        op.outputs = _meta(out if isinstance(out, tuple) else (out,))
        rec.add(op)
        return out


class _Tagger(TorchFunctionMode):
    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_grad_enabled():
            self.rec.tag(out, self.rec.where()[0])
        return out


def _device(args, kwargs) -> str:
    for t in tensors(args) + tensors(kwargs):
        if isinstance(t, torch.Tensor):
            return t.device.type
    return "cpu"


class Recorder:
    """Records every op a region runs (see the module docstring). One at a
    time; ``ops`` is the trace."""

    def __init__(self, profile: bool = False):
        self.profile = profile
        self.ops: List[Op] = []
        self.stack: List[str] = []
        self.recompute = False
        self.kernel: Optional[Op] = None
        self._next = 0
        self._modes = []

    def next_index(self) -> int:
        i = self._next
        self._next += 1
        return i

    def where(self) -> Tuple[str, str]:
        """(scope, phase) of an op issued now."""
        if self.recompute:
            return "/".join(self.stack), "remat"
        node = torch._C._current_autograd_node()
        if node is not None:
            return node.metadata.get(_KEY, ""), "bwd"
        if torch._C._current_graph_task_id() != -1:
            return "", "bwd"
        return "/".join(self.stack), "fwd"

    def add(self, op: Op) -> None:
        if self.kernel is not None:
            self.kernel.body.append(op)
            return
        if op.index < 0:
            op.index = self.next_index()
        self.ops.append(op)

    def tag(self, out, scope_: str) -> None:
        """Note ``scope_`` on every autograd node behind ``out`` that has
        none yet."""
        todo = [t.grad_fn for t in tensors(out)
                if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        while todo:
            node = todo.pop()
            if node is None:
                continue
            meta = node.metadata
            if _KEY in meta:
                continue
            meta[_KEY] = scope_
            todo.extend(n for n, _ in node.next_functions)

    def kernel_call(self, name, flops, fn, args, kwargs):
        if self.kernel is not None:            # inside another kernel op
            return fn(*args, **kwargs)
        self.stack.append(name)
        scope_, phase = self.where()
        op = Op(index=self.next_index(), name=name, category="fusion",
                scope=scope_, phase=phase, device=_device(args, kwargs),
                args=_meta(args), kwargs=_meta(kwargs), kernel=True,
                stated=float(flops(*args, **kwargs)))
        self.kernel = op
        op.returned = False
        try:
            if self.profile:
                with torch._C._profiler._RecordFunctionFast(
                        f"{_RANGE}{op.index}"):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
        finally:
            # also when a recompute stops early inside the call (the
            # checkpoint raises once the last tensor it needs is saved):
            # the kernel ran
            self.kernel = None
            self.stack.pop()
            self.ops.append(op)
        op.returned = True
        op.outputs = _meta(out if isinstance(out, tuple) else (out,))
        self.tag(out, scope_)
        return out

    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a recorder is already active")
        _ACTIVE = self
        self._modes = [_Tagger(self), _Dispatch(self)]
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        for m in reversed(self._modes):
            m.__exit__(*exc)
        self._modes = []
        _ACTIVE = None
        return False


def record(fn: Callable, *args, profile: bool = False, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under a recorder -> (its result,
    the trace)."""
    with Recorder(profile=profile) as rec:
        out = fn(*args, **kwargs)
    return out, rec.ops


# ---------------------------------------------------- device time per op --

_RUNTIME = "cu"                 # the CUDA runtime's and driver's calls


def device_times(prof) -> Dict:
    """Device time of a ``torch.profiler`` window recorded around a
    ``Recorder(profile=True)``, given to the ops of the trace:
    ``{"per_op": {op index: device ms}, "busy_ms", "unattributed_ms",
    "kernels"}``. Each device activity (kernel, copy, set) goes to the
    ``optrace#`` range that held the host op it is linked to (the innermost
    op or range open at its launch); failing a link, to the range that
    held the runtime call that launched it (matched by correlation id; the
    runtime's own thread ids are mapped to the profiler's through the
    runtime calls that are linked). Ranges mirrored onto the device
    timeline are not device work."""
    events = prof.profiler.kineto_results.events()
    ranges: Dict[int, List[Tuple[int, int, int]]] = defaultdict(list)
    runtime: Dict[int, Tuple[int, int, int]] = {}
    cpu_ops: Dict[int, Tuple[int, int]] = {}
    device = []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if name.startswith(_RUNTIME):
                runtime[e.correlation_id()] = (
                    e.start_thread_id(), e.start_ns(),
                    e.linked_correlation_id())
                continue
            if name.startswith(_RANGE):
                ranges[e.start_thread_id()].append(
                    (e.start_ns(), e.end_ns(), int(name[len(_RANGE):])))
            cpu_ops[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
        elif not (e.is_user_annotation() or name.startswith(_RANGE)
                  or name.startswith("train_step/")):
            device.append(e)
    starts = {}
    for thread, v in ranges.items():
        v.sort()
        starts[thread] = [r[0] for r in v]
    threads = {tid: cpu_ops[link][0] for tid, _, link in runtime.values()
               if link in cpu_ops}

    def holder(thread: int, t: int) -> Optional[int]:
        """The range holding time ``t`` on ``thread`` (op ranges of one
        thread never nest: an op's own calls are not recorded)."""
        i = bisect.bisect_right(starts.get(thread, ()), t) - 1
        if i < 0:
            return None
        _, end, idx = ranges[thread][i]
        return idx if t <= end else None

    def owner(e) -> Optional[int]:
        link = cpu_ops.get(e.linked_correlation_id())
        idx = holder(*link) if link else None
        call = runtime.get(e.correlation_id())
        if idx is None and call is not None:
            link = cpu_ops.get(call[2])
            if link is not None:
                idx = holder(*link)
            elif call[0] in threads:
                idx = holder(threads[call[0]], call[1])
        return idx

    per_op: Dict[int, float] = defaultdict(float)
    busy = unattributed = 0.0
    for e in device:
        ms = e.duration_ns() / 1e6
        if ms <= 0:
            continue
        busy += ms
        idx = owner(e)
        if idx is None:
            unattributed += ms
        else:
            per_op[idx] += ms
    return {"per_op": dict(per_op), "busy_ms": busy,
            "unattributed_ms": unattributed, "kernels": len(device)}
