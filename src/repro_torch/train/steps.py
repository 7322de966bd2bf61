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

On a mesh whose ``model`` axis holds tp > 1 ranks (every family: dense,
moe, vlm, ssm, hybrid and encdec) the step is JAX's under ``make_rules``:
each rank holds its block of every leaf under the sanitized
``param_pspecs`` (``state_specs``; the model ranks of a data coordinate
see the same rows), the layers run the rank's heads, MLP columns, mamba
heads and experts with the collectives GSPMD derives written out
(``parallel.collectives``: Megatron's entry and exit of the tensor-
parallel region, by sequence under ``seq_parallel``, FSDP's weight
gathers, the vocab-parallel embedding, logits and cross entropy, a mamba
layer's B and C gather and its gated norm's row statistic, the encoder
output's entry into the cross-attention), and ``zero_collectives``
states what a step runs. A ``pod`` axis (``make_rules(multi_pod=True)``)
splits the batch rows over (pod, data), pod-major; the ZeRO layout stays
within a pod and is replicated across pods, as JAX's
``opt_state_pspecs`` says, so each step adds one all-reduce of the
rank's reduced shard over the pod axis (the middle step of
``hierarchical_psum``) and the norms sum over one pod's ranks.
``_mesh_axes`` is the one place that reads the mesh and the rules, and
refuses what is not ported (an axis of another name; a rules table other
than ``make_rules``' options, such as an ``overrides`` table).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional

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
    mesh: Optional["MeshAxes"] = None   # the mesh as the step reads it
    specs: Any = None   # the sanitized specs of the whole leaves (init)
    # the leaves (indices in tree.leaves order) every model rank holds
    # whole whose gradients are partial sums there (init)
    partial: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MeshAxes:
    """The mesh as a train step reads it (``_mesh_axes``): the axes'
    sizes and this rank's coordinates, the rules, and the groups: ``data``,
    ``model`` and ``pod`` (None where the axis has one rank); ``batch``,
    the ranks sharing a model coordinate, over which the batch rows split
    ((pod, data); None where that is one rank); and ``norms``, the group
    over which the optimizer sums squared norms (the data group, or one
    pod's (data, model) ranks where the model axis is wider than one
    rank: every pod holds the same shards after the pod's all-reduce)."""
    sizes: Dict[str, int]
    coords: Dict[str, int]
    rules: Dict[str, Any]
    data: Any = None
    model: Any = None
    pod: Any = None
    batch: Any = None
    norms: Any = None

    @property
    def dp(self) -> int:
        return self.sizes.get("data", 1)

    @property
    def tp(self) -> int:
        return self.sizes.get("model", 1)

    @property
    def pods(self) -> int:
        return self.sizes.get("pod", 1)

    def parallel(self, params=None, specs=None) -> collectives.Parallel:
        """The layers' view (``collectives.Parallel``); with a rank's
        ``params`` and their ``specs``, which tensors hold FSDP slices."""
        fsdp = {}
        if params is not None and self.dp > 1:
            for t, sp in zip(tree.leaves(params), tree.leaves(specs)):
                dims = sharding.split_dims(sp, "data")
                if dims:
                    fsdp[id(t)] = dims[0]
        return collectives.Parallel(
            model=self.model, tp=self.tp,
            mrank=self.coords.get("model", 0), data=self.data, dp=self.dp,
            pods=self.pods,
            seq=self.tp > 1 and self.rules.get("seq") == "model",
            experts=self.tp > 1 and self.rules.get("experts") == "model",
            fsdp=fsdp)


# the step's rules by default: JAX's make_rules() with the weights whole on
# the data axis (ZeRO-1 shards the optimizer state only)
STEP_RULES = sharding.make_rules(fsdp=False)


def state_specs(params, rules, axis_sizes) -> Any:
    """The sanitized spec of every whole parameter leaf (JAX's
    ``state_specs`` for the params under ``sh.activate(mesh, rules)``,
    each dim an axis does not divide left whole)."""
    return sharding.sanitize_tree(sharding.param_pspecs(params, rules),
                                  params, axis_sizes)


def zero_collectives(run: RunConfig, dp: int, tp: int = 1,
                     rules: Optional[Dict[str, Any]] = None,
                     specs: Any = None, pods: int = 1) -> Dict[str, int]:
    """The collectives one ZeRO step runs on each rank of a mesh of pods x
    dp x tp ranks, by kind. Over the batch's ranks ((pod, data)): the
    micro-batches' mask counts (1 all-reduce) and the metrics (1), one a
    MoE layer a micro-batch for the Switch loss's sums (twice under
    ``remat``: the recompute runs it again). On the data axis one
    ``reduce_scatter`` and one ``all_gather`` of the flat layout; over the
    pod axis one all-reduce of the reduced shards; over the data axis, or
    a pod's (data, model) ranks with a model axis: the clip's norm (1
    where ``grad_clip`` > 0), LAMB's gradient norm and its partial norms
    (2, and 1 more over the model axis where both are wider than one
    rank). None at pods = dp = tp = 1.

    With FSDP (``specs``, the sanitized specs of the whole leaves, with
    "data" on a dim) each sliced weight is gathered once a use (twice
    under ``remat`` inside a block of either stack; the tied embedding is
    used twice) and its gradient reduce-scattered once. With a model axis
    a micro-batch runs, by ``_model_axis_collectives``: the embedding's
    exit, every sublayer's entry and exit of the tensor-parallel region
    (``Parallel.enter`` / ``exit``, or ``column`` / ``row`` around a
    product: all-gather and reduce-scatter under
    sequence parallelism, else an all-reduce in the backward and one in
    the forward) and what runs inside it, the encoder output's entry
    (encdec), the logits' entry and the cross entropy's two all-reduces,
    and one all-reduce of the leaves every model rank holds whole whose
    gradients are partial sums there (every such leaf under sequence
    parallelism; a mamba mixer's whole leaves always). A forward
    collective inside a block runs twice under ``remat``; its backward
    collective once."""
    out = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0}
    if dp == 1 and tp == 1 and pods == 1:
        return out
    rules = STEP_RULES if rules is None else rules
    arch, m = run.arch, run.shape.microbatches
    rr = 2 if arch.remat else 1
    moe = sum(arch.is_moe_layer(i) for i in range(arch.num_layers))
    lamb = run.optimizer == "lamb"
    if dp > 1 or tp > 1:    # the clip's norm, LAMB's norm and its partials
        out["all_reduce"] += (run.grad_clip > 0) + 2 * lamb \
            + (lamb and dp > 1 and tp > 1)
    if dp > 1:
        out["reduce_scatter"] += 1
        out["all_gather"] += 1
    if pods > 1:
        out["all_reduce"] += 1
    if dp * pods > 1:       # the mask counts, the metrics, the Switch sums
        out["all_reduce"] += 2 + moe * m * rr
    if dp > 1 and specs is not None:
        for path, sp in sharding.leaf_items(specs):
            if not sharding.split_dims(sp, "data"):
                continue
            if path[0] in ("blocks", "enc_blocks"):
                uses = rr
            else:
                uses = 2 if (path[-1] == "embedding"
                             and arch.tie_embeddings) else 1
            out["all_gather"] += uses * m
            out["reduce_scatter"] += m if path[0] in (
                "blocks", "enc_blocks") else uses * m
    if tp > 1:
        for k, v in _model_axis_collectives(arch, tp, rules).items():
            out[k] += m * v
    return out


def _model_axis_collectives(arch, tp: int, rules) -> Dict[str, int]:
    """The model axis's collectives of one micro-batch (tp > 1), by kind,
    sublayer by sublayer (``zero_collectives``). The recompute of a block
    stops after the last op whose output the backward needs, so a
    pre-norm block's last exit (only added to the residual) runs once."""
    seq = rules.get("seq") == "model"
    experts = rules.get("experts") == "model"
    rr = 2 if arch.remat else 1
    c = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0}
    fwd = "all_gather" if seq else None     # an entry's forward
    bwd = "reduce_scatter" if seq else "all_reduce"
    out_f = "reduce_scatter" if seq else "all_reduce"
    out_b = "all_gather" if seq else None   # an exit's backward

    def add(kind, n=1):
        if kind is not None:
            c[kind] += n

    def sublayer(kind, times, last):
        """One sublayer's collectives: forward ``times`` (the block's
        recompute), its exit once more only where it is not ``last``."""
        kv = arch.num_kv_heads and arch.num_kv_heads % tp
        entry = exit_ = True
        if kind == "moe":
            shared = arch.moe.num_shared_experts > 0
            entry = seq or experts or shared
            exit_ = experts or shared
            if not seq and experts:
                add("all_reduce")       # the logits' copy into the region
            if seq:
                add("all_reduce", times)  # the Switch sums over the model
        if entry:
            add(fwd, times)
            add(bwd)
        if kind in ("attn", "cross") and kv:    # the K/V columns' gather
            add("all_gather", times)
            add("reduce_scatter")
        if kind == "mamba":
            add("all_gather", times)    # B and C
            add("reduce_scatter")
            add("all_reduce", times + 1)    # the gated norm's statistic
        if exit_:
            add(out_f, 1 if last else times)
            add(out_b)

    from ..models.transformer import _stack_kinds
    stacks = [(_stack_kinds(arch), False)]
    if arch.family == "encdec":
        stacks.append((["attn"] * arch.enc_layers, None))
    for kinds, cross in stacks:
        for i, mixer in enumerate(kinds):
            subs = [mixer]
            if cross is False and arch.family == "encdec":
                subs.append("cross")
            if arch.family != "ssm":
                subs.append("moe" if cross is False and arch.is_moe_layer(i)
                            else "mlp")
            for j, kind in enumerate(subs):
                last = j == len(subs) - 1 and rr > 1 and not arch.post_norm
                sublayer(kind, rr, last)
    add(out_f)          # the embedding's exit
    add(out_b)
    add(fwd)            # the logits' entry
    add(bwd)
    if arch.family == "encdec":     # the encoder output's entry
        add(fwd)
        add(bwd)
    add("all_reduce", 2)            # the cross entropy
    if seq or "mamba" in _stack_kinds(arch):
        add("all_reduce")           # the partial gradients' sum
    return c


def _check_rules(rules) -> None:
    """The layers honour the ``make_rules`` tables that differ only in
    ``multi_pod``, ``seq_parallel``, ``fsdp`` and ``expert_parallel``; any
    other table (an ``overrides`` one) is refused."""
    for pod, seq, fsdp, ep in itertools.product((False, True), repeat=4):
        if rules == sharding.make_rules(pod, seq_parallel=seq, fsdp=fsdp,
                                        expert_parallel=ep):
            return
    raise NotImplementedError(
        f"rules {rules}: the train step honours make_rules(multi_pod=, "
        "seq_parallel=, fsdp=, expert_parallel=) tables only; an overrides "
        "table is not ported")


AXES = ("pod", "data", "model")


def _mesh_axes(run: RunConfig, mesh, rules) -> MeshAxes:
    """The one place that reads the mesh and the rules -> ``MeshAxes``,
    refusing what is not ported: an axis not named pod, data or model, a
    pod axis of more than one rank under rules that do not split the
    batch over it, a rules table the layers do not honour, head or mamba
    segment counts the model axis does not split, and a mesh of more
    than one rank without ZeRO. With a pod axis it makes two more kinds
    of process group (``torch.distributed.new_group``, every rank making
    every group in the same order): the (pod, data) ranks of each model
    coordinate and, with a model axis, the (data, model) ranks of each
    pod."""
    sizes = mesh_lib.axis_sizes(mesh)
    rules = dict(STEP_RULES if rules is None else rules)
    other = {a: n for a, n in sizes.items() if a not in AXES}
    if other:
        raise NotImplementedError(
            f"mesh axes {other}: the train step reads the pod, data and "
            "model axes only")
    _check_rules(rules)
    arch = run.arch
    pods = sizes.get("pod", 1)
    dp, tp = sizes.get("data", 1), sizes.get("model", 1)
    if pods > 1 and "pod" not in sharding._axes(rules["batch"]):
        raise NotImplementedError(
            f"a pod axis of {pods} under rules whose batch is "
            f"{rules['batch']}: the pod axis trains under "
            "make_rules(multi_pod=True)")
    if tp > 1:
        hkv = arch.num_kv_heads
        if arch.num_heads and (arch.num_heads % tp
                               or (hkv % tp and tp % hkv)):
            raise NotImplementedError(
                f"{arch.name}: {arch.num_heads} query and {hkv} KV heads "
                f"over a model axis of {tp}: each rank's heads need tp to "
                "divide Hq and to divide or be divided by Hkv")
        if arch.ssm is not None:
            widths = sharding.mamba_segments(arch, "in_proj")
            if any(w % tp for w in widths):
                raise NotImplementedError(
                    f"{arch.name}: mamba segments {widths} (z, x, B, C, dt)"
                    f" over a model axis of {tp}: tp must divide each")
    if (pods > 1 or dp > 1 or tp > 1) and not (
            run.zero1 and run.optimizer in ("lamb", "adamw")):
        raise NotImplementedError(
            f"pods={pods}, dp={dp}, tp={tp} with zero1={run.zero1} and "
            f"{run.optimizer}: mesh training is ported for ZeRO-1 "
            "(zero1=True, lamb or adamw)")
    coords = mesh_lib.axis_coords(mesh)
    axes = MeshAxes(sizes={"pod": pods, "data": dp, "model": tp},
                    coords={a: coords.get(a, 0) for a in AXES}, rules=rules)
    if dp > 1:
        axes.data = mesh.get_group("data")
    if tp > 1:
        axes.model = mesh.get_group("model")
    if pods > 1:
        axes.pod = mesh.get_group("pod")
        grid, names = mesh.mesh, list(mesh.mesh_dim_names)
        for a in AXES:
            if a not in names:
                grid, names = grid.unsqueeze(-1), names + [a]
        grid = grid.permute([names.index(a) for a in AXES])
        me = dist.get_rank()
        if dp > 1:
            for mc in range(tp):
                ranks = grid[:, :, mc].flatten().tolist()
                g = dist.new_group(ranks)
                if me in ranks:
                    axes.batch = g
        else:
            axes.batch = axes.pod
        if tp > 1:
            for pc in range(pods):
                ranks = grid[pc].flatten().tolist()
                g = dist.new_group(ranks)
                if me in ranks:
                    axes.norms = g
        else:
            axes.norms = axes.data
    else:
        axes.batch = axes.data
        axes.norms = dist.group.WORLD if tp > 1 else axes.data
    return axes


def _model_split(sp) -> int:
    """How the model axis splits a leaf of spec ``sp`` (``zero.Plan``'s
    ``split``): 0 not at all, 2 on the experts' dim (a MoE expert leaf,
    its dim 0 its trust-ratio rows), 1 on another dim."""
    dims = sharding.split_dims(sp, "model")
    if not dims:
        return 0
    return 2 if dims == (0,) and len(sp) == 3 else 1


def _check_split(specs, whole_specs) -> None:
    """Every dim the rules put on the model axis must split over it: the
    layers compute a rank's share of them."""
    for (path, sp), (_, want) in zip(sharding.leaf_items(specs),
                                     sharding.leaf_items(
                                         whole_specs)):
        if sharding.split_dims(want, "model") != \
                sharding.split_dims(sp, "model"):
            raise NotImplementedError(
                f"{'/'.join(path)}: the model axis does not divide the dim "
                f"its rule {want} puts on it (sanitized {sp}); a leaf the "
                "layers split must split evenly")


def _partial_leaf(path: tuple, seq: bool) -> bool:
    """Whether the gradient of a leaf every model rank holds whole is a
    partial sum over the model ranks: every such leaf under sequence
    parallelism (a rank's rows), and a mamba mixer's whole leaves always
    (a rank touches its heads' entries only)."""
    return seq or (len(path) > 1 and path[-2] == "mamba"
                   and path[-1] in ("A_log", "D", "dt_bias", "norm_scale"))


def build_train_step(run: RunConfig, device="cuda", mesh=None,
                     rules: Optional[Dict[str, Any]] = None) -> StepBundle:
    """The train step of ``run`` on ``device``; with ``mesh`` (a
    ``launch.mesh.make_mesh`` mesh with ``data`` and ``model`` axes, and a
    ``pod`` axis under ``make_rules(multi_pod=True)``) this rank's step
    under ``rules`` (JAX's ``make_rules`` table; default ``STEP_RULES``,
    ZeRO-1 with whole weights on the data axis), the counterpart of JAX's
    jit of ``build_train_step(run).fn`` with ``in_shardings`` from
    ``state_specs`` under ``sh.activate(mesh, rules)``.

    On a model axis above one rank each rank holds only its block of
    every leaf under the sanitized ``param_pspecs`` (``sharding.
    train_blocks``): the "tensor" dims and the experts over the model
    axis, the "fsdp" dim over the data axis. The layers compute the
    rank's share (``collectives.Parallel``), the gradients of the leaves
    every model rank holds whole are summed over the model axis where
    they are partial (``_partial_leaf``), and the ZeRO plan shards the
    rest (``zero.Plan``'s ``local`` and ``count``). Over a pod axis the
    pods hold the same blocks and shards, their rows differ, and the
    plan all-reduces each rank's reduced shard over the pod axis."""
    arch, shape = run.arch, run.shape
    device = resolve_device(device)
    opt = make_optimizer(run)
    zero1 = run.zero1 and run.optimizer in ("lamb", "adamw")
    axes = _mesh_axes(run, mesh, rules)
    dp, rank, group = axes.dp, axes.coords["data"], axes.batch
    on_mesh = dp > 1 or axes.tp > 1 or axes.pods > 1
    rows_sizes = {"pod": axes.pods, "data": dp}
    rows_coords = {a: axes.coords[a] for a in rows_sizes}

    def loss_fn(params, batch, par):
        if group is None:
            return model_lib.loss(arch, params, batch, par=par)
        mb, denom = batch
        return model_lib.loss(arch, params, mb, group, denom, par)

    def local(micro: List[Dict[str, torch.Tensor]]):
        """This rank's rows of each micro-batch (over (pod, data), pod-
        major), each with the micro-batch's mask count over every rank
        (one all_reduce over the batch's ranks)."""
        specs = sharding.batch_pspecs(micro[0], axes.rules)
        mine = [{k: v[sharding.local_slice(specs[k], v.shape, rows_sizes,
                                           rows_coords)]
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

    def reduce_partial(grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The partial gradients of the leaves every model rank holds
        whole, summed over the model axis (one all_reduce)."""
        idx = bundle.partial
        flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
        collectives.all_reduce(flat, axes.model)
        for i, part in zip(idx, flat.split([grads[i].numel()
                                            for i in idx])):
            grads[i] = part.view(grads[i].shape).to(grads[i].dtype)
        return grads

    def step(state: Dict, batch: Dict[str, torch.Tensor]) -> Dict:
        params = state["params"]
        plan = bundle.plan
        if zero1 and plan is None:
            raise ValueError("a ZeRO step runs on the state its bundle's "
                             "init made")
        par = axes.parallel(params, bundle.specs) if on_mesh else None
        with record_function("train_step/grads"):
            grads, metrics = grad_lib.accumulate_microbatches(
                lambda p, b: loss_fn(p, b, par), params, batch,
                shape.microbatches, plan=plan,
                local=None if group is None else local,
                reduce=reduce_partial if bundle.partial else None)
            if plan is not None:        # this rank's shards of the chunk
                grads = plan.views(plan.reduce_scatter(grads))
            if group is not None:
                metrics = global_metrics(metrics)
        if run.grad_clip > 0:
            with record_function("train_step/clip"):
                grads, gnorm = grad_lib.clip_by_global_norm(
                    grads, run.grad_clip, axes.norms,
                    None if plan is None else plan.weights(device))
            metrics = dict(metrics, grad_norm=gnorm)
        with record_function("train_step/update"):
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
        (every rank makes the same parameters from the same seed); on a
        mesh the parameters are this rank's blocks of them."""
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = model_lib.init_params(arch, gen, device,
                                           torch_dtype(arch.param_dtype))
        local_ids, split = (), None
        if on_mesh:
            whole = sharding.param_pspecs(params, axes.rules)
            specs = state_specs(params, axes.rules, axes.sizes)
            if axes.tp > 1:
                _check_split(specs, whole)
            bundle.specs = specs
            params = sharding.train_blocks(params, specs, arch, axes.sizes,
                                           axes.coords)
            items = sharding.leaf_items(specs)
            if dp > 1:
                local_ids = [i for i, (_, sp) in enumerate(items)
                             if sharding.split_dims(sp, "data")]
            split = [_model_split(sp) for _, sp in items]
            seq = axes.rules.get("seq") == "model"
            bundle.partial = [
                i for i, ((path, _), sp) in enumerate(zip(items, split))
                if not sp and _partial_leaf(path, seq)] \
                if axes.model is not None else []
        if zero1:
            bundle.plan = zero.Plan(
                params, period=period_length(arch),
                layer_rows=run.optimizer == "lamb", dp=dp, rank=rank,
                group=axes.data, local=local_ids, split=split,
                rules=axes.rules,
                norm_group=axes.norms if axes.tp > 1 else None,
                model_group=axes.model, mrank=axes.coords["model"],
                pod_group=axes.pod)
        state = {"opt": opt.init(params, bundle.plan)}
        dtype = torch_dtype(arch.dtype) if run.master_weights else None
        state["params"] = tree.map(
            lambda p: p.detach().to(device=device, dtype=dtype or p.dtype,
                                    copy=True).requires_grad_(True), params)
        return state

    # gloo's collectives run on the host: no CUDA graph can hold them
    first = next((g for g in (axes.data, axes.model, axes.pod)
                  if g is not None), None)
    host = first is not None and dist.get_backend(first) == "gloo"
    bundle = StepBundle(fn=StepGraph(step, device, capture=not host),
                        init=init, eager=eager, mesh=axes)
    return bundle
